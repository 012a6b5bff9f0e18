"""The port's codebook-pattern providers (voicecraft_tpu_torch/ops/
pattern_providers.py) against the JAX package's: layouts, build and revert
index matrices and masks, and the build / revert outputs, exactly, for every
provider."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.ops import pattern_providers as jpp
from voicecraft_tpu_torch.ops import pattern_providers as pp

CASES = [
    ("delay", {}), ("delay", {"delays": [0, 2, 4]}),
    ("delay", {"delays": [0, 1, 2], "flatten_first": 2, "empty_initial": 3}),
    ("parallel", {}), ("unroll", {}),
    ("unroll", {"flattening": [0, 1, 1], "delays": [0, 3, 3]}),
    ("valle", {}), ("valle", {"delays": [1, 3]}), ("musiclm", {}),
    ("musiclm", {"group_by": 3}),
]
SPECIAL = 1023


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_provider_matches_jax(name, kw):
    n_q, T = (4, 7) if name == "musiclm" else (3, 7)
    jpat = jpp.PROVIDERS[name](T, n_q, **kw)
    pat = pp.PROVIDERS[name](T, n_q, **kw)
    assert pat.layout == jpat.layout
    assert (pat.max_delay, pat.num_sequence_steps) == (
        jpat.max_delay, jpat.num_sequence_steps)
    z = np.random.default_rng(0).integers(0, 1000, (2, n_q, T))
    for valid in (False, True):
        for a, b in zip(pat.build_indexes(valid), jpat.build_indexes(valid)):
            np.testing.assert_array_equal(a, b)
        seq, idx, mask = pat.build(torch.from_numpy(z), SPECIAL, valid)
        jseq, jidx, jmask = jpat.build(jnp.asarray(z), SPECIAL, valid)
        assert seq.dtype == torch.int64
        np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
        np.testing.assert_array_equal(mask, jmask)
        back, ridx, rmask = pat.revert(seq, SPECIAL, valid)
        jback, jridx, jrmask = jpat.revert(jseq, SPECIAL, valid)
        np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
        np.testing.assert_array_equal(ridx, jridx)
        np.testing.assert_array_equal(rmask, jrmask)
        # revert undoes build wherever the layout kept the token
        np.testing.assert_array_equal(back.numpy()[:, rmask], z[:, rmask])
    for steps, out in ((pat.num_sequence_steps, True), (4, False)):
        for a, b in zip(pat.revert_indexes(steps, is_model_output=out),
                        jpat.revert_indexes(steps, is_model_output=out)):
            np.testing.assert_array_equal(a, b)


def test_build_keeps_the_callers_device_and_dtype():
    pat = pp.delayed_pattern(5, 4)
    z = torch.arange(20, dtype=torch.int32).reshape(4, 5)
    seq, _, mask = pat.build(z, -1)
    assert seq.dtype == torch.int32 and seq.device == z.device
    assert seq.shape == (4, pat.num_sequence_steps + 1)
    assert (seq[~torch.from_numpy(mask)] == -1).all()
