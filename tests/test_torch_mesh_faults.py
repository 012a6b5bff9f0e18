"""The two faults of the port's mesh against the JAX package, over 2 gloo
processes at 2 x 1 (tests/torch_mesh_helpers.py, spawned once), on the CPU
at tiny_test in f32.

* ZeRO-1 is a layout only: 3 ScaledAdam steps with the moments sharded
  over 'data' and replicated give bit-equal losses, parameters and
  gathered moments, as the JAX package's do (tests/test_zero1.py).
* A closed stream stops every rank: rank 0's consumer closes stream_tts
  after its first chunk; both ranks' engines stop at the same burst, within
  one burst of the close, and both report the cancellation (the 2 x 2 case,
  whose model ranks see no data gather, is in test_torch_mesh_serving.py).
"""

import dataclasses

import jax
import numpy as np
import pytest

from __graft_entry__ import _synthetic_batch
from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.models.voicecraft import init_params
from torch_mesh_helpers import faults_worker, numpy_state, spawn, tiny
from torch_train_helpers import configs, jax_state

BURST = 8


@pytest.fixture(scope="module")
def ranks():
    jcfg, tcfg = configs()
    state = numpy_state(jax_state(init_params(jcfg, jax.random.PRNGKey(0)),
                                  tcfg))
    batch = _synthetic_batch(jcfg, B=4, Sx=16, y_len=40, seed=5)
    rng = np.random.default_rng(6)
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32")
    x = rng.integers(0, cfg.text_vocab_size, 40).astype(np.int32)
    y = rng.integers(0, cfg.audio_vocab_size,
                     (cfg.n_codebooks, 12)).astype(np.int32)
    return spawn(2, faults_worker, state, tuple(np.asarray(a) for a in batch),
                 x, y, BURST)


@pytest.mark.parametrize("what", ["losses", "params", "moments"])
def test_zero1_is_bit_equal_to_replicated(ranks, what):
    a, b = ranks[0]["zero1"], ranks[0]["replicated"]
    assert a["sharded"] > 0 and b["sharded"] == 0
    got, want = a[what], b[what]
    if what == "params":
        assert got.keys() == want.keys()
        got, want = [got[k] for k in want], list(want.values())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_both_ranks_train_alike(ranks):
    for name in ("zero1", "replicated"):
        a, b = ranks[0][name], ranks[1][name]
        assert a["losses"] == b["losses"]
        for k, v in a["params"].items():
            np.testing.assert_array_equal(v, b["params"][k], err_msg=k)


def test_closed_stream_stops_every_rank_within_a_burst(ranks):
    """Rank 0 closed after its first chunk; rank 1 drained its generator,
    which ended at the same burst without a last chunk.  Both handed over
    the same frames: at most one burst more than the first chunk, and
    fewer than the stream run to its end."""
    c0, c1 = ranks[0]["closed"], ranks[1]["closed"]
    for c in (c0, c1):
        assert c["stats"]["cancelled"] and c["stats"]["t_decode"] > 0
        assert not c["last"]
    assert c0["stats"]["frames"] == c1["stats"]["frames"] == c1["frames"]
    assert c0["first"] == c1["first"] > 0
    assert c0["stats"]["frames"] <= c0["first"] + BURST
    assert c0["stats"]["frames"] < ranks[0]["full"] == ranks[1]["full"]


def test_train_step_needs_an_optimizer_over_the_mesh():
    """The optimizer sums the gradients over 'data' in both layouts: a
    model on a mesh with data > 1 and an optimizer that is not sharded
    over it are refused, not left unsummed."""
    import types

    from torch_mesh_helpers import model_from
    from voicecraft_tpu_torch.training.optim import ScaledAdam, stacked_leaves
    from voicecraft_tpu_torch.training.step import make_train_step
    jcfg, tcfg = configs()
    model = model_from(numpy_state(jax_state(
        init_params(jcfg, jax.random.PRNGKey(0)), tcfg)), tiny())
    model.mesh = types.SimpleNamespace(n_data=2, n_model=1)
    with pytest.raises(ValueError, match="shard the optimizer"):
        make_train_step(model, ScaledAdam(stacked_leaves(model), lr=0.05))
