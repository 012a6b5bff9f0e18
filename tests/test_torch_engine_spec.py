"""Speculative continuous batching in the port (engine.make_spec_burst_fn)
against the plain engine, the single stream and the JAX package's
speculative engine, on the CPU, tiny_test with 3 MTP head groups in f32:
greedy requests token-equal through refill, sampled output invariant to tau
and the lane count, the gen_max cap, and the refusals."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.inference import engine as jeng
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu_torch.inference.engine import ContinuousBatcher
from voicecraft_tpu_torch.inference.tts import inference_tts
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.utils.convert import from_jax_params

GEOM = dict(x_pad=32, y_pad=64, gen_max=128, burst=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one thread each (see test_torch_spec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32", n_mtp=3)
    params = jvc.init_params(cfg, jax.random.PRNGKey(42))
    model = vc.VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          cfg))
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.text_vocab_size, 8 + b).astype(np.int32),
             rng.integers(0, cfg.audio_vocab_size,
                          (cfg.n_codebooks, 14 + 4 * b)).astype(np.int32))
            for b in range(4)]
    return cfg, params, model.eval(), reqs


def _run(model, reqs, scfg, **kw):
    eng = ContinuousBatcher(model, scfg=scfg, seed=3, **{**GEOM, **kw})
    ids = [eng.submit(x, y) for x, y in reqs]
    res = eng.run()
    return [res[i] for i in ids]


def test_spec_engine_greedy_matches_plain_single_and_jax(setup):
    """4 requests over 2 lanes (refills), tau 4: each request equals the
    plain engine's, the single stream's and the JAX speculative engine's
    (f32: the tie-aware rule in its strict form)."""
    cfg, params, model, reqs = setup
    g = vc.SamplingConfig(temperature=0.0, silence_tokens=())
    spec = _run(model, reqs, g, lanes=2, spec=4)
    plain = _run(model, reqs, g, lanes=2)
    j = jeng.ContinuousBatcher(params, cfg, lanes=2, scfg=jvc.SamplingConfig(
        temperature=0.0, silence_tokens=()), seed=3, spec=4, **GEOM)
    jids = [j.submit(x, y) for x, y in reqs]
    jres = j.run()
    for (fs, gs), (fp, gp), (x, y), jid in zip(spec, plain, reqs, jids):
        np.testing.assert_array_equal(gs, gp)
        np.testing.assert_array_equal(fs, fp)
        np.testing.assert_array_equal(gs, inference_tts(model, x, y, g,
                                                        seed=0)[1])
        np.testing.assert_array_equal(gs, jres[jid][1])


def test_spec_engine_sampled_invariant_to_tau_and_lanes(setup):
    """Sampled draws are keyed on (seed, admission, token index): the same
    rows for any tau and any lane count."""
    _, _, model, reqs = setup
    s = vc.SamplingConfig(top_k=10, top_p=0.9, temperature=1.0,
                          stop_repetition=3, silence_tokens=(5, 7))
    outs = [_run(model, reqs, s, lanes=lanes, spec=spec)
            for spec, lanes in ((2, 2), (4, 2), (4, 3))]
    for other in outs[1:]:
        for (fa, ga), (fb, gb) in zip(outs[0], other):
            np.testing.assert_array_equal(ga, gb)
            np.testing.assert_array_equal(fa, fb)


def test_spec_engine_gen_max_cap_matches_plain(setup):
    """A lane stopped by the gen_max cap (its length cap lies far past it)
    retires with the plain engine's rows."""
    cfg, _, model, _ = setup
    g = vc.SamplingConfig(temperature=0.0, silence_tokens=())
    rng = np.random.default_rng(9)
    x = rng.integers(0, cfg.text_vocab_size, 24).astype(np.int32)
    y = rng.integers(0, cfg.audio_vocab_size,
                     (cfg.n_codebooks, 16)).astype(np.int32)
    geom = dict(lanes=1, gen_max=32, burst=8)
    (plain,) = _run(model, [(x, y)], g, **geom)
    (spec,) = _run(model, [(x, y)], g, spec=4, **geom)
    # gen_max - 1 rows, less the K - 1 rows of the delay
    assert plain[1].shape == (cfg.n_codebooks, 32 - 1 - cfg.n_codebooks)
    np.testing.assert_array_equal(spec[1], plain[1])
    np.testing.assert_array_equal(spec[0], plain[0])


def test_spec_engine_force_accept(setup):
    """force_accept (measurement) retires tau rows a pass: 32 rows (the
    gen_max - 1 cap) in 8 passes, 2 a burst of 8 tokens."""
    cfg, _, model, reqs = setup
    g = vc.SamplingConfig(temperature=0.0, silence_tokens=())
    eng = ContinuousBatcher(model, scfg=g, seed=3, lanes=1, spec=4,
                            spec_force_accept=True,
                            **{**GEOM, "gen_max": 33, "burst": 8})
    eng.submit(*reqs[0])
    ((_, gen),) = eng.run().values()
    assert gen.shape == (cfg.n_codebooks, 32 - cfg.n_codebooks)
    assert eng.stats["bursts"] == 4 and eng.stats["steps"] == 8


def test_spec_engine_refuses_missing_or_too_few_heads(setup):
    cfg, _, model, _ = setup
    bare = vc.VoiceCraft(dataclasses.replace(cfg, n_mtp=0), "cpu")
    with pytest.raises(ValueError, match="mtp_heads"):
        ContinuousBatcher(bare, lanes=2, spec=4)
    with pytest.raises(ValueError, match="n_mtp"):
        ContinuousBatcher(model, lanes=2, spec=5)
