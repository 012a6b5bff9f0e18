"""Speculative lockstep TTS serving in the port (make_spec_serving_loop)
against the JAX package, on the CPU: greedy lanes equal the JAX spec
serving loop and the port's plain serving loop, sampled output is the same
for every tau, per-request seeds, force_accept and bench_mode at the
budget's edge, frozen lanes, and the refusals.  Both packages run
tiny_test with 3 MTP head groups in f32 on the same weights; the JAX loop
is compiled once (tau 4)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.inference import serving as jsv
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu_torch.inference import serving as sv
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.utils.convert import from_jax_params

TAU = 4
GREEDY = dict(temperature=0.0, silence_tokens=())
SAMPLED = dict(top_k=10, top_p=0.9, temperature=1.0, stop_repetition=3,
               silence_tokens=(5, 7))


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
    reqs = [(rng.integers(0, cfg.text_vocab_size, 8 + 4 * b).astype(np.int32),
             rng.integers(0, cfg.audio_vocab_size,
                          (cfg.n_codebooks, 16 + 8 * b)).astype(np.int32))
            for b in range(3)]
    return cfg, params, model.eval(), reqs


# exact verification of sampled drafts warns that it rejects almost all
QUIET = pytest.mark.filterwarnings("ignore:speculative decoding")


def test_spec_serving_greedy_equals_jax_and_plain_serving(setup):
    """f32 on both sides: the tie-aware rule in its strict form."""
    cfg, params, model, reqs = setup
    g = vc.SamplingConfig(**GREEDY)
    stats = {}
    spec = sv.serve_tts_batch(model, reqs, g, seed=5, spec=TAU, stats=stats)
    assert stats["spec"] == TAU and stats["tok_per_pass"] > 0
    plain = sv.serve_tts_batch(model, reqs, g, seed=5)
    want = jsv.serve_tts_batch(params, cfg, reqs, jvc.SamplingConfig(**GREEDY),
                               seed=5, spec=TAU)
    for b, ((_, y), (fs, gs), (fp, gp), (_, gj)) in enumerate(
            zip(reqs, spec, plain, want)):
        np.testing.assert_array_equal(gs, gj, err_msg=f"lane {b} vs JAX")
        np.testing.assert_array_equal(gs, gp, err_msg=f"lane {b} vs plain")
        np.testing.assert_array_equal(fs, fp)
        np.testing.assert_array_equal(fs[:, :y.shape[1]], y)


@QUIET
def test_spec_serving_sampled_output_invariant_to_tau(setup):
    _, _, model, reqs = setup
    s = vc.SamplingConfig(**SAMPLED)
    o2 = sv.serve_tts_batch(model, reqs, s, seed=11, spec=2)
    o4 = sv.serve_tts_batch(model, reqs, s, seed=11, spec=4)
    assert any(g.shape[1] > 0 for _, g in o2)
    for (f2, g2), (f4, g4) in zip(o2, o4):
        np.testing.assert_array_equal(g2, g4)
        np.testing.assert_array_equal(f2, f4)


@QUIET
def test_spec_serving_per_request_seeds(setup):
    _, _, model, reqs = setup
    x, y = reqs[0]
    s = vc.SamplingConfig(**SAMPLED)
    a = sv.serve_tts_batch(model, [(x, y), (x, y)], s, seeds=[3, 5], spec=3)
    b = sv.serve_tts_batch(model, [(x, y), (x, y)], s, seeds=[3, 9], spec=3)
    np.testing.assert_array_equal(a[0][1], b[0][1])
    assert a[1][1].shape != b[1][1].shape or not np.array_equal(a[1][1], b[1][1])
    same = sv.serve_tts_batch(model, [(x, y), (x, y)], s, seed=9, spec=3)
    assert (same[0][1].shape != same[1][1].shape
            or not np.array_equal(same[0][1], same[1][1]))


def test_stochastic_spec_serving_is_deterministic(setup):
    cfg, _, model, reqs = setup
    s = vc.SamplingConfig(**SAMPLED, spec_sampling="stochastic")
    a = sv.serve_tts_batch(model, reqs, s, seed=3, spec=TAU)
    b = sv.serve_tts_batch(model, reqs, s, seed=3, spec=TAU)
    for (fa, ga), (fb, gb), (_, y) in zip(a, b, reqs):
        np.testing.assert_array_equal(ga, gb)
        np.testing.assert_array_equal(fa[:, :y.shape[1]], y)
        assert ga.size == 0 or ga.max() < cfg.audio_vocab_size + cfg.n_special


def _wave(cfg, reqs, x_pad=32, y_pad=64):
    K, B = cfg.n_codebooks, len(reqs)
    xt = np.full((B, x_pad), cfg.text_pad_token, np.int64)
    yt = np.full((B, K, y_pad), cfg.empty_token, np.int64)
    for b, (x, y) in enumerate(reqs):
        xt[b, :len(x)] = x
        yt[b, :, :y.shape[1]] = y
    return (torch.from_numpy(xt), [len(x) for x, _ in reqs],
            torch.from_numpy(yt), [y.shape[1] for _, y in reqs])


@pytest.mark.parametrize("force_accept", [False, True])
def test_spec_serving_bench_mode_runs_every_lane_to_the_slab_edge(
        setup, force_accept):
    """bench_mode never stops a lane: each records exactly gen_max rows,
    so the last pass writes the slab's last slots (in range: a torch index
    out of range raises).  With force_accept every pass retires tau rows per
    lane until the budget (its rows are the drafts, forced empties
    included, as in the JAX loop)."""
    cfg, _, model, reqs = setup
    gen_max = 30
    loop = sv.make_spec_serving_loop(cfg, batch_size=len(reqs), n_draft=TAU,
                                     x_pad=32, y_pad=64, gen_max=gen_max,
                                     scfg=vc.SamplingConfig(**GREEDY),
                                     bench_mode=True,
                                     force_accept=force_accept)
    res = loop(model, *_wave(cfg, reqs), [1, 2, 3])
    assert res.n_rows == [gen_max] * len(reqs)
    if force_accept:
        assert res.steps == -(-gen_max // TAU)
    else:
        # special codes are mapped to 0
        rows = res.gen_buf[:gen_max]
        assert (rows >= 0).all() and (rows < cfg.audio_vocab_size).all()


def test_frozen_spec_lane_is_untouched_by_the_rest_of_the_wave(setup):
    cfg, _, model, reqs = setup
    g = vc.SamplingConfig(**GREEDY)
    out = sv.serve_tts_batch(model, reqs, g, seed=0, spec=TAU,
                             pads=(32, 64, 256))
    lens = [gen.shape[1] for _, gen in out]
    first = int(np.argmin(lens))
    assert lens[first] < max(lens)
    alone = sv.serve_tts_batch(model, [reqs[first]], g, seed=0, spec=TAU,
                               pads=(32, 64, 256))
    np.testing.assert_array_equal(out[first][0], alone[0][0])


def test_spec_serving_refuses_a_model_without_mtp_heads(setup):
    cfg, _, _, reqs = setup
    bare = vc.VoiceCraft(dataclasses.replace(cfg, n_mtp=0), "cpu")
    with pytest.raises(ValueError, match="mtp_heads"):
        sv.serve_tts_batch(bare, reqs, vc.SamplingConfig(**GREEDY), spec=TAU)
    with pytest.raises(ValueError, match="mtp_heads"):
        sv.make_spec_serving_loop(
            cfg, batch_size=3, n_draft=TAU, x_pad=32, y_pad=64, gen_max=128,
            scfg=vc.SamplingConfig(**GREEDY))(bare, *_wave(cfg, reqs),
                                              [0, 0, 0])
