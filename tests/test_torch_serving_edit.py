"""Lockstep multi-span editing in the port (serve_edit_batch, plain and
speculative) against the JAX package, on the CPU: greedy lanes with 1 to 3
spans equal the JAX serving loops and the port's single-stream
inference_edit, kept frames stay verbatim, special_first, per-lane seeds,
sampled output the same for every tau, bench_mode, frozen lanes, and the
refusals.  Both packages run tiny_test with 3 MTP head groups in f32 on the
same weights; each JAX loop is compiled once."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.inference import serving as jsv
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu_torch.data import spans
from voicecraft_tpu_torch.inference import editing
from voicecraft_tpu_torch.inference import serving as sv
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.utils.convert import from_jax_params

TAU = 4
GREEDY = dict(top_k=1, silence_tokens=(5, 7))
SAMPLED = dict(top_k=10, top_p=0.9, temperature=1.0, stop_repetition=3,
               silence_tokens=(5, 7))
# exact verification of sampled drafts warns that it rejects almost all
QUIET = pytest.mark.filterwarnings("ignore:speculative decoding")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one thread each (see test_torch_spec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg, seed):
    params = jvc.init_params(cfg, jax.random.PRNGKey(seed))
    model = vc.VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          cfg))
    return params, model.eval()


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32", n_mtp=3)
    params, model = _pair(cfg, 42)
    rng = np.random.default_rng(3)
    K = cfg.n_codebooks
    # one, two and three spans: three feed schedules in one wave
    specs = [(20, [(5, 9)]), (34, [(4, 8), (16, 22)]),
             (40, [(3, 7), (14, 18), (27, 33)])]
    reqs = [(rng.integers(0, cfg.text_vocab_size, 9 + 3 * b).astype(np.int32),
             rng.integers(0, cfg.audio_vocab_size, (K, T)).astype(np.int32),
             iv) for b, (T, iv) in enumerate(specs)]
    return cfg, params, model, reqs


@pytest.fixture(scope="module")
def plain_greedy(setup):
    _, _, model, reqs = setup
    return sv.serve_edit_batch(model, reqs, vc.SamplingConfig(**GREEDY),
                               seed=0)


def test_edit_serving_greedy_lanes_equal_jax_and_single_stream(setup,
                                                               plain_greedy):
    """f32 on both sides: the tie-aware rule in its strict form."""
    cfg, params, model, reqs = setup
    g = vc.SamplingConfig(**GREEDY)
    want = jsv.serve_edit_batch(params, cfg, reqs, jvc.SamplingConfig(**GREEDY),
                                seed=0)
    for b, ((x, y, iv), got) in enumerate(zip(reqs, plain_greedy)):
        np.testing.assert_array_equal(got, want[b], err_msg=f"lane {b} vs JAX")
        np.testing.assert_array_equal(
            got, editing.inference_edit(model, x, y, iv, g, seed=0),
            err_msg=f"lane {b} vs the port's single stream")


def test_spec_edit_serving_greedy_equals_jax_plain_and_single(setup,
                                                             plain_greedy):
    cfg, params, model, reqs = setup
    g = vc.SamplingConfig(**GREEDY)
    stats = {}
    spec = sv.serve_edit_batch(model, reqs, g, seed=0, spec=TAU, stats=stats)
    assert stats["spec"] == TAU and stats["tok_per_pass"] is not None
    want = jsv.serve_edit_batch(params, cfg, reqs, jvc.SamplingConfig(**GREEDY),
                                seed=0, spec=TAU)
    for b, ((x, y, iv), got) in enumerate(zip(reqs, spec)):
        np.testing.assert_array_equal(got, want[b], err_msg=f"lane {b} vs JAX")
        np.testing.assert_array_equal(got, plain_greedy[b],
                                      err_msg=f"lane {b} vs plain")
        np.testing.assert_array_equal(
            got, editing.inference_edit(model, x, y, iv, g, seed=0, spec=TAU),
            err_msg=f"lane {b} vs the single-stream spec loop")


def _assert_kept_verbatim(reqs, outs):
    for (_, y, iv), res in zip(reqs, outs):
        starts, ends = [s for s, _ in iv], [e for _, e in iv]
        np.testing.assert_array_equal(res[:, :starts[0]], y[:, :starts[0]])
        tail = y.shape[1] - ends[-1]
        np.testing.assert_array_equal(res[:, res.shape[1] - tail:],
                                      y[:, ends[-1]:])


@QUIET
@pytest.mark.parametrize("spec", [0, TAU])
def test_edit_serving_sampled_keeps_unedited_frames(setup, spec):
    _, _, model, reqs = setup
    stats = {}
    outs = sv.serve_edit_batch(model, reqs, vc.SamplingConfig(**SAMPLED),
                               seed=11, spec=spec, stats=stats)
    assert stats["frames"] > 0 and stats["seconds"] > 0
    _assert_kept_verbatim(reqs, outs)


@QUIET
def test_spec_edit_serving_sampled_output_invariant_to_tau(setup):
    _, _, model, reqs = setup
    s = vc.SamplingConfig(**SAMPLED)
    o2 = sv.serve_edit_batch(model, reqs, s, seed=11, spec=2)
    o4 = sv.serve_edit_batch(model, reqs, s, seed=11, spec=4)
    for a, b in zip(o2, o4):
        np.testing.assert_array_equal(a, b)


def test_stochastic_spec_edit_serving_is_deterministic(setup):
    _, _, model, reqs = setup
    s = vc.SamplingConfig(**SAMPLED, spec_sampling="stochastic")
    a = sv.serve_edit_batch(model, reqs, s, seed=3, spec=TAU)
    b = sv.serve_edit_batch(model, reqs, s, seed=3, spec=TAU)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    _assert_kept_verbatim(reqs, a)


@QUIET
@pytest.mark.parametrize("spec", [0, TAU])
def test_edit_serving_per_lane_seeds(setup, spec):
    """A lane's draw depends on its own seed and lane only, not on the
    requests beside it."""
    _, _, model, reqs = setup
    s = vc.SamplingConfig(**SAMPLED)
    a = sv.serve_edit_batch(model, [reqs[0], reqs[1]], s, seeds=[3, 9],
                            spec=spec)
    b = sv.serve_edit_batch(model, [reqs[0], reqs[2]], s, seeds=[3, 4],
                            spec=spec)
    np.testing.assert_array_equal(a[0], b[0])


def test_edit_serving_special_first_equals_single_stream(setup):
    cfg = dataclasses.replace(setup[0], special_first=1)
    params, model = _pair(cfg, 7)
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, cfg.text_vocab_size, 8 + 3 * b).astype(np.int32),
             rng.integers(0, cfg.audio_vocab_size - cfg.n_special,
                          (cfg.n_codebooks, 20 + 6 * b)).astype(np.int32),
             [(6, 11)]) for b in range(2)]
    g = vc.SamplingConfig(**GREEDY)
    outs = sv.serve_edit_batch(model, reqs, g, seed=0)
    want = jsv.serve_edit_batch(params, cfg, reqs, jvc.SamplingConfig(**GREEDY),
                                seed=0)
    for (x, y, iv), res, w in zip(reqs, outs, want):
        np.testing.assert_array_equal(res, w)
        np.testing.assert_array_equal(
            res, editing.inference_edit(model, x, y, iv, g, seed=0))
        np.testing.assert_array_equal(res[:, :6], y[:, :6])


def _wave(cfg, reqs, x_pad=32, y_pad=64):
    K, B, M = cfg.n_codebooks, len(reqs), cfg.max_n_spans
    xt = np.full((B, x_pad), cfg.text_pad_token, np.int64)
    yt = np.full((B, K, y_pad), cfg.empty_token, np.int64)
    mi = np.full((B, y_pad), -1, np.int64)
    qm = np.zeros((B, M), np.int64)
    p_lens = []
    for b, (x, y, iv) in enumerate(reqs):
        c, qids = spans.compose_edit_prefix(y, iv, cfg)
        xt[b, :len(x)] = x
        yt[b, :, :c.length] = c.tokens
        mi[b, :c.length] = c.mask_emb_idx
        qm[b, :len(qids)] = qids
        p_lens.append(c.length)
    t = torch.from_numpy
    return (t(xt), [len(x) for x, _, _ in reqs], t(yt), p_lens, t(mi), t(qm),
            [len(iv) for _, _, iv in reqs])


@pytest.mark.parametrize("spec", [0, TAU])
def test_edit_serving_bench_mode_records_gen_max_rows(setup, spec):
    """bench_mode never completes a span: every lane records exactly gen_max
    rows (no feed is ever queued), special codes mapped to 0."""
    cfg, _, model, reqs = setup
    gen_max = 24
    kw = dict(batch_size=len(reqs), x_pad=32, y_pad=64, gen_max=gen_max,
              scfg=vc.SamplingConfig(**GREEDY), bench_mode=True)
    loop = (sv.make_spec_serving_edit_loop(cfg, n_draft=spec, **kw) if spec
            else sv.make_serving_edit_loop(cfg, **kw))
    res = loop(model, *_wave(cfg, reqs), [0, 1, 2])
    assert res.n_rows == [gen_max] * len(reqs)
    rows = res.gen_buf[:gen_max]
    assert (rows < cfg.audio_vocab_size).all()
    assert (res.span_buf[:gen_max] == 0).all()


def test_frozen_edit_lane_is_untouched_by_the_rest_of_the_wave(setup,
                                                              plain_greedy):
    """The one-span lane finishes long before the three-span one; its
    output equals its output alone."""
    _, _, model, reqs = setup
    alone = sv.serve_edit_batch(model, [reqs[0]], vc.SamplingConfig(**GREEDY),
                                seed=0)
    np.testing.assert_array_equal(plain_greedy[0], alone[0])


def test_edit_serving_refusals(setup):
    cfg, _, model, reqs = setup
    g = vc.SamplingConfig(**GREEDY)
    with pytest.raises(ValueError, match="do not shard over data"):
        sv.serve_edit_batch(model, reqs, g, mesh=types.SimpleNamespace(
            n_data=len(reqs) + 1, data_rank=0))
    bare = vc.VoiceCraft(dataclasses.replace(cfg, n_mtp=0), "cpu")
    with pytest.raises(ValueError, match="mtp_heads"):
        sv.serve_edit_batch(bare, reqs, g, spec=TAU)
    with pytest.raises(ValueError, match="n_draft >= 2"):
        sv.make_spec_serving_edit_loop(cfg, batch_size=3, n_draft=1, x_pad=32,
                                       y_pad=64, gen_max=64, scfg=g)
    with pytest.raises(ValueError, match="at least one mask span"):
        sv.serve_edit_batch(model, [(reqs[0][0], reqs[0][1], [])], g)
