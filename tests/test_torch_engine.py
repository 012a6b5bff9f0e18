"""Continuous batching in the port (inference/engine.py) against the JAX
package's engine and the port's own single-stream decode, on the CPU: the
ring attention, greedy requests through mid-flight refill, special_first,
the fp8 slab, wave against per-lane admission, and sampled output keyed on
the admission.  Both packages run tiny_test in f32 on the same weights."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.inference import engine as jeng
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu_torch.data.spans import compose_tts_prefix
from voicecraft_tpu_torch.inference import engine as eng_mod
from voicecraft_tpu_torch.inference.tts import inference_tts
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops import attention as attn
from voicecraft_tpu_torch.utils.convert import from_jax_params

F8 = "float8_e4m3fn"
GREEDY = dict(top_k=1, silence_tokens=(5, 7))
SAMPLED = dict(top_k=10, top_p=0.9, silence_tokens=(5, 7))
ENGINE = dict(x_pad=32, y_pad=64, gen_max=256, burst=16)


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


def _requests(cfg, n=5, seed=6, shift=0):
    """The JAX engine test's requests: text 6 + 2i, prompt 12 + 5i frames."""
    rng = np.random.default_rng(seed)
    K = cfg.n_codebooks
    reqs = []
    for i in range(n):
        x = rng.integers(0, cfg.text_vocab_size, 6 + 2 * i).astype(np.int32)
        y = rng.integers(0, cfg.audio_vocab_size - shift,
                         (K, 12 + 5 * i)).astype(np.int32)
        reqs.append((x, y))
    return reqs


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32")
    params, model = _pair(cfg, 7)
    return cfg, params, model, _requests(cfg)


def _run(model, reqs, scfg, **kw):
    eng = eng_mod.ContinuousBatcher(model, scfg=scfg, seed=0,
                                    **{**ENGINE, **kw})
    ids = [eng.submit(x, y) for x, y in reqs]
    res = eng.run()
    assert set(res) == set(ids)
    return [res[i] for i in ids], eng


# ---- the ring attention -------------------------------------------------------

@pytest.mark.parametrize("gstep", [0, 5, 17, 29, 52])
def test_decode_attention_ring_matches_jax(gstep):
    """Ring width 12: gstep 17 and 29 are past one and two wraps, 52 past
    four; lanes at t = 0 (nothing generated valid), mid-ring and at W."""
    B, H, Dh, x_pad, y_start, W = 4, 4, 16, 8, 20, 12
    S_max = y_start + W
    xl, pl = np.asarray([3, 8, 5, 1]), np.asarray([12, 4, 9, 1])
    t_lane = np.asarray([0, 4, min(gstep, W), 1])
    rng = np.random.default_rng(gstep)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kc, vc_, kn, vn = (r(B, 1, H * Dh), r(B, S_max, H, Dh),
                          r(B, S_max, H, Dh), r(B, 1, H, Dh), r(B, 1, H, Dh))
    got = attn.decode_attention_ring(
        *map(torch.from_numpy, (q, kc, vc_, kn, vn)), H, torch.from_numpy(xl),
        x_pad, torch.from_numpy(pl), y_start, W, torch.tensor(gstep),
        torch.from_numpy(t_lane))
    want = jeng._ring_attention(
        *map(jnp.asarray, (q, kc, vc_, kn, vn)), H, jnp.asarray(xl), x_pad,
        jnp.asarray(pl), y_start, W, jnp.asarray(gstep), jnp.asarray(t_lane))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ---- greedy requests through refill -------------------------------------------

def test_engine_matches_single_with_refill(setup):
    """5 requests into 2 lanes, burst 16 (at least 3 refills): each request
    equals the port's own inference_tts exactly, and the JAX engine's
    output (both f32, so the tie-aware rule holds in its strict form)."""
    cfg, params, model, reqs = setup
    scfg = vc.SamplingConfig(**GREEDY)
    outs, eng = _run(model, reqs, scfg, lanes=2)
    assert eng.stats["waves"] == 1 and eng.stats["refills"] >= 3
    jeng_ = jeng.ContinuousBatcher(params, cfg, lanes=2, scfg=jvc.SamplingConfig(
        **GREEDY), seed=0, **ENGINE)
    jids = [jeng_.submit(x, y) for x, y in reqs]
    jres = jeng_.run()
    for (full, gen), (x, y), jid in zip(outs, reqs, jids):
        f1, g1 = inference_tts(model, x, y, scfg, seed=0)
        assert gen.shape == g1.shape
        np.testing.assert_array_equal(gen, g1)
        np.testing.assert_array_equal(full, f1)
        np.testing.assert_array_equal(full[:, :y.shape[1]], y)
        np.testing.assert_array_equal(gen, jres[jid][1])
        np.testing.assert_array_equal(full, jres[jid][0])


def test_engine_special_first():
    """special_first: gen is unshifted before the raw prompt is prepended."""
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32",
                              special_first=1)
    _, model = _pair(cfg, 7)
    rng = np.random.default_rng(13)
    K = cfg.n_codebooks
    scfg = vc.SamplingConfig(**GREEDY)
    x = rng.integers(0, cfg.text_vocab_size, 8).astype(np.int32)
    y = rng.integers(0, cfg.audio_vocab_size - cfg.n_special,
                     (K, 14)).astype(np.int32)
    ((full, gen),), _ = _run(model, [(x, y)], scfg, lanes=2)
    f1, g1 = inference_tts(model, x, y, scfg, seed=0)
    np.testing.assert_array_equal(gen, g1)
    np.testing.assert_array_equal(full, f1)
    np.testing.assert_array_equal(full[:, :y.shape[1]], y)


def test_engine_fp8_kv_cache(setup):
    """The fp8 slab: deterministic over two runs, well-formed, and the
    logits after one burst within 0.25 (relative to the largest) of the f32
    slab's, but not equal (the slab really is fp8)."""
    cfg, _, model, reqs = setup
    scfg = vc.SamplingConfig(**GREEDY)
    K = cfg.n_codebooks
    a, _ = _run(model, reqs[:3], scfg, lanes=2, kv_dtype=F8)
    b, _ = _run(model, reqs[:3], scfg, lanes=2, kv_dtype=F8)
    for (fa, ga), (_, gb), (_, y) in zip(a, b, reqs):
        np.testing.assert_array_equal(ga, gb)
        np.testing.assert_array_equal(fa[:, :y.shape[1]], y)
        assert ga.shape[0] == K and 0 <= ga.shape[1] < ENGINE["gen_max"]
        assert (ga >= 0).all() and (ga < cfg.card).all()
    logits = {}
    for kv in (None, F8):
        eng = eng_mod.ContinuousBatcher(model, lanes=1, scfg=scfg, seed=0,
                                        kv_dtype=kv, **{**ENGINE, "burst": 8})
        eng.submit(*reqs[0])
        eng._admit()
        eng._dispatch_burst()
        logits[kv] = eng._lanes.logits[0].numpy()
    rel = (np.abs(logits[F8] - logits[None]).max()
           / max(np.abs(logits[None]).max(), 1e-6))
    assert 0 < rel < 0.25, rel


def test_wave_admission_equals_lane_refill(setup):
    """The wave prefill of lanes 0 and 2 leaves the same lane state and
    slab rows as two single-lane refills, and lane 1 untouched."""
    cfg, _, model, reqs = setup
    K, L, H, Dh = (cfg.n_codebooks, cfg.num_decoder_layers, cfg.nhead,
                   cfg.head_dim)
    x_pad, y_pad = ENGINE["x_pad"], ENGINE["y_pad"]
    s_max = x_pad + y_pad + 40
    rows = []
    for rid, (x, y) in zip((3, 8), reqs[1:3]):
        prefix = compose_tts_prefix(y, cfg)
        xt = np.full((1, x_pad), cfg.text_pad_token, np.int64)
        xt[0, :len(x)] = x
        yt = np.full((1, K, y_pad), cfg.empty_token, np.int64)
        yt[0, :, :prefix.length] = prefix.tokens
        rows.append((rid, xt, len(x), yt, prefix.length))
    states = []
    for wave in (True, False):
        cache = torch.zeros((L, 2, 3, s_max, H, Dh))
        s = eng_mod._empty_lanes(3, K, cfg.card, cfg.d_model, "cpu")
        if wave:
            fn = eng_mod.make_prefill_batch_fn(cfg, x_pad=x_pad, y_pad=y_pad)
            cache, s = fn(model, cache, s, [0, 2],
                          np.concatenate([r[1] for r in rows]),
                          [r[2] for r in rows],
                          np.concatenate([r[3] for r in rows]),
                          [r[4] for r in rows], [r[0] for r in rows])
        else:
            fn = eng_mod.make_prefill_lane_fn(cfg, x_pad=x_pad, y_pad=y_pad)
            for lane, (rid, xt, xl, yt, pl) in zip((0, 2), rows):
                cache, s = fn(model, cache, s, lane, xt, xl, yt, pl, rid)
        states.append((cache, s))
    (cw, sw), (cl, sl) = states
    for f in dataclasses.fields(sw):
        a, b = getattr(sw, f.name), getattr(sl, f.name)
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), f.name)
    np.testing.assert_allclose(cw.numpy(), cl.numpy(), rtol=0, atol=1e-5)
    assert sw.active.tolist() == [True, False, True]
    assert sw.admit_id.tolist() == [3, 0, 8]
    assert not cw[:, :, 1].any() and not cw[:, :, :, x_pad + y_pad:].any()


def test_sampled_output_independent_of_lane_and_wave(setup):
    """Sampled noise is keyed on the admission: each request draws the same
    rows whether the requests share one wave (3 lanes), ride 2 lanes with
    refills, or one lane in turn."""
    _, _, model, reqs = setup
    scfg = vc.SamplingConfig(**SAMPLED)
    outs = [_run(model, reqs[:3], scfg, lanes=n)[0] for n in (3, 2, 1)]
    for other in outs[1:]:
        for (fa, ga), (fb, gb) in zip(outs[0], other):
            np.testing.assert_array_equal(ga, gb)
            np.testing.assert_array_equal(fa, fb)
    # and the draws are real samples: another seed, other rows
    eng = eng_mod.ContinuousBatcher(model, lanes=3, scfg=scfg, seed=1,
                                    **ENGINE)
    ids = [eng.submit(x, y) for x, y in reqs[:3]]
    res = eng.run()
    assert any(res[i][1].shape != g.shape or not np.array_equal(res[i][1], g)
               for i, (_, g) in zip(ids, outs[0]))


def test_engine_refuses_mesh(setup):
    """A mesh whose data axis does not divide the lanes is refused (the
    mesh runs: tests/test_torch_mesh_serving.py)."""
    _, _, model, _ = setup
    mesh = types.SimpleNamespace(n_data=3, data_rank=0)
    with pytest.raises(ValueError, match="shard over data=3"):
        eng_mod.ContinuousBatcher(model, lanes=2, mesh=mesh)
