"""Lockstep TTS serving in the port against the JAX package, on the CPU: the
multi-lane decode attention and steps, the fp8 KV slab, the vectorised
sampler, and serve_tts_batch (greedy lanes, special_first, the fp8 slab,
per-request seeds, frozen lanes).  Both packages run tiny_test in f32 on
the same weights; each JAX serving loop is compiled once per module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.inference import serving as jsv
from voicecraft_tpu.models import transformer as jtrm
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu.ops import attention as jattn
from voicecraft_tpu_torch.inference import serving as sv
from voicecraft_tpu_torch.inference import spec_common as sc
from voicecraft_tpu_torch.inference import tts
from voicecraft_tpu_torch.models import transformer as trm
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops import attention as attn
from voicecraft_tpu_torch.ops.sampling import top_k_top_p_filter
from voicecraft_tpu_torch.utils.convert import from_jax_params

F8 = "float8_e4m3fn"
TIE_MARGIN = 1e-3
GREEDY = dict(top_k=1, silence_tokens=(5, 7))
SAMPLED = dict(top_k=20, temperature=1.0, silence_tokens=(5, 7))


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


def _requests(cfg, seed, n=3, shift=0):
    rng = np.random.default_rng(seed)
    K = cfg.n_codebooks
    return [(rng.integers(0, cfg.text_vocab_size, 8 + 3 * b).astype(np.int32),
             rng.integers(0, cfg.audio_vocab_size - shift,
                          (K, 15 + 7 * b)).astype(np.int32))
            for b in range(n)]


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32")
    params, model = _pair(cfg, 7)
    return cfg, params, model, _requests(cfg, 4)


@pytest.fixture(scope="module")
def jax_greedy(setup):
    cfg, params, _, reqs = setup
    return jsv.serve_tts_batch(params, cfg, reqs, jvc.SamplingConfig(**GREEDY),
                               seed=0)


def assert_codes_equal(got, want, what):
    """Greedy codes [K, T] of the port against JAX's.  Both run f32 here, so
    the tie-aware rule (equal up to the first top-2 margin under 1e-3)
    holds in its strict form: equal throughout."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---- multi-lane attention and steps ---------------------------------------------

def _lane_geometry():
    # x_pad 8, y_start 20; the lanes' text, prompt and generated lengths
    return dict(x_pad=8, y_start=20, x_lens=[3, 8, 5], prefix_lens=[12, 4, 9])


@pytest.mark.parametrize("B", [1, 3])
def test_decode_attention_multi_matches_jax(B):
    S_max, H, Dh, kv_len = 32, 4, 16, 27
    g = _lane_geometry()
    rng = np.random.default_rng(B)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kc, vc_, kn, vn = (r(B, 1, H * Dh), r(B, S_max, H, Dh),
                          r(B, S_max, H, Dh), r(B, 1, H, Dh), r(B, 1, H, Dh))
    xl, pl = (np.asarray(g[k][:B]) for k in ("x_lens", "prefix_lens"))
    got = attn.decode_attention_multi(
        *map(torch.from_numpy, (q, kc, vc_)), torch.tensor(kv_len),
        *map(torch.from_numpy, (kn, vn)), H, torch.from_numpy(xl), g["x_pad"],
        torch.from_numpy(pl), g["y_start"])
    want = jattn.decode_attention_multi(
        *map(jnp.asarray, (q, kc, vc_)), jnp.asarray(kv_len),
        *map(jnp.asarray, (kn, vn)), H, jnp.asarray(xl), g["x_pad"],
        jnp.asarray(pl), g["y_start"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("B", [1, 3])
def test_decode_attention_multi_block_matches_jax(B):
    S_max, H, Dh, T = 36, 4, 16, 4
    g = _lane_geometry()
    rng = np.random.default_rng(10 + B)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kc, vc_, kn, vn = (r(B, T, H * Dh), r(B, S_max, H, Dh),
                          r(B, S_max, H, Dh), r(B, T, H, Dh), r(B, T, H, Dh))
    xl, pl = (np.asarray(g[k][:B]) for k in ("x_lens", "prefix_lens"))
    gen = np.asarray([0, 7, 3][:B])
    got = attn.decode_attention_multi_block(
        *map(torch.from_numpy, (q, kc, vc_)), torch.from_numpy(gen),
        *map(torch.from_numpy, (kn, vn)), H, torch.from_numpy(xl), g["x_pad"],
        torch.from_numpy(pl), g["y_start"])
    want = jattn.decode_attention_multi_block(
        *map(jnp.asarray, (q, kc, vc_)), jnp.asarray(gen),
        *map(jnp.asarray, (kn, vn)), H, jnp.asarray(xl), g["x_pad"],
        jnp.asarray(pl), g["y_start"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("T", [1, 4])
def test_lane_layout_slab_products_match_matmul_and_jax(T, monkeypatch):
    """The lanes' block-diagonal slab products, which the card runs at
    B > 1, in f32 here: equal to the plain matmul; and in place of
    slab_scores / slab_pv, decode_attention_multi (T = 1) and _multi_block
    (T = 4) at B = 4 equal JAX's within 2e-5, so that a head or lane mix-up
    of the layout fails on the CPU."""
    B, S_max, H, Dh, x_pad, y_start = 4, 36, 4, 16, 8, 20
    xl, pl = np.asarray([3, 8, 5, 1]), np.asarray([12, 4, 9, 1])
    rng = np.random.default_rng(20 + T)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kc, vc_, kn, vn = (r(B, T, H * Dh), r(B, S_max, H, Dh),
                          r(B, S_max, H, Dh), r(B, T, H, Dh), r(B, T, H, Dh))
    qh = torch.from_numpy(q).view(B, T, H, Dh).transpose(1, 2)
    k, v = torch.from_numpy(kc), torch.from_numpy(vc_)
    probs = torch.softmax(torch.from_numpy(r(B, H, T, S_max)), dim=-1)
    np.testing.assert_allclose(
        attn.lane_slab_scores(qh, k).numpy(),
        torch.matmul(qh, k.permute(0, 2, 3, 1)).numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(
        attn.lane_slab_pv(probs, v).numpy(),
        torch.matmul(probs, v.permute(0, 2, 1, 3)).numpy(), rtol=0, atol=2e-5)

    monkeypatch.setattr(attn, "slab_scores", attn.lane_slab_scores)
    monkeypatch.setattr(attn, "slab_pv", attn.lane_slab_pv)
    t, j = torch.from_numpy, jnp.asarray
    if T == 1:
        got = attn.decode_attention_multi(
            t(q), k, v, torch.tensor(27), t(kn), t(vn), H, t(xl), x_pad,
            t(pl), y_start)
        want = jattn.decode_attention_multi(
            j(q), j(kc), j(vc_), j(27), j(kn), j(vn), H, j(xl), x_pad, j(pl),
            y_start)
    else:
        gen = np.asarray([0, 7, 3, 12])
        got = attn.decode_attention_multi_block(
            t(q), k, v, t(gen), t(kn), t(vn), H, t(xl), x_pad, t(pl), y_start)
        want = jattn.decode_attention_multi_block(
            j(q), j(kc), j(vc_), j(gen), j(kn), j(vn), H, j(xl), x_pad, j(pl),
            y_start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def _slab(cfg, B, S_max, seed):
    L, H, Dh = cfg.num_decoder_layers, cfg.nhead, cfg.head_dim
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, 2, B, S_max, H, Dh)) * 0.5).astype(
        np.float32)


def test_decode_step_multi_matches_jax(setup):
    cfg, params, model, _ = setup
    B, S_max, pos = 3, 32, 26
    g = _lane_geometry()
    cache = _slab(cfg, B, S_max, 1)
    x = np.random.default_rng(2).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    xl, pl = np.asarray(g["x_lens"]), np.asarray(g["prefix_lens"])
    want_h, want_c = jtrm.decode_step_multi(
        params["decoder"], jnp.asarray(x), jnp.asarray(cache), jnp.asarray(pos),
        cfg.nhead, jnp.asarray(xl), g["x_pad"], jnp.asarray(pl), g["y_start"])
    with torch.inference_mode():
        got_h, got_c = trm.decode_step_multi(
            model.decoder, torch.from_numpy(x), torch.from_numpy(cache.copy()),
            torch.tensor(pos), torch.from_numpy(xl), g["x_pad"],
            torch.from_numpy(pl), g["y_start"])
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=2e-4)


def test_decode_step_multi_block_scatters_per_lane_to_the_budget_edge(setup):
    """Each lane's block lands at its own offset; lane 1's ends at the
    slab's last slot.  An offset past the slab raises (JAX's scatter would
    drop it)."""
    cfg, params, model, _ = setup
    B, S_max, T = 3, 36, 4
    g = _lane_geometry()
    gen = np.asarray([2, S_max - T - g["y_start"], 9])      # lane 1 at the edge
    cache = _slab(cfg, B, S_max, 3)
    x = np.random.default_rng(4).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    xl, pl = np.asarray(g["x_lens"]), np.asarray(g["prefix_lens"])
    offs = g["y_start"] + gen
    want_h, want_c = jtrm.decode_step_multi_block(
        params["decoder"], jnp.asarray(x), jnp.asarray(cache),
        jnp.asarray(offs), cfg.nhead, jnp.asarray(xl), g["x_pad"],
        jnp.asarray(pl), g["y_start"], gen_lens=jnp.asarray(gen))
    step = lambda c, o: trm.decode_step_multi_block(
        model.decoder, torch.from_numpy(x), c, torch.from_numpy(o),
        torch.from_numpy(xl), g["x_pad"], torch.from_numpy(pl), g["y_start"],
        torch.from_numpy(gen))
    with torch.inference_mode():
        got_h, got_c = step(torch.from_numpy(cache.copy()), offs)
        with pytest.raises(IndexError):
            step(torch.from_numpy(cache.copy()), offs + np.asarray([0, 1, 0]))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=2e-4)
    np.testing.assert_array_equal(got_c.numpy()[:, :, 1, S_max - 1] != 0, True)


# ---- the fp8 slab -----------------------------------------------------------------

def _jax_f8_bytes(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float8_e4m3fn)).view(np.uint8)


def test_fp8_cast_matches_jax_bit_for_bit():
    """torch's float8_e4m3fn cast equals JAX's astype byte for byte: every
    tie between neighbours (round to even), subnormals, and values up to
    464, the tie between e4m3's largest finite value 448 and overflow.
    (Past 464 they part: JAX gives NaN, torch saturates to 448; a k/v
    projection never comes near.)"""
    grid = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn)
    grid = grid.float().numpy()
    finite = np.sort(grid[np.isfinite(grid) & (grid >= 0)])
    mids = (finite[:-1] + finite[1:]) / 2                       # every tie
    rng = np.random.default_rng(0)
    vals = np.concatenate([finite, mids, np.nextafter(mids, 0),
                           np.nextafter(mids, 1), [449.0, 456.0, 463.9, 464.0],
                           rng.standard_normal(4000) * 4,
                           rng.standard_normal(1000) * 3e-3]).astype(np.float32)
    vals = np.concatenate([vals, -vals])
    got = torch.from_numpy(vals).to(torch.float8_e4m3fn).view(torch.uint8)
    np.testing.assert_array_equal(got.numpy(), _jax_f8_bytes(vals))


def test_fp8_slab_bytes_equal_jax_cast(setup):
    """The fp8 slab holds, byte for byte, JAX's astype(float8_e4m3fn) of
    what the same computation writes into an f32 slab: after a prefill of
    three lanes, and after a multi-lane step that reads the fp8 slab (its
    f32 twin holds the same values upcast); the step agrees with JAX's
    decode_step_multi on the same fp8 slab."""
    cfg, params, model, reqs = setup
    B = len(reqs)
    x_pad, y_pad, s_max, pos = 32, 64, 100, 96
    K = cfg.n_codebooks
    xt = np.full((B, x_pad), cfg.text_pad_token, np.int64)
    yt = np.full((B, K, y_pad), cfg.empty_token, np.int64)
    for b, (x, y) in enumerate(reqs):
        xt[b, :len(x)] = x
        yt[b, :, :y.shape[1]] = y
    xl = torch.tensor([len(x) for x, _ in reqs], dtype=torch.int32)
    pl = torch.tensor([y.shape[1] for _, y in reqs], dtype=torch.int32)
    feed = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32))
    step = lambda cache: trm.decode_step_multi(
        model.decoder, feed, cache, torch.tensor(pos), xl, x_pad, pl,
        x_pad + y_pad)
    with torch.inference_mode():
        slabs = {kv: vc.prefill_lanes(model, torch.from_numpy(xt), xl,
                                      torch.from_numpy(yt), pl,
                                      torch.full((1, y_pad), -1), s_max,
                                      kv)[2]
                 for kv in (None, F8)}
        c8 = slabs[F8]
        assert c8.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(c8.view(torch.uint8).numpy(),
                                      _jax_f8_bytes(slabs[None].numpy()))
        before = c8.clone()
        c32 = c8.float()
        h8, c8 = step(c8)
        h32, c32 = step(c32)
    np.testing.assert_array_equal(h8.numpy(), h32.numpy())
    np.testing.assert_array_equal(c8.view(torch.uint8).numpy(),
                                  _jax_f8_bytes(c32.numpy()))
    assert (c8.view(torch.uint8)[:, :, :, pos] != 0).any()
    want_h, want_c = jtrm.decode_step_multi(
        params["decoder"], jnp.asarray(feed.numpy()),
        jnp.asarray(before.float().numpy()).astype(jnp.float8_e4m3fn),
        jnp.asarray(pos), cfg.nhead, jnp.asarray(xl.numpy()), x_pad,
        jnp.asarray(pl.numpy()), x_pad + y_pad)
    np.testing.assert_allclose(h8.numpy(), np.asarray(want_h), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(c8.float().numpy(),
                               np.asarray(want_c.astype(jnp.float32)),
                               rtol=0.07, atol=1e-6)


# ---- the vectorised sampler -------------------------------------------------------

def _lane_state(cfg, B, seed):
    K, card = cfg.n_codebooks, cfg.card
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((B, K, card), generator=g) * 3
    eog = torch.zeros((B, K), dtype=torch.bool)
    if B > 1:
        eog[1, 0] = True                       # lane 1 inside its cascade
    return (logits, eog, torch.tensor([0, 5, 30, 2][:B]),
            torch.tensor([0, 1, 4, 6][:B]), torch.tensor([-1, 5, 7, 5][:B]),
            torch.tensor([20, 31, 200, 40][:B]), torch.tensor([4, 6, 1, 9][:B]))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_vectorised_sampler_equals_per_lane_sampling(setup, B, temperature):
    """One set of operations for B lanes equals each lane's own decision
    (bit for bit; at B = 1 the single-stream sampler itself), the noise of
    lane b drawn from generator b."""
    cfg = setup[0]
    scfg = vc.SamplingConfig(top_k=5, top_p=0.9, temperature=temperature,
                             stop_repetition=3, silence_tokens=(5, 7))
    cap = cfg.encodec_sr // 5
    logits, eog, cng, consec, prev, y_pos, x_len = _lane_state(cfg, B, 3)
    gens = lambda: [torch.Generator().manual_seed(100 + b) for b in range(B)]
    got = sc.make_lane_sampler(cfg, scfg, cap)(
        gens(), logits, eog, cng, consec, prev, y_pos, x_len)
    for b, gen in enumerate(gens()):
        want = vc._adjust_and_sample(cfg, scfg, True, cap, gen, logits[b],
                                     eog[b], cng[b], consec[b], prev[b],
                                     y_pos[b], x_len[b])
        for g_, w in zip(got, want):
            assert torch.equal(g_[b], w), b


# The single-stream sampler as it stood before it was vectorised over lanes
# ([K, card] logits, 0-d state), kept to pin what the vectorised one must
# reproduce at B = 1.

def _ref_adjust_logits(cfg, scfg, is_tts, logits_k, codebook_eog,
                       cur_num_gen, consec_silence, prev_token):
    K, card = logits_k.shape
    eog_stop = cfg.eog_inference if is_tts else cfg.eog
    rows = torch.arange(K)[:, None]
    cols = torch.arange(card)[None, :]
    n_eog = codebook_eog.sum()
    la = logits_k
    if cfg.eos > 0:
        la = la.masked_fill(cols == (cfg.eog if is_tts else cfg.eos), vc.BAN)
    ban = (rows > n_eog) & ((cols == eog_stop) | (cols == cfg.empty_token))
    la = la.masked_fill(ban, vc.BAN)
    if is_tts:
        min_guard = cur_num_gen <= cfg.encodec_sr // 5
        la = la.masked_fill(min_guard & (rows == 0) & (cols == eog_stop),
                            vc.BAN)
    if scfg.stop_repetition > 0 and len(scfg.silence_tokens) > 0:
        sil = torch.tensor(scfg.silence_tokens)
        hit = ((sil == prev_token).any()
               & (consec_silence > scfg.stop_repetition) & (n_eog == 0))
        denom = (consec_silence - (scfg.stop_repetition - 1)).float()
        cell = (rows == 0) & (cols == prev_token)
        penalised = torch.where(la < 0, la * denom, la / denom.clamp(min=1.0))
        la = torch.where(hit & cell, penalised, la)
    return la


def _ref_finalize_sample(cfg, scfg, is_tts, cap_mult, la, samples,
                         codebook_eog, cur_num_gen, consec_silence,
                         prev_token, y_pos, x_len):
    K = la.shape[0]
    eog_stop = cfg.eog_inference if is_tts else cfg.eog
    n_eog = codebook_eog.sum()
    r = torch.arange(K)
    s0 = torch.where(r > cur_num_gen, cfg.empty_token, samples)
    stop_hit = ((s0[0] == eog_stop) | (la[0].argmax() == eog_stop)
                | (y_pos > x_len * cap_mult))
    s0 = torch.where(r == 0, torch.where(stop_hit, eog_stop, s0[0]), s0)
    eog0 = torch.where(r == 0, stop_hit, codebook_eog)
    if len(scfg.silence_tokens) > 0:
        sil = torch.tensor(scfg.silence_tokens)
        is_sil = (sil == s0[0]).any() & (s0[0] == prev_token)
    else:
        is_sil = torch.zeros((), dtype=torch.bool)
    consec0 = torch.where(is_sil, consec_silence + 1, 0)
    prev0 = s0[0]
    s1 = torch.where(r < n_eog, cfg.empty_token, samples)
    s1 = torch.where(r == n_eog, eog_stop, s1)
    eog1 = codebook_eog | (r == n_eog)
    first = n_eog == 0
    return (torch.where(first, s0, s1), torch.where(first, eog0, eog1),
            torch.where(first, consec0, consec_silence),
            torch.where(first, prev0, prev_token))


def _ref_adjust_and_sample(cfg, scfg, is_tts, cap_mult, generator, logits_k,
                           codebook_eog, cur_num_gen, consec_silence,
                           prev_token, y_pos, x_len):
    la = _ref_adjust_logits(cfg, scfg, is_tts, logits_k, codebook_eog,
                            cur_num_gen, consec_silence, prev_token)
    if scfg.temperature <= 0:
        samples = la.argmax(dim=-1)
    else:
        lg = la if scfg.temperature == 1.0 else la / scfg.temperature
        lg = top_k_top_p_filter(lg, scfg.top_k, scfg.top_p)
        u = torch.rand(lg.shape, generator=generator)
        gumbel = -torch.log(-torch.log(u))
        samples = (lg + gumbel).argmax(dim=-1)
    return _ref_finalize_sample(cfg, scfg, is_tts, cap_mult, la, samples,
                                codebook_eog, cur_num_gen, consec_silence,
                                prev_token, y_pos, x_len)


@pytest.mark.parametrize("is_tts", [True, False])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_sampler_at_one_lane_equals_the_single_stream_sampler_it_replaced(
        setup, is_tts, temperature):
    """At B = 1, the vectorised sampler (one lane through make_lane_sampler,
    and the single-stream call with 0-d state) equals the unvectorised
    sampler above bit for bit, with stop_repetition and silence tokens set,
    on four states: a fresh lane, one inside its eog cascade, and two whose
    silence penalty is on."""
    cfg = setup[0]
    scfg = vc.SamplingConfig(top_k=5, top_p=0.9, temperature=temperature,
                             stop_repetition=3, silence_tokens=(5, 7))
    cap = cfg.encodec_sr // 5
    state = _lane_state(cfg, 4, 8)
    lane_sampler = sc.make_lane_sampler(cfg, scfg, cap, is_tts=is_tts)
    for b in range(4):
        one = [s[b] for s in state]
        gen = lambda: torch.Generator().manual_seed(200 + b)
        want = _ref_adjust_and_sample(cfg, scfg, is_tts, cap, gen(), *one)
        single = vc._adjust_and_sample(cfg, scfg, is_tts, cap, gen(), *one)
        lanes = lane_sampler([gen()], *[s[b:b + 1] for s in state])
        for w, s1, sl in zip(want, single, lanes):
            assert torch.equal(s1, w), b
            assert torch.equal(sl[0], w), b


def test_sampler_operations_do_not_grow_with_lanes(setup):
    """The sampler's tensor operations per decision are the same at 1 and 8
    lanes, apart from each lane's noise draw (one torch.rand per lane)."""
    cfg = setup[0]
    scfg = vc.SamplingConfig(top_k=5, top_p=0.9, temperature=1.0,
                             stop_repetition=3, silence_tokens=(5, 7))
    cap = cfg.encodec_sr // 5
    sampler = sc.make_lane_sampler(cfg, scfg, cap)

    def n_ops(B):
        logits, eog, *_ = _lane_state(cfg, 1, 3)
        st = [torch.zeros((B,), dtype=torch.long) for _ in range(5)]
        gens = [torch.Generator().manual_seed(b) for b in range(B)]
        with torch.profiler.profile() as prof:
            sampler(gens, logits.expand(B, -1, -1), eog.expand(B, -1), *st)
        ev = [e.name for e in prof.events() if e.name.startswith("aten::")]
        return len(ev), ev.count("aten::rand")

    (n1, r1), (n8, r8) = n_ops(1), n_ops(8)
    assert (r1, r8) == (1, 8)
    # the 7 extra draws and the stack of 8 lanes' noise are the only growth
    assert n8 - n1 <= 3 * (r8 - r1) + 4, (n1, n8)


# ---- serve_tts_batch --------------------------------------------------------------

def test_serving_greedy_lanes_equal_jax_and_single_stream(setup, jax_greedy):
    cfg, _, model, reqs = setup
    scfg = vc.SamplingConfig(**GREEDY)
    stats = {}
    out = sv.serve_tts_batch(model, reqs, scfg, seed=0, stats=stats)
    assert stats["frames"] > 0 and stats["steps"] > 0 and stats["spec"] == 0
    for b, ((x, y), (full, gen), (_, jgen)) in enumerate(
            zip(reqs, out, jax_greedy)):
        assert_codes_equal(gen, jgen, f"lane {b} vs JAX serving")
        np.testing.assert_array_equal(full[:, :y.shape[1]], y)
        np.testing.assert_array_equal(
            gen, tts.inference_tts(model, x, y, scfg, seed=0)[1],
            err_msg=f"lane {b} vs the port's single stream")


def test_serving_special_first_equals_single_stream():
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32",
                              special_first=1)
    params, model = _pair(cfg, 7)
    reqs = _requests(cfg, 11, n=2, shift=cfg.n_special)
    scfg = vc.SamplingConfig(**GREEDY)
    out = sv.serve_tts_batch(model, reqs, scfg, seed=0)
    want = jsv.serve_tts_batch(params, cfg, reqs, jvc.SamplingConfig(**GREEDY),
                               seed=0)
    for b, ((x, y), (full, gen)) in enumerate(zip(reqs, out)):
        full1, gen1 = tts.inference_tts(model, x, y, scfg, seed=0)
        np.testing.assert_array_equal(full, full1, err_msg=f"lane {b}")
        np.testing.assert_array_equal(full[:, :y.shape[1]], y)
        assert_codes_equal(gen, want[b][1], f"lane {b} vs JAX")


def test_serving_fp8_slab_greedy_equals_jax(setup):
    cfg, params, model, reqs = setup
    out = sv.serve_tts_batch(model, reqs, vc.SamplingConfig(**GREEDY), seed=0,
                             kv_dtype=F8)
    want = jsv.serve_tts_batch(params, cfg, reqs, jvc.SamplingConfig(**GREEDY),
                               seed=0, kv_dtype=F8)
    for b, ((_, y), (full, gen), (_, jgen)) in enumerate(zip(reqs, out, want)):
        assert_codes_equal(gen, jgen, f"lane {b}")
        np.testing.assert_array_equal(full[:, :y.shape[1]], y)


def test_serving_per_request_seeds(setup):
    """Lane b is keyed on (seed_b, b): changing one request's seed changes
    only that lane; same-seed identical requests in two lanes draw
    independently; an identical wave is deterministic."""
    cfg, _, model, reqs = setup
    x, y = reqs[1]
    scfg = vc.SamplingConfig(**SAMPLED)
    a = sv.serve_tts_batch(model, [(x, y), (x, y)], scfg, seeds=[3, 5])
    b = sv.serve_tts_batch(model, [(x, y), (x, y)], scfg, seeds=[3, 9])
    c = sv.serve_tts_batch(model, [(x, y), (x, y)], scfg, seeds=[3, 5])
    np.testing.assert_array_equal(a[0][1], b[0][1])
    assert a[1][1].shape != b[1][1].shape or not np.array_equal(a[1][1], b[1][1])
    np.testing.assert_array_equal(a[1][1], c[1][1])
    same = sv.serve_tts_batch(model, [(x, y), (x, y)], scfg, seed=9)
    g0, g1 = same[0][1], same[1][1]
    assert g0.shape != g1.shape or not np.array_equal(g0, g1)


def test_frozen_lane_is_untouched_by_the_rest_of_the_wave(setup):
    """A lane that finishes early emits empty rows from then on, and its
    output equals its output alone, however long the other lanes run."""
    cfg, _, model, reqs = setup
    scfg = vc.SamplingConfig(**GREEDY)
    wave = [reqs[0], reqs[2]]
    geo = (32, 64, 256)
    out = sv.serve_tts_batch(model, wave, scfg, seed=0, pads=geo)
    alone = sv.serve_tts_batch(model, [reqs[0]], scfg, seed=0, pads=geo)
    np.testing.assert_array_equal(out[0][0], alone[0][0])
    assert out[0][1].shape[1] < out[1][1].shape[1]
    x_pad, y_pad, gen_max = geo
    loop = sv.make_serving_tts_loop(cfg, batch_size=2, x_pad=x_pad,
                                    y_pad=y_pad, gen_max=gen_max, scfg=scfg)
    K = cfg.n_codebooks
    xt = np.full((2, x_pad), cfg.text_pad_token, np.int64)
    yt = np.full((2, K, y_pad), cfg.empty_token, np.int64)
    for b, (x, y) in enumerate(wave):
        xt[b, :len(x)] = x
        yt[b, :, :y.shape[1]] = y
    res = loop(model, torch.from_numpy(xt), [len(x) for x, _ in wave],
               torch.from_numpy(yt), [y.shape[1] for _, y in wave], [0, 0])
    n0 = res.n_rows[0]
    assert n0 < res.steps
    assert (res.gen_buf[n0:res.steps, 0] == cfg.empty_token).all()


def test_serving_refuses_a_mesh(setup):
    _, _, model, reqs = setup
    with pytest.raises(NotImplementedError, match="mesh"):
        sv.serve_tts_batch(model, reqs, vc.SamplingConfig(**GREEDY),
                           mesh=object())
