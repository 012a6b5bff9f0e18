"""Verified speculative TTS in the port against the JAX package, on the CPU:
the block attention and block decode step, rewinding the slab, the MTP
heads, the verify core (spec_common), and make_spec_decode_loop /
inference_tts_spec end to end, with both CLIs' --spec flags.  Both
packages run tiny_test_mtp in f32 on the same weights; the JAX spec loop is
compiled once (tau 4)."""

import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test, tiny_test_mtp
from voicecraft_tpu.inference import spec_common as jsc
from voicecraft_tpu.inference import tts as jtts
from voicecraft_tpu.models import transformer as jtrm
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu.ops.attention import \
    decode_attention_self_block as jblock_attn
from voicecraft_tpu_torch.data import spans
from voicecraft_tpu_torch.inference import spec_common as sc
from voicecraft_tpu_torch.inference import tts
from voicecraft_tpu_torch.models import transformer as trm
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops.attention import decode_attention_self_block
from voicecraft_tpu_torch.utils.audio import read_wav
from voicecraft_tpu_torch.utils.convert import from_jax_params

REPO = Path(__file__).resolve().parents[1]
DEMO_TEXT = "the sound of birds over the river at dawn"
TIE_MARGIN = 1e-3
TAU_JAX = 4
GREEDY = dict(temperature=0.0, silence_tokens=())
SAMPLED = dict(top_k=10, top_p=0.9, temperature=1.0, stop_repetition=3,
               silence_tokens=(5, 7))


def assert_rows_tie_aware(got, want, step_logits, min_matched=10):
    """Recorded delayed-space rows of the port (got [n, K]) against JAX's
    (want): equal up to the first row whose draw had a top-2 margin under
    TIE_MARGIN in step_logits (the port's adjusted logits of each row, min
    over codebooks), and equal throughout without such a row.  Returns the
    rows matched."""
    for j in range(min(len(got), len(want))):
        if not np.array_equal(got[j], want[j]):
            top2 = np.sort(step_logits[j], axis=-1)[:, -2:]
            margin = float(np.min(top2[:, 1] - top2[:, 0]))
            assert margin < TIE_MARGIN, f"divergence at row {j}, margin {margin}"
            assert j >= min_matched, f"only {j} rows matched"
            return j
    assert len(got) == len(want)
    return len(got)


def recording_sample(monkeypatch):
    """Record the logits of every draw of the port's decode loops."""
    logits = []
    orig = vc.sample

    def rec(generator, lg, *a, **kw):
        logits.append(lg.numpy().copy())
        return orig(generator, lg, *a, **kw)

    monkeypatch.setattr(vc, "sample", rec)
    return logits


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These decodes run thousands of tiny ops: on one thread each, since
    the test workers share the machine's cores (threads spinning between
    ops made them ~100x slower under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(tiny_test_mtp(), compute_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    params = jvc.init_params(cfg, jax.random.PRNGKey(5))
    model = vc.VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), cfg))
    rng = np.random.default_rng(2)
    x = rng.integers(0, cfg.text_vocab_size, 10).astype(np.int32)
    y = rng.integers(0, cfg.audio_vocab_size, (cfg.n_codebooks, 24)).astype(np.int32)
    return cfg, params, model.eval(), x, y


# ---- primitives ----------------------------------------------------------------

@pytest.mark.parametrize("B,x_pad", [(1, None), (1, 8), (2, 8)])
def test_decode_attention_self_block_matches_jax(B, x_pad):
    S_max, H, Dh, T, kv_len, x_len = 40, 4, 16, 4, 30, 5
    rng = np.random.default_rng(B + (x_pad or 0))
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kc, vc_, kn, vn = (r(B, T, H * Dh), r(B, S_max, H, Dh), r(B, S_max, H, Dh),
                          r(B, T, H, Dh), r(B, T, H, Dh))
    xl = None if x_pad is None else x_len
    got = decode_attention_self_block(
        *map(torch.from_numpy, (q, kc, vc_)), torch.tensor(kv_len),
        *map(torch.from_numpy, (kn, vn)), H,
        x_len=None if xl is None else torch.tensor(xl), x_pad=x_pad)
    want = jblock_attn(*map(jnp.asarray, (q, kc, vc_)), jnp.asarray(kv_len),
                       *map(jnp.asarray, (kn, vn)), H,
                       x_len=None if xl is None else jnp.asarray(xl), x_pad=x_pad)
    assert got.shape == (B, T, H * Dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _decoder(seed=0):
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32")
    model = vc.VoiceCraft(cfg, "cpu").init_weights(torch.Generator().manual_seed(seed))
    return cfg, model.decoder


def _step(dec, x, cache, pos, x_len, x_pad):
    return trm.decode_step_fast(dec, x, cache, torch.tensor(pos),
                                x_len=torch.tensor(x_len), x_pad=x_pad)


def test_decode_step_block_equals_sequential_steps():
    cfg, dec = _decoder()
    L, H, Dh, D = cfg.num_decoder_layers, cfg.nhead, cfg.head_dim, cfg.d_model
    x_pad, x_len, pos = 8, 5, 8
    g = torch.Generator().manual_seed(1)
    cache = trm.init_kv_cache(L, 1, 48, H, Dh, torch.float32, "cpu")
    with torch.inference_mode():
        for i, e in enumerate(torch.randn((6, 1, 1, D), generator=g)):
            _, cache = _step(dec, e, cache, pos + i, x_len, x_pad)
        cache_b = cache.clone()
        blk = torch.randn((1, 4, D), generator=g)
        hs = []
        for i in range(4):
            h, cache = _step(dec, blk[:, i:i + 1], cache, pos + 6 + i, x_len,
                             x_pad)
            hs.append(h)
        h_blk, cache_b = trm.decode_step_block(
            dec, blk, cache_b, torch.tensor(pos + 6), x_len=torch.tensor(x_len),
            x_pad=x_pad)
    np.testing.assert_allclose(torch.cat(hs, 1).numpy(), h_blk.numpy(), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(cache.numpy(), cache_b.numpy(), rtol=0, atol=2e-5)


def test_decode_step_block_matches_jax():
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32")
    params = jvc.init_params(cfg, jax.random.PRNGKey(3))
    model = vc.VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), cfg))
    L, H, Dh, D = cfg.num_decoder_layers, cfg.nhead, cfg.head_dim, cfg.d_model
    rng = np.random.default_rng(4)
    cache = (rng.standard_normal((L, 2, 1, 40, H, Dh)) * 0.5).astype(np.float32)
    blk = rng.standard_normal((1, 3, D)).astype(np.float32)
    want_h, want_c = jtrm.decode_step_block(
        params["decoder"], jnp.asarray(blk), jnp.asarray(cache), jnp.asarray(20),
        H, x_len=jnp.asarray(6), x_pad=8)
    with torch.inference_mode():
        got_h, got_c = trm.decode_step_block(
            model.decoder, torch.from_numpy(blk), torch.from_numpy(cache.copy()),
            torch.tensor(20), x_len=torch.tensor(6), x_pad=8)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=2e-5)


def test_block_write_rewind_is_sound():
    """Write a 4-token block, reject its last 2 by moving pos back, go on
    one token at a time: the same as a run that never saw the rejected
    tokens."""
    cfg, dec = _decoder(1)
    L, H, Dh, D = cfg.num_decoder_layers, cfg.nhead, cfg.head_dim, cfg.d_model
    x_pad = x_len = pos0 = 8
    g = torch.Generator().manual_seed(2)
    good, bad, nxt = (torch.randn((1, n, D), generator=g) for n in (2, 2, 1))
    cache = trm.init_kv_cache(L, 1, 48, H, Dh, torch.float32, "cpu")
    blk = lambda c, x: trm.decode_step_block(dec, x, c, torch.tensor(pos0),
                                             x_len=torch.tensor(x_len), x_pad=x_pad)
    with torch.inference_mode():
        _, spec_cache = blk(cache.clone(), torch.cat([good, bad], 1))
        h_spec, _ = _step(dec, nxt, spec_cache, pos0 + 2, x_len, x_pad)
        _, clean = blk(cache.clone(), good)
        h_clean, _ = _step(dec, nxt, clean, pos0 + 2, x_len, x_pad)
    np.testing.assert_allclose(h_spec.numpy(), h_clean.numpy(), rtol=0, atol=2e-5)


# ---- MTP heads ---------------------------------------------------------------

def test_mtp_heads_leave_the_other_weights_alone():
    base = vc.VoiceCraft(dataclasses.replace(tiny_test(), compute_dtype="float32"),
                         "cpu").init_weights(torch.Generator().manual_seed(3))
    mtp = vc.VoiceCraft(_cfg(), "cpu").init_weights(torch.Generator().manual_seed(3))
    sd, sd_mtp = base.state_dict(), mtp.state_dict()
    assert {k for k in sd_mtp if k.startswith("mtp_heads.")} and len(mtp.mtp_heads) == 3
    for k, v in sd.items():
        torch.testing.assert_close(sd_mtp[k], v, rtol=0, atol=0)
    heads = vc.init_mtp_heads(_cfg(), torch.Generator().manual_seed(0), "cpu")
    assert len(heads) == 3 and heads[0].w1.shape == base.heads.w1.shape
    assert not heads[0].w1.requires_grad


def test_from_jax_params_carries_mtp_heads(setup):
    cfg, params, model, _, _ = setup
    for j in range(cfg.n_mtp):
        for name in ("w1", "b1", "w2", "b2"):
            np.testing.assert_array_equal(
                getattr(model.mtp_heads[j], name).numpy(),
                np.asarray(params["mtp_heads"][name][j]))


def test_check_mtp_heads_errors_and_warning(setup):
    cfg, params, model, x, y = setup
    bare = vc.VoiceCraft(dataclasses.replace(cfg, n_mtp=0), "cpu")
    with pytest.raises(ValueError, match="mtp_heads"):
        vc.check_mtp_heads(bare, 4)
    with pytest.raises(ValueError, match="n_mtp=3"):
        vc.check_mtp_heads(model, 5)
    with pytest.raises(ValueError, match="mtp_heads"):
        tts.inference_tts_spec(bare, x, y, vc.SamplingConfig(**GREEDY), n_draft=2)
    vc.check_mtp_heads(bare, 1)                   # no drafts, no heads needed
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        vc.check_mtp_heads(model, 4, vc.SamplingConfig(**GREEDY))
        vc.check_mtp_heads(model, 4, vc.SamplingConfig(
            **SAMPLED, spec_sampling="stochastic"))
    with pytest.warns(UserWarning, match="rejects almost"):
        vc.check_mtp_heads(model, 4, vc.SamplingConfig(**SAMPLED))


def test_spec_loop_refuses_options_of_later_slices():
    """The speculative loops take the options of their JAX counterparts and
    no more: make_spec_decode_loop takes bench_mode and kv_dtype (refused
    before they were ported); make_spec_edit_loop, like JAX's, takes
    neither."""
    for kw in (dict(bench_mode=True), dict(kv_dtype="float8_e4m3fn")):
        vc.make_spec_decode_loop(_cfg(), x_pad=32, y_pad=64, gen_max=128,
                                 scfg=vc.SamplingConfig(), n_draft=4, **kw)
        jvc.make_spec_decode_loop(_cfg(), x_pad=32, y_pad=64, gen_max=128,
                                  scfg=jvc.SamplingConfig(), n_draft=4, **kw)
        for make in (vc.make_spec_edit_loop, jvc.make_spec_edit_loop):
            with pytest.raises(TypeError):
                make(_cfg(), x_pad=32, y_pad=64, gen_max=128,
                     scfg=vc.SamplingConfig(), n_draft=4, **kw)
    for kv in ("int8", "float8_e5m2"):
        with pytest.raises(ValueError, match="kv_dtype"):
            vc.make_spec_decode_loop(_cfg(), x_pad=32, y_pad=64, gen_max=128,
                                     scfg=vc.SamplingConfig(), n_draft=4,
                                     kv_dtype=kv)(
                vc.VoiceCraft(_cfg(), "cpu"), *_padded_prompt(), 0)


def _padded_prompt():
    """A tiny prompt padded to x_pad 32, y_pad 64: (xt, x_len, yt,
    prefix_len, mi)."""
    cfg = _cfg()
    rng = np.random.default_rng(9)
    x = rng.integers(0, cfg.text_vocab_size, 10)
    y = rng.integers(0, cfg.audio_vocab_size, (cfg.n_codebooks, 20))
    prefix = spans.compose_tts_prefix(y, cfg)
    xt, yt, mi, _ = tts.pad_inputs(cfg, x, prefix, 32, 64, "cpu")
    return xt, len(x), yt, prefix.length, mi


@pytest.mark.parametrize("spec", [0, 3])
def test_bench_mode_records_exactly_gen_max_rows(setup, spec):
    """bench_mode never stops: the plain and the speculative loop record
    exactly gen_max rows, special codes mapped to 0 (bench.py asserts
    the same count)."""
    cfg, _, model, x, y = setup
    gen_max = 40
    scfg = vc.SamplingConfig(**SAMPLED)
    _, plen, x_pad, y_pad, _, (xt, yt, mi) = tts._tts_prompt(model, x, y, None)
    if spec:
        loop = vc.make_spec_decode_loop(cfg, x_pad=x_pad, y_pad=y_pad,
                                        gen_max=gen_max, scfg=scfg,
                                        n_draft=spec, bench_mode=True)
        res = loop(model, xt, len(x), yt, plen, mi, 0)
    else:
        loop = vc.make_decode_loop(cfg, is_tts=True, x_pad=x_pad, y_pad=y_pad,
                                   gen_max=gen_max, scfg=scfg, bench_mode=True)
        res = loop(model, xt, len(x), yt, plen, mi, torch.zeros(3), 1,
                   torch.Generator().manual_seed(0))
    assert res.gen_cnt == gen_max
    rows = res.gen_buf[:gen_max]
    assert (rows >= 0).all() and (rows < cfg.audio_vocab_size).all()


def _jax_decode(params, cfg, x, y, jscfg, gen_max, **kw):
    """The JAX package's plain TTS decode of (x, y): recorded rows."""
    prefix = spans.compose_tts_prefix(y, cfg)
    x_pad, y_pad, _ = tts.decode_geometry(cfg, len(x), prefix.length)
    loop = jvc.make_decode_loop(cfg, is_tts=True, x_pad=x_pad, y_pad=y_pad,
                                gen_max=gen_max, scfg=jscfg, **kw)
    xt = np.full((1, x_pad), cfg.text_pad_token, np.int32)
    xt[0, :len(x)] = x
    yt = np.full((1, cfg.n_codebooks, y_pad), cfg.empty_token, np.int32)
    yt[0, :, :prefix.length] = prefix.tokens
    mi = np.full((1, y_pad), -1, np.int32)
    gen_buf, _, gen_cnt, _ = loop(
        params, jnp.asarray(xt), jnp.asarray(len(x), jnp.int32),
        jnp.asarray(yt), jnp.asarray(prefix.length, jnp.int32),
        jnp.asarray(mi), jnp.zeros((cfg.max_n_spans,), jnp.int32),
        jnp.asarray(1, jnp.int32), jax.random.PRNGKey(0))
    return np.asarray(gen_buf)[:int(gen_cnt)]


def _port_decode(model, cfg, x, y, scfg, gen_max, **kw):
    prefix = spans.compose_tts_prefix(y, cfg)
    x_pad, y_pad, _ = tts.decode_geometry(cfg, len(x), prefix.length)
    xt, yt, mi, qm = tts.pad_inputs(cfg, x, prefix, x_pad, y_pad, "cpu")
    loop = vc.make_decode_loop(cfg, is_tts=True, x_pad=x_pad, y_pad=y_pad,
                               gen_max=gen_max, scfg=scfg, **kw)
    res = loop(model, xt, len(x), yt, prefix.length, mi, qm, 1, None)
    return res.gen_buf[:res.gen_cnt].numpy()


def test_bench_mode_matches_jax_special_code_mapping(setup, monkeypatch):
    """Greedy bench_mode rows equal the JAX loop's (its special codes
    mapped to 0, no stop), up to a near-tie of the recorded logits."""
    cfg, params, model, x, y = setup
    logits = recording_sample(monkeypatch)
    got = _port_decode(model, cfg, x, y, vc.SamplingConfig(**GREEDY), 128,
                       bench_mode=True)
    monkeypatch.undo()
    want = _jax_decode(params, cfg, x, y, jvc.SamplingConfig(**GREEDY), 128,
                       bench_mode=True)
    assert len(got) == len(want) == 128
    assert_rows_tie_aware(got, want, logits)


def test_plain_loop_fp8_slab_matches_jax_greedy(setup, monkeypatch):
    """The single-stream loop with kv_dtype float8_e4m3fn against JAX's
    with the same slab dtype, greedy, tie-aware; the prompt rows' slab is
    quantised the same way (tests/test_torch_serving.py holds the bytes)."""
    cfg, params, model, x, y = setup
    logits = recording_sample(monkeypatch)
    got = _port_decode(model, cfg, x, y, vc.SamplingConfig(**GREEDY), 128,
                       kv_dtype="float8_e4m3fn")
    monkeypatch.undo()
    want = _jax_decode(params, cfg, x, y, jvc.SamplingConfig(**GREEDY), 128,
                       kv_dtype="float8_e4m3fn")
    assert len(got) > cfg.n_codebooks
    assert_rows_tie_aware(got, want, logits)


# ---- the verify core -----------------------------------------------------------

def test_row_verify_preserves_target_distribution():
    """The raw tokens follow p exactly (TV under 0.02 over 40000 draws) for
    drafts from a different q, and acceptance is the p/q overlap."""
    K, card, n = 2, 12, 40000
    rng = np.random.default_rng(0)
    la = torch.from_numpy(rng.normal(0, 1.5, (K, card)).astype(np.float32))
    dlg = torch.from_numpy(rng.normal(0, 1.5, (K, card)).astype(np.float32))
    scfg = vc.SamplingConfig(top_k=0, top_p=1.0, temperature=1.0,
                             spec_sampling="stochastic")
    p = torch.softmax(sc._filtered(scfg, la), -1).numpy()
    g = torch.Generator().manual_seed(1)
    d_tok = vc.sample(g, sc._filtered(scfg, dlg).expand(n, K, card))
    raw, ok = sc.stochastic_row_verify(g, la.expand(n, K, card),
                                       dlg.expand(n, K, card), d_tok,
                                       torch.zeros((n, K), dtype=torch.bool), scfg)
    assert raw.shape == (n, K) and ok.shape == (n,)
    for k in range(K):
        freq = np.bincount(raw[:, k].numpy(), minlength=card) / n
        assert 0.5 * np.abs(freq - p[k]).sum() < 0.02, k
    q = torch.softmax(sc._filtered(scfg, dlg), -1).numpy()
    overlap = np.minimum(p, q).sum(-1).prod()
    assert abs(float(ok.float().mean()) - overlap) < 0.02
    assert 0.05 < float(ok.float().mean()) < 0.95


def test_row_verify_overridden_rows_always_accept():
    K, card, n = 3, 8, 4000
    rng = np.random.default_rng(2)
    la = torch.from_numpy(rng.normal(0, 1, (K, card)).astype(np.float32))
    dlg = torch.from_numpy(rng.normal(0, 1, (K, card)).astype(np.float32))
    scfg = vc.SamplingConfig(top_k=0, top_p=1.0, temperature=1.0,
                             spec_sampling="stochastic")
    overridden = torch.tensor([False, True, True]).expand(n, K)
    d_tok = la.argmin(-1).expand(n, K)        # a token p gives little mass
    raw, ok = sc.stochastic_row_verify(torch.Generator().manual_seed(3),
                                       la.expand(n, K, card),
                                       dlg.expand(n, K, card), d_tok,
                                       overridden, scfg)
    p = torch.softmax(la, -1).numpy()
    q = torch.softmax(dlg, -1).numpy()
    d0 = int(la[0].argmin())
    assert abs(float(ok.float().mean()) - min(1.0, p[0, d0] / q[0, d0])) < 0.03
    for k in (1, 2):
        freq = np.bincount(raw[:, k].numpy(), minlength=card) / n
        assert 0.5 * np.abs(freq - p[k]).sum() < 0.04, k


@pytest.mark.parametrize("scfg", [
    vc.SamplingConfig(temperature=0.0, spec_sampling="stochastic"),
    vc.SamplingConfig(temperature=1.0, spec_sampling="stochastic"),
    vc.SamplingConfig(temperature=1.0, spec_sampling="exact")])
@pytest.mark.parametrize("tau", [1, 4])
def test_use_stochastic_verify_gating_matches_jax(scfg, tau):
    jscfg = jvc.SamplingConfig(temperature=scfg.temperature,
                               spec_sampling=scfg.spec_sampling)
    assert sc.use_stochastic_verify(scfg, tau) == jsc.use_stochastic_verify(jscfg, tau)


def test_accepted_slots_match_fed_rows(setup):
    """Every accepted slot's emitted row equals the row fed to the block
    forward, in lanes forged mid-cascade, at the length cap and in the
    forced-empty window (stochastic verification)."""
    cfg, _, model, _, _ = setup
    K, D, card = cfg.n_codebooks, cfg.d_model, cfg.card
    cap_mult = cfg.encodec_sr // 5
    tau, B = 4, 4
    scfg = vc.SamplingConfig(top_k=0, top_p=1.0, temperature=1.0,
                             silence_tokens=(), spec_sampling="stochastic")
    sample_lanes = sc.make_lane_sampler(cfg, scfg, cap_mult)
    eog = torch.zeros((B, K), dtype=torch.bool)
    eog[0, 0] = True
    cng = torch.tensor([20, 20, 20, 1])
    x_lens = torch.tensor([40, 40, 1, 40])
    y_pos0 = torch.tensor([30, 30, cap_mult + 1, 30])
    g = torch.Generator().manual_seed(100)
    accepted = 0
    with torch.inference_mode():
        for trial in range(12):
            gens = sc.token_generators(scfg, trial, "cpu", lanes=B)
            out = sc.spec_verify_pass(
                model, cfg, sample_lanes, tau=tau,
                gate=torch.ones((B,), dtype=torch.bool),
                tok_gen=gens, y_pos0=y_pos0, x_lens=x_lens,
                logits=torch.randn((B, K, card), generator=g) * 2.0,
                h=torch.randn((B, D), generator=g), eog=eog, cng=cng,
                consec=torch.zeros((B,), dtype=torch.long),
                prev=torch.full((B,), -1), t=0, accept_cap=10_000,
                forward=lambda feed: feed, scfg=scfg, is_tts=True,
                cap_mult=cap_mult, pending=torch.zeros((B, K), dtype=torch.long),
                has_pending=torch.zeros((B,), dtype=torch.bool))
            for b in range(B):
                for i in range(1, int(out["n_acc"][b])):
                    accepted += 1
                    np.testing.assert_array_equal(out["blk"][b, i],
                                                  out["tokens_fed"][b, i])
    assert accepted > 0


# ---- the speculative TTS loop ------------------------------------------------

def _greedy_plain_raw(model, cfg, x, y, monkeypatch):
    logits = recording_sample(monkeypatch)
    prefix = spans.compose_tts_prefix(y, cfg)
    raw, _ = tts.run_decode(model, is_tts=True, x_tokens=x, prefix=prefix,
                            n_spans=1, scfg=vc.SamplingConfig(**GREEDY), seed=0,
                            return_raw=True)
    monkeypatch.undo()
    return raw, logits


def _spec_raw(model, cfg, x, y, scfg, tau, seed=0):
    _, plen, x_pad, y_pad, gen_max, (xt, yt, mi) = tts._tts_prompt(model, x, y, None)
    loop = vc.make_spec_decode_loop(cfg, x_pad=x_pad, y_pad=y_pad,
                                    gen_max=gen_max, scfg=scfg, n_draft=tau)
    res = loop(model, xt, len(x), yt, plen, mi, seed)
    return res.gen_buf[:res.gen_cnt].numpy(), res


@pytest.mark.parametrize("tau", [1, 2, 4])
def test_spec_greedy_equals_plain_loop(setup, tau):
    """Random MTP heads: nearly every draft is rejected, and the greedy
    output is still the plain loop's, token for token (f32)."""
    cfg, _, model, x, y = setup
    scfg = vc.SamplingConfig(**GREEDY)
    full_p, gen_p = tts.inference_tts(model, x, y, scfg, seed=0)
    full_s, gen_s, st = tts.inference_tts_spec(model, x, y, scfg, n_draft=tau,
                                               seed=0, return_stats=True)
    np.testing.assert_array_equal(gen_s, gen_p)
    np.testing.assert_array_equal(full_s, full_p)
    assert st["passes"] >= 1 and st["tokens"] >= st["passes"]


def test_spec_greedy_matches_jax_spec_tie_aware(setup, monkeypatch):
    cfg, params, model, x, y = setup
    plain, logits = _greedy_plain_raw(model, cfg, x, y, monkeypatch)
    got, _ = _spec_raw(model, cfg, x, y, vc.SamplingConfig(**GREEDY), TAU_JAX)
    np.testing.assert_array_equal(got, plain)
    jscfg = jvc.SamplingConfig(**GREEDY)
    prefix = spans.compose_tts_prefix(y, cfg)
    x_pad, y_pad, gen_max = tts.decode_geometry(cfg, len(x), prefix.length)
    loop = jtts._get_spec_loop(cfg, x_pad, y_pad, gen_max, jscfg, TAU_JAX)
    xt = np.full((1, x_pad), cfg.text_pad_token, np.int32)
    xt[0, :len(x)] = x
    yt = np.full((1, cfg.n_codebooks, y_pad), cfg.empty_token, np.int32)
    yt[0, :, :prefix.length] = prefix.tokens
    gen_buf, gen_cnt, n_passes = loop(params, jnp.asarray(xt),
                                      jnp.asarray(len(x), jnp.int32),
                                      jnp.asarray(yt),
                                      jnp.asarray(prefix.length, jnp.int32),
                                      jax.random.PRNGKey(0))
    want = np.asarray(gen_buf)[:int(gen_cnt)]
    assert_rows_tie_aware(got, want, logits)


def test_spec_sampled_output_invariant_to_tau(setup):
    cfg, _, model, x, y = setup
    scfg = vc.SamplingConfig(**SAMPLED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        outs = [tts.inference_tts_spec(model, x, y, scfg, n_draft=tau,
                                       seed=11)[1] for tau in (1, 2, 4)]
    assert outs[0].shape[1] > 0
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


@pytest.mark.parametrize("tau", [2, 4])
def test_force_accept_retires_tau_tokens_per_pass(setup, tau):
    cfg, _, model, x, y = setup
    raw, res = _spec_raw(model, cfg, x, y, vc.SamplingConfig(**GREEDY), tau)
    loop = vc.make_spec_decode_loop(cfg, x_pad=32, y_pad=64, gen_max=128,
                                    scfg=vc.SamplingConfig(**GREEDY),
                                    n_draft=tau, force_accept=True)
    _, plen, *_, (xt, yt, mi) = tts._tts_prompt(model, x, y, None)
    forced = loop(model, xt, len(x), yt, plen, mi, 0)
    # every pass but the last retires tau tokens (the drafts, so the run
    # differs from the unforced one)
    assert forced.passes == -(-forced.gen_cnt // tau)
    assert forced.gen_cnt >= 4 * tau and res.passes >= res.gen_cnt / tau
    _, _, st = tts.inference_tts_spec(model, x, y, vc.SamplingConfig(**GREEDY),
                                      n_draft=tau, seed=0, return_stats=True,
                                      force_accept=True)
    assert st["tokens_per_pass"] > tau - 1


def test_stochastic_spec_tts_runs_and_is_deterministic(setup):
    cfg, _, model, x, y = setup
    scfg = vc.SamplingConfig(**SAMPLED, spec_sampling="stochastic")
    full, gen, st = tts.inference_tts_spec(model, x, y, scfg, n_draft=4, seed=3,
                                           return_stats=True)
    np.testing.assert_array_equal(full[:, :y.shape[1]], y)
    assert gen.shape[0] == cfg.n_codebooks and st["passes"] >= 1
    assert gen.size == 0 or gen.max() < cfg.audio_vocab_size + cfg.n_special
    np.testing.assert_array_equal(
        gen, tts.inference_tts_spec(model, x, y, scfg, n_draft=4, seed=3)[1])


def test_token_generators_key_on_index_and_salt():
    scfg = vc.SamplingConfig(temperature=1.0)
    gens = sc.token_generators(scfg, 7, "cpu")
    draw = lambda g: torch.rand(4, generator=g[0])
    assert torch.equal(draw(gens(5, 0)), draw(gens(5, 0)))
    assert not torch.equal(draw(gens(5, 0)), draw(gens(6, 0)))
    assert not torch.equal(draw(gens(5, 0)), draw(gens(5, sc.SALT_VERIFY)))
    assert sc.token_generators(vc.SamplingConfig(temperature=0.0), 7, "cpu")(5, 0) is None


# ---- the CLIs ---------------------------------------------------------------

def _tts_cli(tmp_path, *extra):
    import tts_torch_cli
    return tts_torch_cli.run([
        "--model", "tiny_test", "--random-init", "--device", "cpu",
        "--text-backend", "grapheme", "--silence-tokens", "5", "7",
        "--prompt-wav", str(REPO / "demo" / "demo.wav"),
        "--prompt-transcript", DEMO_TEXT,
        "--target-transcript", "the river runs past the mill",
        "--out", str(tmp_path / "out.wav"), *extra])


def test_tts_cli_spec_greedy_equals_plain(tmp_path, caplog):
    """--random-init --spec 3 adds two random MTP head groups, drawn after
    the other weights: greedy output equals the plain CLI's."""
    caplog.set_level("INFO")
    full_s, gen_s = _tts_cli(tmp_path, "--temperature", "0", "--spec", "3")
    assert "tokens/pass" in caplog.text
    full_p, gen_p = _tts_cli(tmp_path, "--temperature", "0")
    np.testing.assert_array_equal(full_s, full_p)
    wav, sr = read_wav(str(tmp_path / "out.wav"))
    assert sr == 16000 and np.isfinite(wav).all()


@pytest.mark.parametrize("mode", ["exact", "stochastic"])
def test_tts_cli_spec_sampling(tmp_path, mode):
    full, gen = _tts_cli(tmp_path, "--top-k", "15", "--spec", "4",
                         "--spec-sampling", mode)
    assert full.shape[1] == 216 + gen.shape[1]


def test_tts_cli_refuses_fused_ffn_with_spec(tmp_path, capsys):
    with pytest.raises(SystemExit):
        _tts_cli(tmp_path, "--spec", "2", "--fused-ffn")
    assert "--fused-ffn applies to plain decoding" in capsys.readouterr().err


def test_edit_cli_spec_subprocess(tmp_path):
    out = tmp_path / "edited.wav"
    cmd = [sys.executable, str(REPO / "edit_torch_cli.py"), "--model",
           "tiny_test_mtp", "--random-init", "--device", "cpu", "--text-backend",
           "grapheme", "--wav", str(REPO / "demo" / "demo.wav"),
           "--mfa-csv", str(REPO / "demo" / "demo_alignment.csv"),
           "--orig-transcript", DEMO_TEXT,
           "--target-transcript", "the sound of waves over the river at dawn",
           "--edit-type", "substitution", "--top-k", "15", "--silence-tokens",
           "5", "7", "--spec", "3", "--spec-sampling", "stochastic",
           "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "decoder passes" in res.stderr
    wav, sr = read_wav(str(out))
    assert sr == 16000 and np.isfinite(wav).all() and wav.shape[1] > 16000


def test_edit_cli_spec_refuses_a_model_without_mtp_heads():
    import edit_torch_cli
    with pytest.raises(ValueError, match="mtp_heads"):
        edit_torch_cli.main([
            "--model", "tiny_test", "--random-init", "--device", "cpu",
            "--text-backend", "grapheme", "--wav", str(REPO / "demo" / "demo.wav"),
            "--mfa-csv", str(REPO / "demo" / "demo_alignment.csv"),
            "--orig-transcript", DEMO_TEXT,
            "--target-transcript", "the sound of waves over the river at dawn",
            "--edit-type", "substitution", "--spec", "2", "--out", "o.wav"])
