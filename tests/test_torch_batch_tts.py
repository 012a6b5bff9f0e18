"""Best-of-N TTS in the port against the JAX package, on the CPU: the batch
sampler (_batch_adjust_and_sample) on shared logits and shared draws,
greedy best-of-N against JAX's and against the port's own single-path
greedy, sampled best-of-N, and tts_torch_cli.py --sample-batch-size.  Both
packages run tiny_test in f32 on the same weights; the JAX batch loop is
compiled once."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.data import spans as jspans
from voicecraft_tpu.inference import tts as jtts
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu_torch.inference import tts
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.utils.audio import read_wav
from voicecraft_tpu_torch.utils.convert import from_jax_params

from tests.test_torch_spec import (  # noqa: F401  (one_torch_thread: autouse)
    REPO, DEMO_TEXT, assert_rows_tie_aware, one_torch_thread)

B = 3
SIL = (5, 7)


def _cfg(**kw):
    return dataclasses.replace(tiny_test(), compute_dtype="float32", **kw)


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


# ---- the batch sampler ---------------------------------------------------------

def _state(cfg, case, rng):
    """(logits [B, K, card], codebook_eog [K], cur_num_gen, consec [B],
    prev [B], y_pos, x_len, keep, draws [B, K]) of one forged step."""
    K, card = cfg.n_codebooks, cfg.card
    logits = rng.normal(0, 1, (B, K, card)).astype(np.float32)
    draws = rng.integers(0, cfg.audio_vocab_size, (B, K))
    eog = np.zeros(K, bool)
    cng, y_pos, x_len, keep = 20, 40, 10, -1
    consec = np.zeros(B, np.int64)
    prev = np.full(B, -1, np.int64)
    if case == "min_guard":
        cng = 3
        logits[:, :, cfg.eog] += 5.0            # eog would win everywhere
    elif case == "stops_last_hit_wins":
        draws[0, 0] = draws[2, 0] = cfg.eog
    elif case == "argmax_stop":
        logits[1, 0, cfg.eog] += 10.0
    elif case == "length_cap":
        y_pos = x_len * (cfg.encodec_sr // 5) + 1
    elif case == "cascade":
        eog[:2] = True
        keep = 1
    elif case == "silence_penalty":
        prev[:] = SIL[0]
        consec[:] = [5, 1, 7]
        logits[:, 0, SIL[0]] += 6.0
    elif case == "forced_empties":
        cng = 1
    return logits, eog, cng, consec, prev, y_pos, x_len, keep, draws


CASES = ["plain", "min_guard", "stops_last_hit_wins", "argmax_stop",
         "length_cap", "cascade", "silence_penalty", "forced_empties"]


@pytest.mark.parametrize("draw", ["shared_draws", "greedy"])
@pytest.mark.parametrize("case", CASES)
def test_batch_adjust_and_sample_matches_jax(case, draw, monkeypatch):
    """Both samplers on the same logits and state: with the same draws
    injected (the draw is each package's own RNG), or greedy (where the
    adjusted logits decide)."""
    cfg = _cfg(eos=131, n_special=4) if case == "plain" else _cfg()
    rng = np.random.default_rng(CASES.index(case))
    logits, eog, cng, consec, prev, y_pos, x_len, keep, draws = _state(cfg, case, rng)
    kw = dict(top_k=0, temperature=1.0 if draw == "shared_draws" else 0.0,
              stop_repetition=3, silence_tokens=SIL)
    if draw == "shared_draws":
        monkeypatch.setattr(jvc, "sample_tokens",
                            lambda *a, **k: jnp.asarray(draws, jnp.int32))
        monkeypatch.setattr(vc, "sample", lambda *a, **k: torch.from_numpy(draws))
    cap_mult = cfg.encodec_sr // 5
    want = jvc._batch_adjust_and_sample(
        cfg, jvc.SamplingConfig(**kw), cap_mult, jax.random.PRNGKey(0),
        jnp.asarray(logits), jnp.asarray(eog), jnp.asarray(cng),
        jnp.asarray(consec, jnp.int32), jnp.asarray(prev, jnp.int32),
        jnp.asarray(y_pos), jnp.asarray(x_len), jnp.asarray(keep))
    t = lambda v: torch.tensor(v)
    got = vc._batch_adjust_and_sample(
        cfg, vc.SamplingConfig(**kw), cap_mult, None, torch.from_numpy(logits),
        torch.from_numpy(eog), t(cng), torch.from_numpy(consec),
        torch.from_numpy(prev), t(y_pos), t(x_len), t(keep))
    for name, g, w in zip(("samples", "eog", "consec", "prev", "keep"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if case == "stops_last_hit_wins" and draw == "shared_draws":
        assert int(got[4]) == 2 and bool(got[1][0])
    if case == "cascade":
        assert int(got[4]) == 1 and got[1][:3].all()


# ---- the best-of-N loop --------------------------------------------------------

def _port_raw(model, x, y, scfg, monkeypatch):
    """The port's best-of-N rows of the kept path [n, K], and the adjusted
    logits of the kept path at each step."""
    logits = []
    orig = vc.sample

    def rec(generator, lg, *a, **kw):
        logits.append(lg.numpy().copy())
        return orig(generator, lg, *a, **kw)

    monkeypatch.setattr(vc, "sample", rec)
    _, plen, x_pad, y_pad, gen_max, (xt, yt, mi) = tts._tts_prompt(model, x, y, None)
    res = vc.make_batch_tts_loop(model.cfg, batch_size=B, x_pad=x_pad,
                                 y_pad=y_pad, gen_max=gen_max, scfg=scfg)(
        model, xt, len(x), yt, plen, mi, torch.Generator().manual_seed(0))
    monkeypatch.undo()
    assert len(logits) == res.gen_cnt == res.forwards
    return (res.gen_buf[:res.gen_cnt, res.keep].numpy(),
            [lg[res.keep] for lg in logits])


def test_greedy_best_of_n_matches_jax_and_single_path(setup, monkeypatch):
    """top_k = 1: every path follows the same trajectory, so the kept path
    is the single-path greedy output, and JAX's equals the port's under
    the tie-aware rule."""
    cfg, params, model, x, y = setup
    scfg = vc.SamplingConfig(top_k=1, silence_tokens=SIL)
    got, logits = _port_raw(model, x, y, scfg, monkeypatch)
    jscfg = jvc.SamplingConfig(top_k=1, silence_tokens=SIL)
    prefix = jspans.compose_tts_prefix(y, cfg)
    x_pad, y_pad, gen_max = tts.decode_geometry(cfg, len(x), prefix.length)
    xt = np.full((1, x_pad), cfg.text_pad_token, np.int32)
    xt[0, :len(x)] = x
    yt = np.full((1, cfg.n_codebooks, y_pad), cfg.empty_token, np.int32)
    yt[0, :, :prefix.length] = prefix.tokens
    gen_buf, gen_cnt, keep = jtts._get_batch_loop(cfg, B, x_pad, y_pad, gen_max,
                                                  jscfg)(
        params, jnp.asarray(xt), jnp.asarray(len(x), jnp.int32), jnp.asarray(yt),
        jnp.asarray(prefix.length, jnp.int32), jax.random.PRNGKey(0))
    want = np.asarray(gen_buf)[:int(gen_cnt), int(keep)]
    assert_rows_tie_aware(got, want, logits)
    _, gen1 = tts.inference_tts(model, x, y, scfg, seed=0)
    stats = {}
    full_b, gen_b = tts.inference_tts_batch(model, x, y, scfg, batch_size=B,
                                            seed=0, stats=stats)
    np.testing.assert_array_equal(gen_b, gen1)
    np.testing.assert_array_equal(full_b[:, :y.shape[1]], y)
    assert stats["keep"] == B - 1 and stats["prefill_len"] == x_pad + y_pad
    assert stats["steps"] == len(got)


def test_sampled_best_of_n_is_valid_and_deterministic(setup):
    cfg, _, model, x, y = setup
    scfg = vc.SamplingConfig(top_k=20, top_p=0.95, temperature=1.0,
                             stop_repetition=3, silence_tokens=SIL)
    full, gen = tts.inference_tts_batch(model, x, y, scfg, batch_size=4, seed=3)
    assert full.shape == (cfg.n_codebooks, y.shape[1] + gen.shape[1])
    np.testing.assert_array_equal(full[:, :y.shape[1]], y)
    assert gen.size == 0 or gen.max() < cfg.card
    np.testing.assert_array_equal(
        gen, tts.inference_tts_batch(model, x, y, scfg, batch_size=4, seed=3)[1])
    other = tts.inference_tts_batch(model, x, y, scfg, batch_size=4, seed=4)[1]
    assert other.shape != gen.shape or not np.array_equal(other, gen)


def test_special_first_best_of_n(setup):
    """special_first shifts the prompt into the vocabulary and back, as
    inference_tts does."""
    cfg, params, _, x, y = setup
    cfg_sf = dataclasses.replace(cfg, special_first=1)
    model = vc.VoiceCraft(cfg_sf, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), cfg))
    y = y % 120
    scfg = vc.SamplingConfig(top_k=1, silence_tokens=SIL)
    full_b, gen_b = tts.inference_tts_batch(model, x, y, scfg, batch_size=2, seed=0)
    full_1, gen_1 = tts.inference_tts(model, x, y, scfg, seed=0)
    np.testing.assert_array_equal(full_b, full_1)
    np.testing.assert_array_equal(full_b[:, :y.shape[1]], y)


# ---- tts_torch_cli.py --sample-batch-size ------------------------------------

def _cli(tmp_path, *extra):
    import tts_torch_cli
    return tts_torch_cli.main([
        "--model", "tiny_test", "--random-init", "--device", "cpu",
        "--text-backend", "grapheme", "--top-k", "15", "--silence-tokens", "5",
        "7", "--prompt-wav", str(REPO / "demo" / "demo.wav"),
        "--prompt-transcript", DEMO_TEXT, "--out", str(tmp_path / "out.wav"),
        *extra])


@pytest.mark.parametrize("long", [False, True], ids=["one", "long"])
def test_cli_sample_batch_size(tmp_path, long, caplog):
    caplog.set_level("INFO")
    text = ("the river runs past the mill. birds sing at dawn!" if long
            else "the river runs past the mill")
    full, gen = _cli(tmp_path, "--sample-batch-size", "3", "--target-transcript",
                     text, *(["--long"] if long else []))
    assert full.shape[1] == 216 + gen.shape[1]
    assert f"phonemized {2 if long else 1} target(s)" in caplog.text
    wav, sr = read_wav(str(tmp_path / "out.wav"))
    assert sr == 16000 and wav.shape[1] == full.shape[1] * 320
    assert np.isfinite(wav).all()


def test_cli_greedy_best_of_n_equals_single(tmp_path):
    full_b, _ = _cli(tmp_path, "--sample-batch-size", "2", "--top-k", "1",
                     "--target-transcript", "the river runs past the mill")
    full_1, _ = _cli(tmp_path, "--top-k", "1", "--target-transcript",
                     "the river runs past the mill")
    np.testing.assert_array_equal(full_b, full_1)


def test_cli_refuses_fused_ffn_with_best_of_n(tmp_path, capsys):
    with pytest.raises(SystemExit):
        _cli(tmp_path, "--sample-batch-size", "2", "--fused-ffn",
             "--target-transcript", "x")
    assert "--fused-ffn applies to plain decoding" in capsys.readouterr().err
