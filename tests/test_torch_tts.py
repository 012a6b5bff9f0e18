"""The whole zero-shot TTS slice of the port against the JAX package:
prefix composition, greedy decode (token-equal under the tie-aware rule),
and the CLI end to end on the demo fixture, all on the CPU."""

import csv
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.data import spans as jspans
from voicecraft_tpu.inference import tts as jtts
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu.ops import patterns as jpatterns
from voicecraft_tpu.utils.audio import read_wav
from voicecraft_tpu_torch.data import spans
from voicecraft_tpu_torch.inference import tts
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops import patterns
from voicecraft_tpu_torch.utils.audio import load_audio
from voicecraft_tpu_torch.utils.convert import from_jax_params
from voicecraft_tpu_torch.utils.transcribe import split_sentences

REPO = Path(__file__).resolve().parents[1]
TIE_MARGIN = 1e-3
DEMO_TEXT = "the sound of birds over the river at dawn"


def _cfg():
    return dataclasses.replace(tiny_test(), compute_dtype="float32")


def test_prefix_and_unshift_match_jax():
    cfg = _cfg()
    y = np.random.default_rng(0).integers(0, 128, (4, 25)).astype(np.int32)
    got, want = spans.compose_tts_prefix(y, cfg), jspans.compose_tts_prefix(y, cfg)
    assert got.length == want.length == 26          # T + 1 columns
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.mask_emb_idx, want.mask_emb_idx)
    np.testing.assert_array_equal(got.real, want.real)
    rows = np.random.default_rng(1).integers(0, 131, (4, 30))
    np.testing.assert_array_equal(patterns.unshift_span(rows),
                                  jpatterns.unshift_span(rows))


def test_greedy_tts_matches_jax_tie_aware(monkeypatch):
    """Greedy decode, port vs JAX on the same weights: tokens equal at every
    step until the first step whose top-2 logit margin (read from the
    port's own adjusted logits) is under TIE_MARGIN, where f32 summation
    order may legitimately flip the argmax."""
    cfg = _cfg()
    params = jvc.init_params(cfg, jax.random.PRNGKey(0))
    model = vc.VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), cfg))
    rng = np.random.default_rng(3)
    x = rng.integers(0, cfg.text_vocab_size, 8).astype(np.int32)
    y = rng.integers(0, cfg.audio_vocab_size, (4, 25)).astype(np.int32)
    sil = (5, 7)
    jscfg = jvc.SamplingConfig(temperature=0.0, silence_tokens=sil)
    scfg = vc.SamplingConfig(temperature=0.0, silence_tokens=sil)

    step_logits = []
    orig = vc.sample

    def recording_sample(generator, logits, *a, **kw):
        step_logits.append(logits.numpy().copy())
        return orig(generator, logits, *a, **kw)

    monkeypatch.setattr(vc, "sample", recording_sample)
    prefix = spans.compose_tts_prefix(y, cfg)
    got, got_spans = tts.run_decode(model, is_tts=True, x_tokens=x,
                                    prefix=prefix, n_spans=1, scfg=scfg,
                                    gen_max=128, return_raw=True)
    monkeypatch.setattr(vc, "sample", orig)
    want, want_spans = jtts.run_decode(params, cfg, is_tts=True, x_tokens=x,
                                       prefix=jspans.compose_tts_prefix(y, cfg),
                                       queue_mask_ids=[], n_spans=1, scfg=jscfg,
                                       gen_max=128, return_raw=True)
    assert len(step_logits) == len(got)
    assert not got_spans.any() and not want_spans.any()

    matched = 0
    for j in range(min(len(got), len(want))):
        if np.array_equal(got[j], want[j]):
            matched += 1
            continue
        top2 = np.sort(step_logits[j], axis=-1)[:, -2:]
        margin = float(np.min(top2[:, 1] - top2[:, 0]))
        assert margin < TIE_MARGIN, f"divergence at step {j}, margin {margin}"
        break
    else:
        assert len(got) == len(want)
        full, gen = tts.inference_tts(model, x, y, scfg, gen_max=128)
        jfull, jgen = jtts.inference_tts(params, cfg, x, y, jscfg, gen_max=128)
        np.testing.assert_array_equal(full, jfull)
        np.testing.assert_array_equal(gen, jgen)
    assert matched >= 10, f"only {matched} steps matched before divergence"


def test_cli_writes_finite_wav(tmp_path):
    out = tmp_path / "out.wav"
    cmd = [sys.executable, str(REPO / "tts_torch_cli.py"), "--model", "tiny_test",
           "--random-init", "--text-backend", "grapheme", "--device", "cpu",
           "--prompt-wav", str(REPO / "demo" / "demo.wav"),
           "--prompt-transcript", "the sound of birds over the river at dawn",
           "--target-transcript", "the river runs past the mill",
           "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    wav, sr = read_wav(str(out))
    assert sr == 16000 and wav.shape[1] > 4 * 16000
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0


def _cli_args(tmp_path, *extra):
    return ["--model", "tiny_test", "--random-init", "--device", "cpu",
            "--text-backend", "grapheme", "--top-k", "15",
            "--silence-tokens", "5", "7",
            "--prompt-wav", str(REPO / "demo" / "demo.wav"),
            "--prompt-transcript", DEMO_TEXT, "--out",
            str(tmp_path / "out.wav"), *extra]


def test_cli_long_form_two_sentences(tmp_path, caplog):
    """--long: each sentence is synthesized against the whole prompt and
    the generations are concatenated after it."""
    import tts_torch_cli
    caplog.set_level("INFO")
    full, gen = tts_torch_cli.main(_cli_args(
        tmp_path, "--long", "--target-transcript",
        "the river runs past the mill. birds sing at dawn!"))
    assert "phonemized 2 target(s)" in caplog.text
    T = full.shape[1] - gen.shape[1]
    assert T == 216 and gen.shape[1] > 0       # 4.32 s of prompt, 50 frames/s
    wav, sr = read_wav(str(tmp_path / "out.wav"))
    assert wav.shape[1] == full.shape[1] * 320 and np.isfinite(wav).all()


def _jax_snap(rows, cut, transcript, margin=0.04, tol=1.0):
    """tts_cli.py's snapping: the JAX boundary search, then the transcript
    cut after the boundary's row."""
    snapped, idx = jtts.find_closest_word_boundary(rows, cut, margin, tol)
    words = transcript.split(" ")
    return snapped, " ".join(words[:min(idx + 1, len(words))])


@pytest.mark.parametrize("cut", [1.3, 2.0, 3.2])
def test_cli_snaps_cutoff_to_mfa_csv_like_tts_cli(tmp_path, cut, caplog):
    import tts_torch_cli
    caplog.set_level("INFO")
    csv_path = REPO / "demo" / "demo_alignment.csv"
    with open(csv_path) as f:
        rows = [(r["Begin"], r["End"]) for r in csv.DictReader(f)]
    want_sec, want_text = _jax_snap(rows, cut, DEMO_TEXT)
    args = tts_torch_cli.build_parser().parse_args(_cli_args(
        tmp_path, "--mfa-csv", str(csv_path), "--prompt-end-sec", str(cut),
        "--target-transcript", "x"))
    assert tts_torch_cli.snap_prompt_cutoff(args, 16000) == (want_sec, want_text)
    assert want_sec != cut and len(want_text) < len(DEMO_TEXT)
    # and end to end: the prompt is cut at the snapped time
    full, gen = tts_torch_cli.main(_cli_args(
        tmp_path, "--mfa-csv", str(csv_path), "--prompt-end-sec", str(cut),
        "--target-transcript", "the river runs past the mill"))
    assert full.shape[1] - gen.shape[1] == -(-int(want_sec * 16000) // 320)
    assert "prompt cutoff snapped" in caplog.text


def test_cli_snap_cutoff_uses_energy_aligner_like_tts_cli(tmp_path):
    import tts_torch_cli
    from voicecraft_tpu import align as jalign
    wav = load_audio(str(REPO / "demo" / "demo.wav"), 16000)
    rows = [(r["Begin"], r["End"])
            for r in jalign.align_words(wav, 16000, DEMO_TEXT)]
    args = tts_torch_cli.build_parser().parse_args(_cli_args(
        tmp_path, "--snap-cutoff", "--prompt-end-sec", "2.0",
        "--target-transcript", "x"))
    got = tts_torch_cli.snap_prompt_cutoff(args, 16000)
    assert got == _jax_snap(rows, 2.0, DEMO_TEXT)
    assert got[0] > 2.0


def test_split_sentences_matches_jax():
    from voicecraft_tpu.utils.transcribe import split_sentences as jsplit
    text = "  One. Two!  Three?  four... five.Six  "
    assert split_sentences(text) == jsplit(text)
    assert split_sentences(text) == ["One.", "Two!", "Three?", "four...",
                                     "five.Six"]
