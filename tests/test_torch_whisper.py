"""The port's Whisper glue (utils/transcribe.py, align.py, the server's
--asr-model) against the JAX package's, on the CPU, on a tiny random
Whisper snapshot built offline (tests/torch_whisper_helpers.py): the
transcript string-equal to JAX's WhisperTranscriber's, mono and stereo;
the aligner's word rows equal to JAX's merge rule (voicecraft_tpu/align.py:
193-211) applied to the same ``generate`` output; align_words answering
from Whisper, and falling back to the energy aligner with a warning on a
snapshot that does not load; make_transcriber memoized and its error;
word_error_rate equal to JAX's on drawn pairs; and /edit without
"alignment" rows answered from Whisper's."""

import logging
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_whisper_helpers import TEXT, make_tiny_whisper

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    return make_tiny_whisper(str(tmp_path_factory.mktemp("whisper")))


def _wav(seconds=2.0, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((channels, int(seconds * 16000)))
            ).astype(np.float32)


@pytest.mark.parametrize("channels", [1, 2])
def test_transcript_equals_jax(snap, channels):
    from voicecraft_tpu.utils.transcribe import WhisperTranscriber as J
    from voicecraft_tpu_torch.utils.transcribe import WhisperTranscriber
    wav = _wav(channels=channels)
    wav = wav[0] if channels == 1 else wav
    got = WhisperTranscriber(snap, "cpu").transcribe(wav, 16000)
    assert got == J(snap).transcribe(wav, 16000) == TEXT


def test_aligner_rows_follow_jax_merge_rule(snap):
    """JAX's align() reads ``out.sequences``; transformers 4.57's generate
    returns a dict, so its generate is wrapped to hand the same output as
    attributes, and its own merge rule runs on it."""
    from voicecraft_tpu.align import WhisperWordAligner as J
    from voicecraft_tpu_torch.align import WhisperWordAligner
    wav = _wav(seconds=3.0)
    got = WhisperWordAligner(snap, "cpu").align(wav, 16000)
    jal = J(snap)
    generate = jal.model.generate

    def as_attributes(*a, **kw):
        out = generate(*a, **kw)
        return types.SimpleNamespace(sequences=out["sequences"],
                                     token_timestamps=out["token_timestamps"])
    jal.model.generate = as_attributes
    assert got == jal.align(wav, 16000)
    assert [r["Label"] for r in got] == TEXT.split()
    assert all(r["Type"] == "words" and r["Begin"] <= r["End"] for r in got)


def test_align_words_answers_from_whisper(snap):
    from voicecraft_tpu_torch.align import WhisperWordAligner, align_words
    wav = _wav()
    rows = align_words(wav, 16000, "one two three", asr_model_path=snap,
                       device="cpu")
    assert rows == WhisperWordAligner(snap, "cpu").align(wav, 16000)
    assert not any("Source" in r for r in rows)


def test_align_words_falls_back_on_a_snapshot_without_weights(
        snap, tmp_path, caplog):
    from voicecraft_tpu_torch.align import align_words, energy_align
    broken = tmp_path / "no_weights"
    shutil.copytree(snap, broken)
    (broken / "model.safetensors").unlink()
    wav = _wav()
    with caplog.at_level(logging.WARNING):
        rows = align_words(wav, 16000, "one two three",
                           asr_model_path=str(broken), device="cpu")
    assert rows == energy_align(wav, 16000, ["one", "two", "three"])
    assert "did not load" in caplog.text and str(broken) in caplog.text


def test_make_transcriber_memoized_and_needs_a_model(snap):
    from voicecraft_tpu_torch.utils.transcribe import make_transcriber
    assert make_transcriber(snap, "cpu") is make_transcriber(snap, "cpu")
    with pytest.raises(RuntimeError, match="--asr-model"):
        make_transcriber(None, "cpu")


WORDS = st.lists(st.sampled_from(["the", "a", "Sound", "of", "birds", "x"]),
                 max_size=7).map(" ".join)


@settings(max_examples=60, deadline=None, database=None)
@given(ref=WORDS, hyp=WORDS)
def test_word_error_rate_equals_jax(ref, hyp):
    from tts_batch_cli import word_error_rate as jwer
    from tts_batch_torch_cli import word_error_rate
    assert word_error_rate(ref, hyp) == jwer(ref, hyp)


def test_server_edit_without_alignment_uses_whisper_rows(snap):
    """serve_torch_cli.Engine with --asr-model, in process: an /edit with
    no "alignment" aligns the recording with Whisper (demo.wav tiled to
    30.24 s, inside which the tiny snapshot's timestamps fall), and its
    interval comes from the Whisper row of the substituted word."""
    import serve_torch_cli
    from voicecraft_tpu_torch.align import WhisperWordAligner
    from voicecraft_tpu_torch.utils import audio as au
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = serve_torch_cli.build_parser().parse_args([
            "--model", "tiny_test", "--random-init", "--device", "cpu",
            "--text-backend", "grapheme", "--asr-model", snap])
        eng = serve_torch_cli.Engine(args)
        wav = np.tile(au.load_audio(str(REPO / "demo" / "demo.wav"), 16000),
                      (1, 7))
        path = Path(snap).parent / "long.wav"
        au.write_wav(str(path), wav[0], 16000)
        import base64
        seen = []
        align = eng._align
        eng._align = lambda w, t: seen.append(align(w, t)) or seen[-1]
        r = eng.edit({"wav_b64": base64.b64encode(path.read_bytes()).decode(),
                      "orig_transcript": TEXT.strip(),
                      "target_transcript": "the sound of waves",
                      "edit_type": "substitution", "top_k": 15,
                      "silence_tokens": [5, 7]})
    finally:
        torch.set_num_threads(n)
    rows = WhisperWordAligner(snap, "cpu").align(au.load_audio(
        str(path), 16000), 16000)
    assert seen == [rows]
    s, e = r["edit_interval_frames"]
    birds = rows[3]
    assert s <= round(birds["Begin"] * 50) and round(birds["End"] * 50) <= e
    assert e <= wav.shape[1] // 320 + 1 and r["wav_b64"]
