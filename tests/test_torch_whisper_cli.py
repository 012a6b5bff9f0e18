"""The CLIs' Whisper flags in the port against the JAX CLIs, on the CPU,
each pair on the same weights (tiny_test exported to a reference .pth
bundle, and a narrow audiocraft codec checkpoint) and the same tiny random
Whisper snapshot (tests/torch_whisper_helpers.py): tts_torch_cli.py
--asr-model without --prompt-transcript against tts_cli.py --platform cpu
(the same transcript; the same greedy codes under the tie-aware rule of
tests/test_torch_tts.py), and tts_batch_torch_cli.py --wer and
realedit_torch_cli.py --wer against tts_batch_cli.py and realedit_cli.py
(the same per-row WERs and mean).  The JAX CLIs run in process."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_codec_checkpoint import XP_CFG, _audiocraft_state
from test_torch_serving_cli import _edit_inputs
from torch_whisper_helpers import TEXT, make_tiny_whisper

REPO = Path(__file__).resolve().parents[1]
TIE_MARGIN = 1e-3
GREEDY = ["--temperature", "0", "--silence-tokens", "5", "7"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one thread each (see test_torch_spec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """(Whisper snapshot, model .pth, codec .th) shared by both CLIs."""
    import export_torch_cli
    root = tmp_path_factory.mktemp("assets")
    model = str(root / "tiny.pth")
    export_torch_cli.main(["--ckpt", "tiny_test", "--random-init", "--out",
                           model, "--device", "cpu"])
    # a codebook entry for every token the model emits (tiny_test's card,
    # its 3 special tokens included): the JAX codec's gather gives NaN
    # audio for a token past its codebook, the port's a zero vector
    xp = dict(XP_CFG, rvq={"n_q": 4, "bins": 131})
    codec = str(root / "codec.th")
    torch.save({"xp.cfg": xp, "best_state": {"model": _audiocraft_state(
        xp, "old")}}, codec)
    return make_tiny_whisper(str(root / "whisper")), model, codec


def _jax_main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__ + ".py", *argv])
    return module.main()


def test_tts_cli_transcribes_and_decodes_like_tts_cli(assets, tmp_path,
                                                      monkeypatch, caplog):
    import tts_cli
    import tts_torch_cli
    from voicecraft_tpu.inference import tts as jtts
    from voicecraft_tpu_torch.models import voicecraft as vc
    snap, model, codec = assets
    common = ["--model", model, "--codec", codec, "--asr-model", snap,
              "--prompt-wav", str(REPO / "demo" / "demo.wav"),
              "--text-backend", "grapheme",
              "--target-transcript", "the river runs past the mill", *GREEDY]
    caplog.set_level("INFO")
    step_logits = []
    sample = vc.sample

    def recording(generator, logits, *a, **kw):
        step_logits.append(logits.numpy().copy())
        return sample(generator, logits, *a, **kw)
    monkeypatch.setattr(vc, "sample", recording)
    full, gen = tts_torch_cli.run(common + [
        "--device", "cpu", "--out", str(tmp_path / "port.wav")])
    monkeypatch.setattr(vc, "sample", sample)
    port_lines = re.findall(r"transcribed prompt: (.*)", caplog.text)
    caplog.clear()

    got = {}
    inference_tts = jtts.inference_tts
    monkeypatch.setattr(jtts, "inference_tts", lambda *a, **kw: got.setdefault(
        "out", inference_tts(*a, **kw)))
    _jax_main(monkeypatch, tts_cli, common + [
        "--platform", "cpu", "--out", str(tmp_path / "jax.wav")])
    jax_lines = re.findall(r"transcribed prompt: (.*)", caplog.text)
    assert port_lines == jax_lines == [TEXT]

    jfull, jgen = got["out"]
    T = full.shape[1] - gen.shape[1]
    np.testing.assert_array_equal(full[:, :T], jfull[:, :T])   # the prompt
    n = min(gen.shape[1], jgen.shape[1])
    # gen[k, f] is step f + k's token of codebook k: the first differing
    # step must be a near-tie of the port's logits, else all must agree
    bad = [f + k for k, f in zip(*np.nonzero(gen[:, :n] != jgen[:, :n]))]
    if bad or gen.shape != jgen.shape:
        j = min(bad) if bad else n
        top2 = np.sort(step_logits[j], axis=-1)[:, -2:]
        margin = float(np.min(top2[:, 1] - top2[:, 0]))
        assert margin < TIE_MARGIN, f"divergence at step {j}, margin {margin}"
    assert n > 8


# tts_batch rows: prompt end (s) and the word where synthesis starts
BATCH_ROWS = [("the sound of birds over the river", 1.0, 2),
              ("birds sing at dawn by the mill", 1.4, 3),
              ("the river runs past the old mill", 0.8, 1)]


def _batch_manifest(tmp_path):
    path = tmp_path / "m.tsv"
    path.write_text("\n".join(
        ["audio\tname\ttext\tend\tx\tstart"]
        + [f"demo.wav\tr{i}.wav\t{t}\t{e}\t-\t{s}"
           for i, (t, e, s) in enumerate(BATCH_ROWS)]) + "\n")
    return path


def _wers(text):
    return [float(w) for w in re.findall(r"(?:row \d+|seed \d+) WER ([\d.]+)",
                                         text)], \
        re.findall(r"mean WER over (\d+ \w+): ([\d.]+)", text)


def test_tts_batch_wer_like_tts_batch_cli(assets, tmp_path, monkeypatch,
                                          caplog):
    import tts_batch_cli
    import tts_batch_torch_cli
    snap, model, codec = assets
    common = ["--model", model, "--codec", codec, "--text-backend",
              "grapheme", "--manifest", str(_batch_manifest(tmp_path)),
              "--audio-root", str(REPO / "demo"), "--lanes", "2", "--wer",
              "--asr-model", snap, *GREEDY]
    caplog.set_level("INFO")
    tts_batch_torch_cli.main(common + ["--device", "cpu", "--output-dir",
                                       str(tmp_path / "port")])
    port = _wers(caplog.text)
    caplog.clear()
    _jax_main(monkeypatch, tts_batch_cli, common + [
        "--platform", "cpu", "--output-dir", str(tmp_path / "jax")])
    want = _wers(caplog.text)
    assert port == want and len(port[0]) == 3 and port[1]
    assert 0 < min(port[0])


def test_realedit_wer_like_realedit_cli(assets, tmp_path, monkeypatch,
                                        caplog):
    import realedit_cli
    import realedit_torch_cli
    snap, model, codec = assets
    manifest, audio, align = _edit_inputs(tmp_path)
    common = ["--manifest", str(manifest), "--audio-dir", str(audio),
              "--align-dir", str(align), "--model", model, "--codec", codec,
              "--text-backend", "grapheme", "--wer", "--asr-model", snap,
              *GREEDY]
    caplog.set_level("INFO")
    realedit_torch_cli.main(common + ["--device", "cpu", "--out-dir",
                                      str(tmp_path / "port")])
    port = _wers(caplog.text)
    caplog.clear()
    _jax_main(monkeypatch, realedit_cli, common + [
        "--platform", "cpu", "--out-dir", str(tmp_path / "jax")])
    want = _wers(caplog.text)
    assert port == want and len(port[0]) == 2 and port[1]


def test_edit_cli_aligns_with_whisper(assets, tmp_path, caplog):
    """edit_torch_cli.py --asr-model without --mfa-csv: the span comes from
    Whisper's word rows (demo.wav tiled to 30.24 s, inside which the tiny
    snapshot's timestamps fall), and the log names the aligner."""
    import edit_torch_cli
    from voicecraft_tpu_torch.align import WhisperWordAligner
    from voicecraft_tpu_torch.utils import audio as au
    snap, model, codec = assets
    wav = np.tile(au.load_audio(str(REPO / "demo" / "demo.wav"), 16000),
                  (1, 7))
    path = str(tmp_path / "long.wav")
    au.write_wav(path, wav[0], 16000)
    caplog.set_level("INFO")
    res = edit_torch_cli.run([
        "--model", model, "--codec", codec, "--device", "cpu",
        "--text-backend", "grapheme", "--asr-model", snap, "--wav", path,
        "--orig-transcript", TEXT.strip(),
        "--target-transcript", "the sound of waves",
        "--edit-type", "substitution", "--top-k", "15",
        "--silence-tokens", "5", "7", "--out", str(tmp_path / "out.wav")])
    rows = WhisperWordAligner(snap, "cpu").align(au.load_audio(path, 16000),
                                                 16000)
    assert f"whisper alignment: {[(r['Label'], r['Begin'], r['End']) for r in rows]}" \
        in caplog.text
    assert "widening edit margins" not in caplog.text
    assert res.shape[0] == 4 and res.shape[1] > 0
