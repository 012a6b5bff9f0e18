"""The port's batch CLIs on the CPU: tts_batch_torch_cli.py (a manifest in
lockstep waves of --lanes) and realedit_torch_cli.py (RealEdit rows with
MFA CSVs), each against serve_tts_batch / serve_edit_batch called directly
on the same model, codec and requests, and the flags they refuse."""

import csv
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
DEMO_TEXT = "the sound of birds over the river at dawn"
SAMPLING = ["--top-k", "15", "--silence-tokens", "5", "7"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one thread each (see test_torch_spec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(seed=1):
    """The CLIs' model, codec and tokenizer for tiny_test, --random-init."""
    from voicecraft_tpu_torch.data.phonemes import make_text_tokenizer
    from voicecraft_tpu_torch.inference.loader import load_codec, load_model
    cfg, model, _ = load_model("tiny_test", True, seed, "cpu")
    _, codec = load_codec(None, True, seed, "cpu",
                          codebook_size=cfg.audio_vocab_size)
    return cfg, model, codec, make_text_tokenizer("en-us", "grapheme")


def _scfg():
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    return SamplingConfig(top_k=15, top_p=0.8, temperature=1.0,
                          stop_repetition=-1, silence_tokens=(5, 7))


# ---- tts_batch_torch_cli.py -----------------------------------------------------

# short transcripts keep the random model's length caps (and the test) short
TTS_ROWS = [("demo.wav", "a.wav", "the sound of the mill", 0.6),
            ("demo.wav", "b.wav", "the sound of a hill", 0.9),
            ("demo.wav", "c", "the sound of the sea", 1.2)]


def _manifest(tmp_path):
    path = tmp_path / "m.tsv"
    lines = ["audio\tname\ttext\tend\tx\tstart"]
    lines += [f"{a}\t{n}\t{t}\t{e}\t-\t8" for a, n, t, e in TTS_ROWS]
    path.write_text("\n".join(lines) + "\n")
    return path


def _tts_cli(tmp_path, *extra):
    import tts_batch_torch_cli
    return tts_batch_torch_cli.main([
        "--model", "tiny_test", "--random-init", "--device", "cpu",
        "--text-backend", "grapheme", "--manifest", str(_manifest(tmp_path)),
        "--audio-root", str(REPO / "demo"), "--output-dir",
        str(tmp_path / "out"), *SAMPLING, *extra])


def test_tts_batch_cli_equals_serve_tts_batch(tmp_path):
    """Three rows in waves of two: the first wave's outputs equal
    serve_tts_batch on the same wave, the lone last row inference_tts's
    (as tts_batch_cli.py routes it), and both wavs of every row are
    written."""
    from voicecraft_tpu_torch.data.phonemes import build_vocab, phones_to_ids
    from voicecraft_tpu_torch.inference.serving import serve_tts_batch
    from voicecraft_tpu_torch.inference.tts import inference_tts
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.utils import audio as au
    got = _tts_cli(tmp_path, "--lanes", "2")
    cfg, model, codec, tok = _stack()
    phones = [tok.phonemize(t) for _, _, t, _ in TTS_ROWS]
    vocab = build_vocab(phones[:1])
    wav = au.load_audio(str(REPO / "demo" / "demo.wav"), 16000)
    reqs = [(np.asarray(phones_to_ids(p, vocab), np.int32),
             ec.encode_bucketed(codec, wav[:, :int(round(e * 16000))])[0])
            for p, (_, _, _, e) in zip(phones, TTS_ROWS)]
    want = (serve_tts_batch(model, reqs[:2], _scfg(), seed=1)
            + [inference_tts(model, *reqs[2], _scfg(), seed=1)])
    assert len(got) == 3
    for (gf, gg), (wf, wg) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gg, wg)
    for i, (_, name, _, _) in enumerate(TTS_ROWS):
        base = name[:-4] if name.endswith(".wav") else name
        for kind in ("gen", "concat"):
            assert (tmp_path / "out" / f"{kind}_{base}_{i}_seed1.wav").exists()


@pytest.mark.parametrize("flags,spec,kv", [
    (["--kv-fp8", "--fp8"], 0, "float8_e4m3fn"),
    (["--spec", "3"], 3, None)])
def test_tts_batch_cli_wave_options_equal_serve_tts_batch(tmp_path, flags,
                                                          spec, kv):
    """--kv-fp8, --fp8 and --spec TAU reach serve_tts_batch: one wave of
    the three rows equals the direct call on the same model (fp8: its
    quantize_decoder_fp8; with --spec and --random-init, the preset rebuilt
    with TAU - 1 MTP head groups)."""
    import dataclasses
    from voicecraft_tpu_torch.data.phonemes import build_vocab, phones_to_ids
    from voicecraft_tpu_torch.inference.serving import serve_tts_batch
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import VoiceCraft
    from voicecraft_tpu_torch.utils import audio as au
    got = _tts_cli(tmp_path, "--lanes", "3", *flags)
    cfg, model, codec, tok = _stack()
    if spec:
        cfg = dataclasses.replace(cfg, n_mtp=spec - 1)
        model = VoiceCraft(cfg, "cpu").init_weights(
            torch.Generator().manual_seed(1)).eval()
    if "--fp8" in flags:
        from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
        model = quantize_decoder_fp8(model, pack_qkv=True)
    phones = [tok.phonemize(t) for _, _, t, _ in TTS_ROWS]
    vocab = build_vocab(phones[:1])
    wav = au.load_audio(str(REPO / "demo" / "demo.wav"), 16000)
    reqs = [(np.asarray(phones_to_ids(p, vocab), np.int32),
             ec.encode_bucketed(codec, wav[:, :int(round(e * 16000))])[0])
            for p, (_, _, _, e) in zip(phones, TTS_ROWS)]
    want = serve_tts_batch(model, reqs, _scfg(), seed=1, kv_dtype=kv,
                           spec=spec)
    assert len(got) == 3
    for (gf, gg), (wf, wg) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gg, wg)


@pytest.mark.parametrize("flags,message", [
    (["--spec", "fast"], "--spec takes an integer TAU or auto")])
def test_tts_batch_cli_refuses_flags_not_yet_ported(tmp_path, capsys, flags,
                                                    message):
    """A --spec that is neither TAU nor auto (--spec auto itself runs:
    tests/test_torch_autospec.py)."""
    with pytest.raises(SystemExit):
        _tts_cli(tmp_path, *flags)
    assert message in capsys.readouterr().err


def test_batch_clis_run_on_the_card_by_default(tmp_path, capsys):
    """Without --device they ask for CUDA and refuse to move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import realedit_torch_cli
    import tts_batch_torch_cli
    with pytest.raises(SystemExit):
        tts_batch_torch_cli.main([
            "--model", "tiny_test", "--random-init", "--manifest",
            str(_manifest(tmp_path)), "--output-dir", str(tmp_path / "o")])
    with pytest.raises(SystemExit):
        realedit_torch_cli.main([
            "--model", "tiny_test", "--random-init", "--manifest", "m.tsv",
            "--audio-dir", ".", "--align-dir", ".", "--out-dir",
            str(tmp_path / "o")])
    assert capsys.readouterr().err.count("no CUDA device is available") == 2


# ---- realedit_torch_cli.py ------------------------------------------------------

EDIT_ROWS = [  # wav_fn, new transcript, word spans, edit types
    ("a.wav", "the sound of waves at dawn", "3,3", "substitution"),
    ("b.wav", "the song of birds at the lake", "1,1|6,6",
     "substitution|substitution")]


def _edit_inputs(tmp_path):
    audio, align = tmp_path / "audio", tmp_path / "align"
    audio.mkdir()
    align.mkdir()
    with open(REPO / "demo" / "demo_alignment.csv") as f:
        words = list(csv.DictReader(f))
    for wav_fn, *_ in EDIT_ROWS:
        shutil.copy(REPO / "demo" / "demo.wav", audio / wav_fn)
        with open(align / (Path(wav_fn).stem + ".csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(words[0]))
            w.writeheader()
            w.writerows(words)
    manifest = tmp_path / "realedit.tsv"
    lines = ["wav_fn\torig_transcript\tnew_transcript\torig_masked_span\t"
             "new_masked_span\ttype"]
    lines += [f"{fn}\t{DEMO_TEXT}\t{new}\t{span}\t{span}\t{typ}"
              for fn, new, span, typ in EDIT_ROWS]
    manifest.write_text("\n".join(lines) + "\n")
    return manifest, audio, align


def _edit_cli(tmp_path, *extra):
    import realedit_torch_cli
    manifest, audio, align = _edit_inputs(tmp_path)
    return realedit_torch_cli.main([
        "--manifest", str(manifest), "--audio-dir", str(audio),
        "--align-dir", str(align), "--model", "tiny_test", "--random-init",
        "--device", "cpu", "--text-backend", "grapheme", "--out-dir",
        str(tmp_path / "out"), *SAMPLING, *extra])


def test_realedit_cli_equals_serve_edit_batch(tmp_path):
    """Two RealEdit rows (one span, two spans) in one wave, two seeds: each
    output equals serve_edit_batch on the same requests, and is written."""
    import realedit_torch_cli
    from voicecraft_tpu_torch.data.phonemes import build_vocab, phones_to_ids
    from voicecraft_tpu_torch.inference.serving import serve_edit_batch
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.utils import audio as au
    got = _edit_cli(tmp_path, "--lanes", "2", "--num-seeds", "2")
    cfg, model, codec, tok = _stack()
    wav = au.load_audio(str(REPO / "demo" / "demo.wav"), 16000)
    codes = ec.encode_bucketed(codec, wav)[0]
    with open(REPO / "demo" / "demo_alignment.csv") as f:
        words = [r for r in csv.DictReader(f) if r["Type"] == "words"]
    phones = [tok.phonemize(new) for _, new, _, _ in EDIT_ROWS]
    vocab = build_vocab(phones[:1])
    reqs = []
    for (_, _, span, typ), p in zip(EDIT_ROWS, phones):
        row = {"orig_masked_span": span, "type": typ}
        iv = realedit_torch_cli.edit_intervals(
            row, words, wav.shape[1] / 16000, cfg.encodec_sr, 0.08, 0.08)
        reqs.append((np.asarray(phones_to_ids(p, vocab), np.int32), codes, iv))
    assert [len(iv) for _, _, iv in reqs] == [1, 2]
    for seed in (1, 2):
        want = serve_edit_batch(model, reqs, _scfg(), seed=seed)
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[(i, seed)], w)
            stem = Path(EDIT_ROWS[i][0]).stem
            assert (tmp_path / "out" / f"{stem}_new_seed{seed}.wav").exists()
