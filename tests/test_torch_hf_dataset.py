"""preprocess_torch_cli.py --hf-dataset on the CPU, offline, over a local
parquet dataset written into a temporary directory (datasets 5: an Audio
column read undecoded, its WAV bytes decoded by the port's reader): the
same manifest tree as --audio-dir on the same wavs (ids from id or
segment_id, text from text or transcript, as preprocess_cli.py reads
them), --limit, the error that names a row's non-WAV format, and the
error without the datasets package."""

import sys
from pathlib import Path

import numpy as np
import pytest

from voicecraft_tpu_torch.utils import audio as au

REPO = Path(__file__).resolve().parents[1]
ROWS = [("utt_a", "the sound of birds", 16000, 1.2),
        ("utt_b", "over the river", 22050, 0.9),       # resampled to 16 kHz
        ("utt_c", "at dawn", 16000, 0.6)]

datasets = pytest.importorskip("datasets")


@pytest.fixture
def hf_cache(tmp_path, monkeypatch):
    """load_dataset's cache under the test's directory."""
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE",
                        str(tmp_path / "hf_cache"))


def _wavs(tmp_path):
    """The rows' wavs (cut from demo.wav, some at 22.05 kHz) and
    transcripts in an --audio-dir; returns the dir."""
    demo = au.load_audio(str(REPO / "demo" / "demo.wav"), 16000)
    d = tmp_path / "wavs"
    d.mkdir()
    for uid, text, sr, sec in ROWS:
        wav = au.resample(demo[:, :int(sec * 16000)], 16000, sr)
        au.write_wav(str(d / f"{uid}.wav"), wav[0], sr)
        (d / f"{uid}.txt").write_text(text)
    return d


def _dataset(tmp_path, wav_dir, id_col="id", text_col="text", extra=()):
    """A parquet dataset of the rows (and ``extra`` (id, text, bytes, path)
    rows) in a local directory; returns its path."""
    rows = [(uid, text, (wav_dir / f"{uid}.wav").read_bytes(), f"{uid}.wav")
            for uid, text, _, _ in ROWS] + list(extra)
    ds = datasets.Dataset.from_dict({
        id_col: [r[0] for r in rows], text_col: [r[1] for r in rows],
        "audio": [{"bytes": r[2], "path": r[3]} for r in rows]})
    ds = ds.cast_column("audio", datasets.Audio(decode=False))
    root = tmp_path / f"hf_{id_col}"
    (root / "data").mkdir(parents=True)
    ds.to_parquet(str(root / "data" / "train-00000-of-00001.parquet"))
    return root


def _run(out, *source):
    import preprocess_torch_cli
    preprocess_torch_cli.main([*source, "--out-dir", str(out), "--random-init",
                               "--codec-bins", "128", "--device", "cpu",
                               "--text-backend", "grapheme"])


def _tree(root):
    return {str(p.relative_to(root)): p.read_text()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


@pytest.mark.parametrize("id_col,text_col", [("id", "text"),
                                             ("segment_id", "transcript")])
def test_hf_dataset_manifest_equals_audio_dir(tmp_path, hf_cache, id_col,
                                              text_col):
    wav_dir = _wavs(tmp_path)
    _run(tmp_path / "from_dir", "--audio-dir", str(wav_dir))
    _run(tmp_path / "from_hf", "--hf-dataset",
         str(_dataset(tmp_path, wav_dir, id_col, text_col)))
    want = _tree(tmp_path / "from_dir")
    assert len([k for k in want if k.startswith("encodec")]) == len(ROWS)
    assert _tree(tmp_path / "from_hf") == want


def test_hf_dataset_limit(tmp_path, hf_cache):
    wav_dir = _wavs(tmp_path)
    _run(tmp_path / "out", "--hf-dataset", str(_dataset(tmp_path, wav_dir)),
         "--limit", "2")
    manifest = (tmp_path / "out" / "manifest" / "train.txt").read_text()
    assert [line.split("\t")[1] for line in manifest.splitlines()] == \
        ["utt_a", "utt_b"]


def test_non_wav_row_names_its_format(tmp_path, hf_cache):
    wav_dir = _wavs(tmp_path)
    root = _dataset(tmp_path, wav_dir, extra=[
        ("utt_d", "a flac row", b"fLaC" + bytes(64), "utt_d.flac")])
    with pytest.raises(ValueError, match="utt_d: its audio is FLAC, not WAV"):
        _run(tmp_path / "out", "--hf-dataset", str(root))


def test_without_datasets_the_cli_says_so(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(SystemExit):
        _run(tmp_path / "out", "--hf-dataset", "any/name")
    assert "needs the datasets package" in capsys.readouterr().err


def test_exactly_one_source(tmp_path, capsys):
    with pytest.raises(SystemExit):
        _run(tmp_path / "out")
    assert "exactly one of --audio-dir / --hf-dataset" in capsys.readouterr().err
