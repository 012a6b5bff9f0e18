#!/usr/bin/env python
"""Offline preprocessing on the PyTorch port: a directory of <id>.wav +
<id>.txt transcript pairs, or an HF datasets dataset with audio and text
columns -> the phoneme/code manifest tree the trainer reads, with the
port's codec and phonemizer on a CUDA card by default; the counterpart of
preprocess_cli.py.

  python preprocess_torch_cli.py --audio-dir wavs/ --out-dir data/mydataset \\
      --codec encodec.th --split train
  python preprocess_torch_cli.py --hf-dataset path/to/local_dataset \\
      [--hf-subset NAME] --split train --out-dir data/mydataset --codec ...

--hf-dataset reads through datasets.load_dataset (a local directory, or
a name in a pre-populated cache: nothing is downloaded where there is no
network); its audio column is read undecoded and its WAV bytes decoded by
the port's own reader (any other format is an error that names it), the
id from segment_id or id, the text from text or transcript, as
preprocess_cli.py reads them.

Writes manifest/{split}.txt, vocab.txt, phonemes/<id>.txt and
encodec_16khz_4codebooks/<id>.txt in the reference's on-disk format.
--random-init encodes with a random codec (--codec-bins sets its codebook
size: the model's audio_vocab_size, e.g. 128 for tiny_test).
"""

import argparse
import io
import logging
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--audio-dir", default=None)
    ap.add_argument("--hf-dataset", default=None,
                    help="HF datasets name or local dataset directory "
                         "(offline: a local directory or a pre-populated "
                         "cache)")
    ap.add_argument("--hf-subset", default=None)
    ap.add_argument("--limit", type=int, default=None,
                    help="at most this many rows of --hf-dataset")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--codec", default=None, help="audiocraft .th checkpoint")
    ap.add_argument("--split", default="train")
    ap.add_argument("--language", default="en-us")
    ap.add_argument("--text-backend", default="auto",
                    choices=["auto", "phonemizer", "espeak", "grapheme"])
    ap.add_argument("--random-init", action="store_true")
    ap.add_argument("--codec-bins", type=int, default=None,
                    help="codebook size of a random codec (match the target "
                         "model's audio_vocab_size)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no automatic "
                         "fallback to the CPU")
    return ap


def iter_local_dir(audio_dir: str, sample_rate: int):
    """(id, transcript, wav [1, T]) of every <id>.wav with an <id>.txt."""
    from voicecraft_tpu_torch.utils import audio as au
    ids = sorted(os.path.splitext(f)[0] for f in os.listdir(audio_dir)
                 if f.endswith(".wav"))
    for uid in ids:
        txt_fn = os.path.join(audio_dir, uid + ".txt")
        if not os.path.exists(txt_fn):
            logging.warning("no transcript for %s, skipping", uid)
            continue
        with open(txt_fn) as f:
            text = f.read().strip()
        yield uid, text, au.load_audio(os.path.join(audio_dir, uid + ".wav"),
                                       sample_rate)


def _audio_format(data: bytes, path: str) -> str:
    """The container of encoded audio ``data``, by its magic bytes (else
    the extension of ``path``)."""
    for magic, name in ((b"fLaC", "FLAC"), (b"OggS", "Ogg"), (b"ID3", "MP3"),
                        (b"\xff\xfb", "MP3"), (b"\xff\xf3", "MP3")):
        if data.startswith(magic):
            return name
    ext = os.path.splitext(path or "")[1].lstrip(".")
    return ext.upper() or "an unknown format"


def iter_hf_dataset(name, subset, split, sample_rate, limit=None):
    """(id, transcript, wav [1, T]) of each row of an HF datasets dataset
    (a local directory reads offline), at most ``limit`` rows.  The audio
    column is read undecoded (decoding it needs torchcodec) and its WAV
    bytes (or the file its path names) decoded, downmixed and resampled by
    utils/audio.py, as the --audio-dir route reads a file; any other
    format raises ValueError naming it."""
    import datasets
    from voicecraft_tpu_torch.utils import audio as au
    ds = datasets.load_dataset(name, subset, split=split)
    if isinstance(ds.features.get("audio"), datasets.Audio):
        ds = ds.cast_column("audio", datasets.Audio(decode=False))
    for i, ex in enumerate(ds):
        if limit and i >= limit:
            break
        uid = str(ex.get("segment_id") or ex.get("id") or f"utt{i:08d}")
        text = ex.get("text") or ex.get("transcript") or ""
        audio = ex["audio"]
        data = audio.get("bytes")
        if data is None:
            with open(audio["path"], "rb") as f:
                data = f.read()
        if not (data[:4] == b"RIFF" and data[8:12] == b"WAVE"):
            raise ValueError(
                f"{uid}: its audio is {_audio_format(data, audio.get('path'))}"
                f", not WAV; the port decodes WAV only")
        yield uid, text, au.load_audio(io.BytesIO(data), sample_rate)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.audio_dir is None) == (args.hf_dataset is None):
        ap.error("pass exactly one of --audio-dir / --hf-dataset")
    if args.hf_dataset is not None:
        try:
            import datasets  # noqa: F401
        except ImportError:
            ap.error("--hf-dataset needs the datasets package, which is not "
                     "installed")
    logging.basicConfig(level=logging.INFO)

    from voicecraft_tpu_torch.config import giga830M
    from voicecraft_tpu_torch.data.manifest import write_manifest_tree
    from voicecraft_tpu_torch.data.phonemes import make_text_tokenizer
    from voicecraft_tpu_torch.inference.loader import load_codec
    from voicecraft_tpu_torch.models import encodec as ec

    ccfg, codec = load_codec(args.codec,
                             random_init=args.random_init or bool(args.codec_bins),
                             device=args.device,
                             codebook_size=args.codec_bins or 2048)
    tok = make_text_tokenizer(args.language, args.text_backend)
    if args.audio_dir:
        source = iter_local_dir(args.audio_dir, ccfg.sample_rate)
    else:
        source = iter_hf_dataset(args.hf_dataset, args.hf_subset, args.split,
                                 ccfg.sample_rate, args.limit)
    items = []
    for uid, text, wav in source:
        phones = tok.phonemize(text)
        codes = ec.encode_bucketed(codec, wav)[0]
        items.append({"id": uid, "phones": phones, "codes": codes.tolist()})
        logging.info("%s: %d phones, %d frames", uid, len(phones),
                     codes.shape[1])
    write_manifest_tree(args.out_dir, items, giga830M(), args.split)
    logging.info("wrote %d items to %s", len(items), args.out_dir)


if __name__ == "__main__":
    main()
