#!/usr/bin/env python
"""Offline preprocessing on the PyTorch port: a directory of <id>.wav +
<id>.txt transcript pairs -> the phoneme/code manifest tree the trainer
reads, with the port's codec and phonemizer on a CUDA card by default; the
counterpart of preprocess_cli.py.

  python preprocess_torch_cli.py --audio-dir wavs/ --out-dir data/mydataset \\
      --codec encodec.th --split train

Writes manifest/{split}.txt, vocab.txt, phonemes/<id>.txt and
encodec_16khz_4codebooks/<id>.txt in the reference's on-disk format.
--random-init encodes with a random codec (--codec-bins sets its codebook
size: the model's audio_vocab_size, e.g. 128 for tiny_test).
"""

import argparse
import logging
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--audio-dir", required=True)
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
    # not yet ported (refused when given): an HF dataset needs a download
    ap.add_argument("--hf-dataset", default=None)
    ap.add_argument("--hf-subset", default=None)
    ap.add_argument("--limit", type=int, default=None)
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


def main():
    ap = build_parser()
    args = ap.parse_args()
    if args.hf_dataset is not None:
        ap.error("--hf-dataset: not yet ported (an HF dataset needs a "
                 "download); pass a local --audio-dir")
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
    items = []
    for uid, text, wav in iter_local_dir(args.audio_dir, ccfg.sample_rate):
        phones = tok.phonemize(text)
        codes = ec.encode_bucketed(codec, wav)[0]
        items.append({"id": uid, "phones": phones, "codes": codes.tolist()})
        logging.info("%s: %d phones, %d frames", uid, len(phones),
                     codes.shape[1])
    write_manifest_tree(args.out_dir, items, giga830M(), args.split)
    logging.info("wrote %d items to %s", len(items), args.out_dir)


if __name__ == "__main__":
    main()
