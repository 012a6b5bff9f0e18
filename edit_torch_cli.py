#!/usr/bin/env python
"""Speech editing on the PyTorch port (voicecraft_tpu_torch), by default on a
CUDA card.

Regenerate the span of a recording that a transcript edit changes (random
weights at giga830M width, decode-step FFN through the fused kernel):

  python edit_torch_cli.py --model giga830M --random-init --fused-ffn \\
      --text-backend grapheme --wav demo/demo.wav \\
      --mfa-csv demo/demo_alignment.csv \\
      --orig-transcript "the sound of birds over the river at dawn" \\
      --target-transcript "the sound of waves over the river at dawn" \\
      --edit-type substitution --out /tmp/edited.wav

Smoke mode (no checkpoints, CPU; without --mfa-csv the energy aligner
finds the words):

  python edit_torch_cli.py --model tiny_test --random-init --device cpu \\
      --text-backend grapheme --wav demo/demo.wav \\
      --orig-transcript "the sound of birds over the river at dawn" \\
      --target-transcript "the sound of waves over the river at dawn" \\
      --edit-type substitution --top-k 15 --silence-tokens 5 7 \\
      --out /tmp/edited.wav

The edited word span comes from a diff of the transcripts
(``inference/editing.py:get_span``), its seconds from the word rows (an MFA
CSV, or ``align.py``'s: Whisper's word timestamps with --asr-model, else
the energy aligner, whose margins are widened to its p90 boundary error),
widened by --left/right-margin, clamped to [one codec
frame, the audio's end] and rounded to codec frames.  --spec TAU decodes
speculatively, TAU tokens per verified pass through the model's MTP heads
(a checkpoint trained with them, or the tiny_test_mtp preset with
--random-init); a model without them is refused, as edit_cli.py refuses
it.
"""

import argparse
import csv
import logging

import numpy as np


def read_mfa_csv(path):
    """The word rows of an MFA alignment CSV."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [r for r in rows if r.get("Type", "words") == "words"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True,
                    help=".pth bundle, HF snapshot dir, or preset name")
    ap.add_argument("--codec", default=None, help="audiocraft .th checkpoint")
    ap.add_argument("--wav", required=True)
    ap.add_argument("--orig-transcript", required=True)
    ap.add_argument("--target-transcript", required=True)
    ap.add_argument("--edit-type", required=True,
                    choices=["substitution", "insertion", "deletion"])
    ap.add_argument("--mfa-csv", default=None,
                    help="word-alignment CSV (Begin,End,Label,Type rows); "
                         "without it Whisper (--asr-model) or the energy "
                         "aligner finds the words")
    ap.add_argument("--out", required=True)
    ap.add_argument("--left-margin", type=float, default=0.08)
    ap.add_argument("--right-margin", type=float, default=0.08)
    # editing sampling defaults, as in edit_cli.py
    ap.add_argument("--top-k", type=int, default=-1)
    ap.add_argument("--top-p", type=float, default=0.8)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--stop-repetition", type=int, default=-1)
    ap.add_argument("--silence-tokens", type=int, nargs="*",
                    default=[1388, 1898, 131])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--language", default="en-us")
    ap.add_argument("--text-backend", default="auto",
                    choices=["auto", "phonemizer", "espeak", "grapheme"])
    ap.add_argument("--random-init", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no automatic "
                         "fallback to the CPU")
    ap.add_argument("--fused-ffn", action="store_true",
                    help="run the decode-step FFN through the fused CUDA "
                         "kernel (plain decoding only)")
    ap.add_argument("--spec", type=int, default=0, metavar="TAU",
                    help="speculative decoding with TAU tokens per verified "
                         "pass (the model needs TAU - 1 MTP head groups); "
                         "greedy output equals plain decoding's")
    ap.add_argument("--spec-sampling", default="exact",
                    choices=["exact", "stochastic"])
    ap.add_argument("--asr-model", default=None,
                    help="local Whisper snapshot dir: word timestamps for "
                         "the edit span when no --mfa-csv is given")
    return ap


def edit_interval(words, orig_transcript, target_transcript, edit_type,
                  left_margin, right_margin, audio_dur, frame_rate):
    """The codec-frame interval [start, end) that an edit regenerates, from
    the word rows of the original recording."""
    from voicecraft_tpu_torch.align import widen_margins_for_aligner
    from voicecraft_tpu_torch.inference.editing import (get_mask_interval,
                                                        get_span)
    orig_span, _ = get_span(orig_transcript.strip().lower(),
                            target_transcript.strip().lower(), edit_type)
    start_sec, end_sec = get_mask_interval(words, tuple(orig_span), edit_type)
    left, right, _ = widen_margins_for_aligner(words, left_margin, right_margin)
    start_sec = max(start_sec - left, 1.0 / frame_rate)
    end_sec = min(end_sec + right, audio_dur)
    interval = (round(start_sec * frame_rate), round(end_sec * frame_rate))
    logging.info("edit span: words %s -> %.2f..%.2fs -> frames %s",
                 orig_span, start_sec, end_sec, interval)
    return interval


def run(argv=None):
    """The CLI on ``argv``; returns the edited codes [K, T']."""
    ap = build_parser()
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch
    from voicecraft_tpu_torch.align import align_words
    from voicecraft_tpu_torch.data.phonemes import (build_vocab,
                                                    make_text_tokenizer,
                                                    phones_to_ids)
    from voicecraft_tpu_torch.inference.editing import inference_edit
    from voicecraft_tpu_torch.inference.loader import load_codec, load_model
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    from voicecraft_tpu_torch.utils import audio as au

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but no CUDA device is available "
                 "(pass --device cpu to run on the CPU)")

    cfg, model, phn2num = load_model(args.model, args.random_init, args.seed,
                                     device)
    ccfg, codec = load_codec(args.codec, args.random_init, args.seed, device,
                             codebook_size=cfg.audio_vocab_size)

    tok = make_text_tokenizer(args.language, args.text_backend)
    phones = tok.phonemize(args.target_transcript.strip())
    if phn2num is None:
        phn2num = build_vocab([phones])
    x = np.asarray(phones_to_ids(phones, phn2num), np.int32)

    wav = au.load_audio(args.wav, ccfg.sample_rate)
    codes = ec.encode_bucketed(codec, wav)[0]
    audio_dur = wav.shape[1] / ccfg.sample_rate

    if args.mfa_csv:
        words = read_mfa_csv(args.mfa_csv)
    else:
        words = align_words(wav, ccfg.sample_rate,
                            args.orig_transcript.strip().lower(),
                            asr_model_path=args.asr_model, device=args.device)
        logging.info("%s alignment: %s",
                     words[0].get("Source", "whisper") if words else "no",
                     [(r["Label"], r["Begin"], r["End"]) for r in words])
    interval = edit_interval(words, args.orig_transcript,
                             args.target_transcript, args.edit_type,
                             args.left_margin, args.right_margin, audio_dur,
                             cfg.encodec_sr)

    scfg = SamplingConfig(top_k=args.top_k if args.top_k > 0 else 0,
                          top_p=args.top_p, temperature=args.temperature,
                          stop_repetition=args.stop_repetition,
                          silence_tokens=tuple(args.silence_tokens),
                          spec_sampling=args.spec_sampling)
    stats = {}
    res = inference_edit(model, x, codes, [interval], scfg, seed=args.seed,
                         fused_ffn=args.fused_ffn, stats=stats,
                         spec=args.spec)
    logging.info("regenerated %s frames in %d decoder %s on %s",
                 stats["span_frames"], stats["steps"],
                 "passes" if args.spec > 1 else "forwards", device)
    out = ec.decode_bucketed(codec, res[None])[0]
    au.write_wav(args.out, out, ccfg.sample_rate)
    logging.info("wrote %s (%.2fs)", args.out, out.shape[-1] / ccfg.sample_rate)
    return res


def main(argv=None) -> None:
    """The console script ``voicecraft-edit-torch`` (exit status 0)."""
    run(argv)


if __name__ == "__main__":
    main()
