#!/usr/bin/env python
"""RealEdit batch speech editing on the PyTorch port (voicecraft_tpu_torch),
by default on a CUDA card.

Manifest TSV columns (header row): wav_fn, orig_transcript, new_transcript,
orig_masked_span, new_masked_span, type.  A row may edit several spans,
separated by "|" in orig_masked_span and type.  Word alignments are MFA
CSVs named <wav_fn stem>.csv in --align-dir.  Writes
<stem>_new_seed<seed>.wav for seeds --seed .. --seed + --num-seeds - 1.

With --lanes N > 1 the rows are decoded in lockstep waves of N distinct
edits (inference/serving.py serve_edit_batch); with --lanes 1 one at a time
(inference_edit).  --spec TAU decodes speculatively either way.  --wer
transcribes each output with a local Whisper snapshot (--asr-model) and
logs its word error rate against the new transcript, and the mean.

  python realedit_torch_cli.py --manifest RealEdit.txt --audio-dir wavs/ \\
      --align-dir alignments/ --model giga830M --random-init \\
      --text-backend grapheme --out-dir out/ --lanes 4

Smoke mode (no checkpoints, CPU):

  python realedit_torch_cli.py --manifest m.tsv --audio-dir demo \\
      --align-dir aligns/ --model tiny_test --random-init --device cpu \\
      --text-backend grapheme --out-dir /tmp/out --lanes 2
"""

import argparse
import csv
import logging
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--audio-dir", required=True)
    ap.add_argument("--align-dir", required=True)
    ap.add_argument("--model", required=True,
                    help=".pth bundle, HF snapshot dir, or preset name")
    ap.add_argument("--codec", default=None, help="audiocraft .th checkpoint")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--left-margin", type=float, default=0.08)
    ap.add_argument("--right-margin", type=float, default=0.08)
    ap.add_argument("--top-k", type=int, default=-1)
    ap.add_argument("--top-p", type=float, default=0.8)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--stop-repetition", type=int, default=-1)
    ap.add_argument("--silence-tokens", type=int, nargs="*",
                    default=[1388, 1898, 131])
    ap.add_argument("--spec", type=int, default=0, metavar="TAU",
                    help="speculative decoding with TAU tokens per verified "
                         "pass (the model needs TAU - 1 MTP head groups)")
    ap.add_argument("--lanes", type=int, default=1,
                    help="manifest rows decoded per lockstep wave")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--spec-sampling", default="exact",
                    choices=["exact", "stochastic"])
    ap.add_argument("--num-seeds", type=int, default=1,
                    help="one output per seed (<stem>_new_seed<n>.wav)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--language", default="en-us")
    ap.add_argument("--text-backend", default="auto",
                    choices=["auto", "phonemizer", "espeak", "grapheme"])
    ap.add_argument("--random-init", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no automatic "
                         "fallback to the CPU")
    ap.add_argument("--wer", action="store_true",
                    help="transcribe each output and report its WER against "
                         "the new transcript (needs --asr-model)")
    ap.add_argument("--asr-model", default=None,
                    help="local Whisper snapshot dir for --wer")
    return ap


def edit_intervals(row, words, audio_dur: float, sr: int,
                   left_margin: float, right_margin: float):
    """The row's sorted codec-frame intervals: each "|"-separated word span
    to seconds through the alignment's word rows, widened by the margins
    and clamped to the audio."""
    from voicecraft_tpu_torch.inference.editing import get_mask_interval
    intervals = []
    for ind_inter, edit_type in zip(row["orig_masked_span"].split("|"),
                                    row["type"].split("|")):
        span = tuple(int(v) for v in ind_inter.split(","))
        s_sec, e_sec = get_mask_interval(words, span, edit_type)
        s_sec = max(s_sec - left_margin, 1.0 / sr)
        e_sec = min(e_sec + right_margin, audio_dur)
        intervals.append((round(s_sec * sr), round(e_sec * sr)))
    return sorted(intervals)


def main(argv=None):
    """Returns {(row index, seed): edited codes [K, T']}."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.lanes < 1:
        ap.error("--lanes must be >= 1")
    logging.basicConfig(level=logging.INFO)

    import torch
    from voicecraft_tpu_torch.data.phonemes import (build_vocab,
                                                    make_text_tokenizer,
                                                    phones_to_ids)
    from voicecraft_tpu_torch.inference.editing import inference_edit
    from voicecraft_tpu_torch.inference.loader import load_codec, load_model
    from voicecraft_tpu_torch.inference.serving import serve_edit_batch
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
    os.makedirs(args.out_dir, exist_ok=True)
    with open(args.manifest) as f:
        rows = list(csv.DictReader(f, delimiter="\t"))[:args.limit]
    scfg = SamplingConfig(top_k=max(args.top_k, 0), top_p=args.top_p,
                          temperature=args.temperature,
                          stop_repetition=args.stop_repetition,
                          silence_tokens=tuple(args.silence_tokens),
                          spec_sampling=args.spec_sampling)

    # every row is prepared first (audio, codes, spans, phonemes); a row
    # whose files or alignment do not fit is reported and left out
    prepared = []
    for i, row in enumerate(rows):
        try:
            stem = os.path.splitext(row["wav_fn"])[0]
            wav = au.load_audio(os.path.join(args.audio_dir, row["wav_fn"]),
                                ccfg.sample_rate)
            with open(os.path.join(args.align_dir, stem + ".csv")) as f:
                words = [r for r in csv.DictReader(f)
                         if r.get("Type", "words") == "words"]
            intervals = edit_intervals(
                row, words, wav.shape[1] / ccfg.sample_rate, cfg.encodec_sr,
                args.left_margin, args.right_margin)
            phones = tok.phonemize(row["new_transcript"].strip())
        except (OSError, KeyError, ValueError, AssertionError) as e:
            logging.warning("[%d/%d] %s not prepared: %s", i + 1, len(rows),
                            row.get("wav_fn"), e)
            continue
        if phn2num is None:
            phn2num = build_vocab([phones])
        codes = ec.encode_bucketed(codec, wav)[0]
        prepared.append((i, stem,
                         np.asarray(phones_to_ids(phones, phn2num), np.int32),
                         codes, intervals))

    results, wers = {}, []
    for s in range(args.seed, args.seed + args.num_seeds):
        for lo in range(0, len(prepared), args.lanes):
            chunk = prepared[lo:lo + args.lanes]
            if args.lanes > 1:
                outs = serve_edit_batch(model, [(x, c, iv) for _, _, x, c, iv
                                                in chunk],
                                        scfg, seed=s, spec=args.spec)
            else:
                _, _, x, c, iv = chunk[0]
                outs = [inference_edit(model, x, c, iv, scfg, seed=s,
                                       spec=args.spec)]
            for (i, stem, _, _, iv), res in zip(chunk, outs):
                out = ec.decode_bucketed(codec, res[None])[0]
                au.write_wav(os.path.join(args.out_dir,
                                          f"{stem}_new_seed{s}.wav"),
                             out, ccfg.sample_rate)
                results[(i, s)] = res
                logging.info("[%d/%d] %s seed %d: spans %s -> %d frames "
                             "(wave of %d)", i + 1, len(rows),
                             rows[i]["wav_fn"], s, iv, res.shape[1],
                             len(chunk))
                if args.wer:
                    from tts_batch_torch_cli import word_error_rate
                    from voicecraft_tpu_torch.utils.transcribe import \
                        make_transcriber
                    hyp = make_transcriber(args.asr_model,
                                           args.device).transcribe(
                        out, ccfg.sample_rate)
                    w = word_error_rate(rows[i]["new_transcript"], hyp)
                    wers.append(w)
                    logging.info("  seed %d WER %.3f", s, w)
    logging.info("done: %d/%d rows edited", len(prepared), len(rows))
    if wers:
        logging.info("mean WER over %d outputs: %.4f", len(wers),
                     float(np.mean(wers)))
    return results


if __name__ == "__main__":
    main()
