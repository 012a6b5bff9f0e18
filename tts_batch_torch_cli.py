#!/usr/bin/env python
"""Batch zero-shot TTS over a manifest on the PyTorch port
(voicecraft_tpu_torch), by default on a CUDA card: rows are decoded in
lockstep waves of --lanes distinct requests (inference/serving.py
serve_tts_batch), so a wave reads the weights once per step for all of its
rows.

Manifest: TSV with a header row, the reference layout:
  col 0: audio path (relative to --audio-root)
  col 1: output wav name
  col 2: transcript (prompt words + target words)
  col 3: prompt end time (seconds)
  col 5: "start_ind,..." - the word index where synthesis starts

Each row's prompt is its audio up to the prompt end; the whole transcript is
phonemized.  Writes gen_<name>_<i>_seed<seed>.wav and
concat_<name>_<i>_seed<seed>.wav.  Every lane of a wave is keyed on
(--seed, its lane); a lone plain request (a last wave of one row, without
--spec or --kv-fp8) decodes as tts_torch_cli.py would, with --seed.

  python tts_batch_torch_cli.py --model giga830M --random-init \\
      --text-backend grapheme --manifest m.tsv --audio-root /data \\
      --output-dir out/ --lanes 8 [--kv-fp8] [--fp8] [--spec 4]

Smoke mode (no checkpoints, CPU):

  python tts_batch_torch_cli.py --model tiny_test --random-init \\
      --device cpu --text-backend grapheme --manifest m.tsv \\
      --audio-root demo --output-dir /tmp/out --lanes 2
"""

import argparse
import logging
import os
import time

import numpy as np

log = logging.getLogger("voicecraft_tpu_torch.tts_batch")

# flags of tts_batch_cli.py whose machinery the port does not have yet; each
# is refused, never silently ignored
NOT_YET_PORTED = ("wer", "asr_model")


def parse_manifest(path):
    """The manifest's rows: audio, out_name, text, prompt_end, start_ind."""
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f][1:]
    return [{"audio": r[0], "out_name": r[1], "text": r[2],
             "prompt_end": float(r[3]),
             "start_ind": int(r[5].split(",")[0])}
            for r in rows if len(r) >= 6 and r[0]]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True,
                    help=".pth bundle, HF snapshot dir, or preset name")
    ap.add_argument("--codec", default=None, help="audiocraft .th checkpoint")
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--audio-root", default="")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--lanes", type=int, default=8,
                    help="rows decoded per lockstep wave")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.8)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--stop-repetition", type=int, default=-1)
    ap.add_argument("--silence-tokens", type=int, nargs="*",
                    default=[1388, 1898, 131])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--language", default="en-us")
    ap.add_argument("--text-backend", default="auto",
                    choices=["auto", "phonemizer", "espeak", "grapheme"])
    ap.add_argument("--kv-fp8", action="store_true",
                    help="the waves' KV slab in float8_e4m3fn")
    ap.add_argument("--fp8", action="store_true",
                    help="weight-only fp8 decoder (quantize_decoder_fp8)")
    ap.add_argument("--spec", default="0", metavar="TAU",
                    help="speculative decoding with TAU tokens per verified "
                         "pass across lanes (the model needs TAU - 1 MTP "
                         "head groups; --random-init adds them); greedy "
                         "output equals plain decoding's")
    ap.add_argument("--spec-sampling", default="exact",
                    choices=["exact", "stochastic"])
    ap.add_argument("--random-init", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no automatic "
                         "fallback to the CPU")
    # not yet ported (refused when given)
    ap.add_argument("--wer", action="store_true")
    ap.add_argument("--asr-model", default=None)
    return ap


def main(argv=None):
    """Returns [(full_codes, generated_codes)] per manifest row."""
    ap = build_parser()
    args = ap.parse_args(argv)
    for name in NOT_YET_PORTED:
        if getattr(args, name) != ap.get_default(name):
            ap.error(f"--{name.replace('_', '-')} is not yet ported to "
                     "voicecraft_tpu_torch (it needs a Whisper snapshot)")
    if str(args.spec).startswith("auto"):
        ap.error("--spec auto is not yet ported to voicecraft_tpu_torch "
                 "(it needs inference/autospec.py); give --spec TAU")
    try:
        spec = int(args.spec)
    except ValueError:
        ap.error(f"--spec takes an integer TAU, got {args.spec!r}")
    if args.lanes < 1:
        ap.error("--lanes must be >= 1")
    logging.basicConfig(level=logging.INFO)

    import dataclasses
    import torch
    from voicecraft_tpu_torch.data.phonemes import (build_vocab,
                                                    make_text_tokenizer,
                                                    phones_to_ids)
    from voicecraft_tpu_torch.inference.loader import load_codec, load_model
    from voicecraft_tpu_torch.inference.serving import serve_tts_batch
    from voicecraft_tpu_torch.inference.tts import inference_tts
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import (SamplingConfig,
                                                        VoiceCraft)
    from voicecraft_tpu_torch.utils import audio as au

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but no CUDA device is available "
                 "(pass --device cpu to run on the CPU)")
    cfg, model, phn2num = load_model(args.model, args.random_init, args.seed,
                                     device)
    if spec > 1 and not hasattr(model, "mtp_heads"):
        if not args.random_init:
            ap.error("--spec needs a checkpoint with MTP heads")
        # the same random weights plus TAU - 1 MTP head groups, drawn last
        cfg = dataclasses.replace(cfg, n_mtp=spec - 1)
        model = VoiceCraft(cfg, device).init_weights(
            torch.Generator(device=device).manual_seed(args.seed)).eval()
    if args.fp8:
        from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
        model = quantize_decoder_fp8(model, pack_qkv=True)
    ccfg, codec = load_codec(args.codec, args.random_init, args.seed, device,
                             codebook_size=cfg.audio_vocab_size)
    tok = make_text_tokenizer(args.language, args.text_backend)
    rows = parse_manifest(args.manifest)
    os.makedirs(args.output_dir, exist_ok=True)
    log.info("%d manifest rows, %d lanes, on %s", len(rows), args.lanes,
             device)

    scfg = SamplingConfig(top_k=max(args.top_k, 0), top_p=args.top_p,
                          temperature=args.temperature,
                          stop_repetition=args.stop_repetition,
                          silence_tokens=tuple(args.silence_tokens),
                          spec_sampling=args.spec_sampling)

    # every request is prepared first (host work), then decoded in waves
    reqs, metas = [], []
    for i, row in enumerate(rows):
        wav = au.load_audio(os.path.join(args.audio_root, row["audio"]),
                            ccfg.sample_rate)
        end = int(round(row["prompt_end"] * ccfg.sample_rate))
        prompt_wav = wav[:, :end] if end > 0 else wav
        codes = ec.encode_bucketed(codec, prompt_wav)[0]
        phones = tok.phonemize(row["text"].strip())
        if phn2num is None:
            phn2num = build_vocab([phones])
        reqs.append((np.asarray(phones_to_ids(phones, phn2num), np.int32),
                     codes))
        metas.append((i, row, prompt_wav))

    outs_all = []
    t0 = time.time()
    for lo in range(0, len(reqs), args.lanes):
        wave = reqs[lo:lo + args.lanes]
        stats: dict = {}
        t_wave = time.time()
        if len(wave) > 1 or spec > 1 or args.kv_fp8:
            outs = serve_tts_batch(
                model, wave, scfg, seed=args.seed,
                kv_dtype="float8_e4m3fn" if args.kv_fp8 else None, spec=spec,
                stats=stats)
        else:
            # a lone plain request decodes as tts_torch_cli.py would
            x, y = wave[0]
            outs = [inference_tts(model, x, y, scfg, seed=args.seed,
                                  stats=stats)]
        log.info("wave %d..%d: %d frames in %.2fs (%d %s)%s", lo,
                 lo + len(wave) - 1, sum(g.shape[1] for _, g in outs),
                 time.time() - t_wave, stats["steps"],
                 "passes" if spec > 1 else "steps",
                 f", {stats['tok_per_pass']:.2f} tokens/pass per lane"
                 if spec > 1 else "")
        for (full, gen), (i, row, prompt_wav) in zip(
                outs, metas[lo:lo + args.lanes]):
            name = row["out_name"]
            base = name[:-4] if name.endswith(".wav") else name
            gen_wav = (ec.decode_bucketed(codec, gen[None])[0] if gen.shape[1]
                       else np.zeros((0,), np.float32))
            au.write_wav(os.path.join(
                args.output_dir, f"gen_{base}_{i}_seed{args.seed}.wav"),
                gen_wav, ccfg.sample_rate)
            au.write_wav(os.path.join(
                args.output_dir, f"concat_{base}_{i}_seed{args.seed}.wav"),
                np.concatenate([prompt_wav[0], gen_wav]), ccfg.sample_rate)
        outs_all += outs
    log.info("%d rows in %.1fs", len(rows), time.time() - t0)
    return outs_all


if __name__ == "__main__":
    main()
