#!/usr/bin/env python
"""Zero-shot TTS on the PyTorch port (voicecraft_tpu_torch), by default on a
CUDA card.

Continue a voice prompt with new text (random weights at giga830M width,
decode-step FFN through the fused kernel):

  python tts_torch_cli.py --model giga830M --random-init --fused-ffn \\
      --text-backend grapheme --prompt-wav demo/demo.wav \\
      --prompt-transcript "the sound of birds over the river at dawn" \\
      --target-transcript "the river runs past the mill" --out /tmp/out.wav

Smoke mode (no checkpoints, CPU):

  python tts_torch_cli.py --model tiny_test --random-init --device cpu \\
      --text-backend grapheme --prompt-wav demo/demo.wav \\
      --prompt-transcript "the sound of birds over the river at dawn" \\
      --target-transcript "the river runs past the mill" --out /tmp/out.wav
"""

import argparse
import logging
import time

import numpy as np

# flags of tts_cli.py whose machinery the port does not have yet; each is
# refused, never silently ignored
NOT_YET_PORTED = ("spec", "sample_batch_size", "long", "mfa_csv",
                  "snap_cutoff", "asr_model")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True,
                    help=".pth bundle, HF snapshot dir, or preset name")
    ap.add_argument("--codec", default=None,
                    help="audiocraft .th checkpoint (not yet ported: use "
                         "--random-init)")
    ap.add_argument("--prompt-wav", required=True)
    ap.add_argument("--prompt-transcript", default=None)
    ap.add_argument("--target-transcript", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--prompt-end-sec", type=float, default=-1.0,
                    help="cut the prompt at this time")
    # sampling defaults per the reference README (post 03/2025)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--stop-repetition", type=int, default=3)
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
                    help="run the decode-step FFN through the fused CUDA kernel")
    # not yet ported (refused when given)
    ap.add_argument("--spec", type=int, default=0)
    ap.add_argument("--sample-batch-size", type=int, default=1)
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--mfa-csv", default=None)
    ap.add_argument("--snap-cutoff", action="store_true")
    ap.add_argument("--asr-model", default=None)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    for name in NOT_YET_PORTED:
        if getattr(args, name) != ap.get_default(name):
            ap.error(f"--{name.replace('_', '-')} is not yet ported to "
                     "voicecraft_tpu_torch")
    if args.prompt_transcript is None:
        ap.error("--prompt-transcript is required (transcription is not yet "
                 "ported)")
    logging.basicConfig(level=logging.INFO)

    import torch
    from voicecraft_tpu.data.phonemes import (build_vocab, make_text_tokenizer,
                                              phones_to_ids)
    from voicecraft_tpu.utils import audio as au
    from voicecraft_tpu_torch.inference.loader import load_codec, load_model
    from voicecraft_tpu_torch.inference.tts import inference_tts
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but no CUDA device is available "
                 "(pass --device cpu to run on the CPU)")

    cfg, model, phn2num = load_model(args.model, args.random_init, args.seed,
                                     device)
    ccfg, codec = load_codec(args.codec, args.random_init, args.seed, device,
                             codebook_size=cfg.audio_vocab_size)

    tok = make_text_tokenizer(args.language, args.text_backend)
    phones = tok.phonemize(args.prompt_transcript.strip() + " "
                           + args.target_transcript.strip())
    if phn2num is None:
        phn2num = build_vocab([phones])
    x = np.asarray(phones_to_ids(phones, phn2num), np.int32)
    logging.info("phonemized to %d symbols", len(x))

    wav = au.load_audio(args.prompt_wav, ccfg.sample_rate)
    if args.prompt_end_sec > 0:
        wav = wav[:, :int(args.prompt_end_sec * ccfg.sample_rate)]
    t0 = time.time()
    codes = ec.encode_bucketed(codec, wav)[0]
    logging.info("prompt: %.2fs -> %d frames (%.2fs encode)",
                 wav.shape[1] / ccfg.sample_rate, codes.shape[1],
                 time.time() - t0)

    scfg = SamplingConfig(top_k=args.top_k, top_p=args.top_p,
                          temperature=args.temperature,
                          stop_repetition=args.stop_repetition,
                          silence_tokens=tuple(args.silence_tokens))
    t0 = time.time()
    full, gen = inference_tts(model, x, codes, scfg, seed=args.seed,
                              fused_ffn=args.fused_ffn)
    dt = time.time() - t0
    gen_sec = gen.shape[1] / cfg.encodec_sr
    logging.info("generated %d frames (%.2fs audio) in %.2fs on %s",
                 gen.shape[1], gen_sec, dt, device)

    out = ec.decode_bucketed(codec, full[None])[0]
    au.write_wav(args.out, out, ccfg.sample_rate)
    gen_only = args.out.replace(".wav", "_gen_only.wav")
    gen_wav = (ec.decode_bucketed(codec, gen[None])[0] if gen.shape[1]
               else np.zeros(0, np.float32))
    au.write_wav(gen_only, gen_wav, ccfg.sample_rate)
    logging.info("wrote %s and %s", args.out, gen_only)
    return full, gen


if __name__ == "__main__":
    main()
