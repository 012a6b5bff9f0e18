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

--prompt-end-sec with --mfa-csv (or --snap-cutoff, which aligns the prompt
with the energy aligner) snaps the cut to a word boundary and cuts the
prompt transcript there (with --asr-model, from Whisper's word timestamps);
without --prompt-transcript, --asr-model (a local Whisper snapshot)
transcribes the prompt; --long synthesizes the target sentence by
sentence against the prompt.  --sample-batch-size N decodes N sampling
paths and keeps the first to finish (best-of-N); --spec TAU decodes
speculatively with TAU tokens per verified pass through the model's MTP
heads (--random-init gives a preset TAU - 1 random MTP head groups).
"""

import argparse
import logging
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True,
                    help=".pth bundle, HF snapshot dir, or preset name")
    ap.add_argument("--codec", default=None, help="audiocraft .th checkpoint")
    ap.add_argument("--prompt-wav", required=True)
    ap.add_argument("--prompt-transcript", default=None,
                    help="transcript of the prompt; omit to transcribe with "
                         "--asr-model (reference gradio_app.py whisper path)")
    ap.add_argument("--asr-model", default=None,
                    help="local Whisper snapshot dir for auto-transcription "
                         "and --snap-cutoff's word boundaries")
    ap.add_argument("--target-transcript", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--prompt-end-sec", type=float, default=-1.0,
                    help="cut the prompt at this time")
    ap.add_argument("--mfa-csv", default=None,
                    help="MFA alignment CSV of the prompt: snap "
                         "--prompt-end-sec to a word boundary and cut the "
                         "prompt transcript there")
    ap.add_argument("--snap-cutoff", action="store_true",
                    help="snap --prompt-end-sec to a word boundary found by "
                         "the in-process aligner (Whisper with --asr-model, "
                         "else the energy aligner; no MFA CSV needed)")
    ap.add_argument("--margin", type=float, default=0.04)
    ap.add_argument("--cutoff-tolerance", type=float, default=1.0)
    ap.add_argument("--long", action="store_true",
                    help="split the target transcript into sentences and "
                         "synthesize each against the prompt")
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
                    help="run the decode-step FFN through the fused CUDA "
                         "kernel (plain decoding only)")
    ap.add_argument("--sample-batch-size", type=int, default=1,
                    help="best-of-N: decode N sampling paths, keep the "
                         "first to finish")
    ap.add_argument("--spec", type=int, default=0, metavar="TAU",
                    help="speculative decoding with TAU tokens per verified "
                         "pass (the model needs TAU - 1 MTP head groups); "
                         "greedy output equals plain decoding's")
    ap.add_argument("--spec-sampling", default="exact",
                    choices=["exact", "stochastic"],
                    help="speculative verification: 'exact' (draws keyed "
                         "per token, greedy speed-up) or 'stochastic' "
                         "(speculative sampling, exact in distribution)")
    return ap


def snap_prompt_cutoff(args, sample_rate: int):
    """(prompt_end_sec, prompt_transcript) with the cut snapped to a word
    boundary of the --mfa-csv rows (every row, in file order) or of the
    in-process aligner's rows (align.py:align_words: Whisper's with
    --asr-model, else the energy aligner's), and the transcript cut after
    that row's word; unchanged when no boundary lies at or after the
    cut."""
    from voicecraft_tpu_torch.inference.tts import find_closest_word_boundary
    if args.mfa_csv:
        import csv
        with open(args.mfa_csv) as f:
            rows = [(r["Begin"], r["End"]) for r in csv.DictReader(f)]
    else:
        from voicecraft_tpu_torch.align import align_words
        from voicecraft_tpu_torch.utils import audio as au
        wav = au.load_audio(args.prompt_wav, sample_rate)
        rows = [(r["Begin"], r["End"]) for r in
                align_words(wav, sample_rate,
                            args.prompt_transcript.strip().lower(),
                            asr_model_path=args.asr_model,
                            device=args.device)]
    snapped, idx = find_closest_word_boundary(
        rows, args.prompt_end_sec, args.margin, args.cutoff_tolerance)
    if snapped is None:
        return args.prompt_end_sec, args.prompt_transcript
    logging.info("prompt cutoff snapped: %.2fs -> %.3fs", args.prompt_end_sec,
                 snapped)
    words = args.prompt_transcript.split(" ")
    return snapped, " ".join(words[:min(idx + 1, len(words))])


def run(argv=None):
    """The CLI on ``argv``; returns (full codes [K, T + Tg], generated
    codes [K, Tg])."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.fused_ffn and (args.spec > 1 or args.sample_batch_size > 1):
        ap.error("--fused-ffn applies to plain decoding; best-of-N and "
                 "speculative decoding run the unfused FFN")
    logging.basicConfig(level=logging.INFO)

    import dataclasses
    import torch
    from voicecraft_tpu_torch.data.phonemes import (build_vocab,
                                                    make_text_tokenizer,
                                                    phones_to_ids)
    from voicecraft_tpu_torch.inference.loader import load_codec, load_model
    from voicecraft_tpu_torch.inference.tts import (inference_tts,
                                                    inference_tts_batch,
                                                    inference_tts_spec)
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import (SamplingConfig,
                                                        VoiceCraft)
    from voicecraft_tpu_torch.utils import audio as au
    from voicecraft_tpu_torch.utils.transcribe import split_sentences

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but no CUDA device is available "
                 "(pass --device cpu to run on the CPU)")

    cfg, model, phn2num = load_model(args.model, args.random_init, args.seed,
                                     device)
    if args.spec > 1 and not hasattr(model, "mtp_heads"):
        if not args.random_init:
            ap.error("--spec needs a checkpoint with MTP heads")
        # the same random weights plus TAU - 1 MTP head groups, drawn last
        cfg = dataclasses.replace(cfg, n_mtp=args.spec - 1)
        model = VoiceCraft(cfg, device).init_weights(
            torch.Generator(device=device).manual_seed(args.seed)).eval()
    ccfg, codec = load_codec(args.codec, args.random_init, args.seed, device,
                             codebook_size=cfg.audio_vocab_size)

    if args.prompt_transcript is None:
        from voicecraft_tpu_torch.utils.transcribe import make_transcriber
        args.prompt_transcript = make_transcriber(
            args.asr_model, args.device).transcribe(
                au.load_audio(args.prompt_wav, 16000), 16000)
        logging.info("transcribed prompt: %s", args.prompt_transcript)

    if args.prompt_end_sec > 0 and (args.mfa_csv or args.snap_cutoff):
        args.prompt_end_sec, args.prompt_transcript = snap_prompt_cutoff(
            args, ccfg.sample_rate)

    tok = make_text_tokenizer(args.language, args.text_backend)
    targets = (split_sentences(args.target_transcript) if args.long
               else [args.target_transcript])
    phones = [tok.phonemize(args.prompt_transcript.strip() + " " + t.strip())
              for t in targets]
    if phn2num is None:
        phn2num = build_vocab(phones)
    xs = [np.asarray(phones_to_ids(p, phn2num), np.int32) for p in phones]
    logging.info("phonemized %d target(s) to %s symbols", len(xs),
                 [len(x) for x in xs])

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
                          silence_tokens=tuple(args.silence_tokens),
                          spec_sampling=args.spec_sampling)

    def synth(x, seed):
        if args.sample_batch_size > 1:
            return inference_tts_batch(model, x, codes, scfg,
                                       batch_size=args.sample_batch_size,
                                       seed=seed)[1]
        if args.spec > 1:
            _, gen, st = inference_tts_spec(model, x, codes, scfg,
                                            n_draft=args.spec, seed=seed,
                                            return_stats=True)
            logging.info("speculative decode: %d tokens in %d passes "
                         "(%.2f tokens/pass)", st["tokens"], st["passes"],
                         st["tokens_per_pass"])
            return gen
        return inference_tts(model, x, codes, scfg, seed=seed,
                             fused_ffn=args.fused_ffn)[1]

    t0 = time.time()
    # long form: each sentence against the prompt, seeds seed, seed + 1, ...
    gen = np.concatenate([synth(x, args.seed + i) for i, x in enumerate(xs)],
                         axis=1)
    full = np.concatenate([codes, gen], axis=1)
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


def main(argv=None) -> None:
    """The console script ``voicecraft-tts-torch`` (exit status 0)."""
    run(argv)


if __name__ == "__main__":
    main()
