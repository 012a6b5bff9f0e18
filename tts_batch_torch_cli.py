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
--spec or --kv-fp8) decodes as tts_torch_cli.py would, with --seed.  --wer
transcribes each generated wav with a local Whisper snapshot (--asr-model)
and logs its word error rate against the row's words from the start index,
and the mean.

  python tts_batch_torch_cli.py --model giga830M --random-init \\
      --text-backend grapheme --manifest m.tsv --audio-root /data \\
      --output-dir out/ --lanes 8 [--kv-fp8] [--fp8] [--spec 4 | auto] \
      [--wer --asr-model D]

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


def parse_manifest(path):
    """The manifest's rows: audio, out_name, text, prompt_end, start_ind."""
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f][1:]
    return [{"audio": r[0], "out_name": r[1], "text": r[2],
             "prompt_end": float(r[3]),
             "start_ind": int(r[5].split(",")[0])}
            for r in rows if len(r) >= 6 and r[0]]


def word_error_rate(ref: str, hyp: str) -> float:
    """Levenshtein WER between two transcripts (dependency-free)."""
    r, h = ref.lower().split(), hyp.lower().split()
    d = np.zeros((len(r) + 1, len(h) + 1), np.int32)
    d[:, 0] = np.arange(len(r) + 1)
    d[0, :] = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        for j in range(1, len(h) + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + (r[i - 1] != h[j - 1]))
    return float(d[-1, -1]) / max(len(r), 1)


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
    ap.add_argument("--spec", default="0", metavar="TAU|auto[:T1,T2..]",
                    help="speculative decoding with TAU tokens per verified "
                         "pass across lanes (the model needs TAU - 1 MTP "
                         "head groups; --random-init adds them); greedy "
                         "output equals plain decoding's.  'auto' picks the "
                         "mode of each wave with a throughput bandit over "
                         "{plain, tau=4, the model's full MTP depth} "
                         "(inference/autospec.py; plain without MTP "
                         "heads); 'auto:T1,T2' names the taus")
    ap.add_argument("--spec-sampling", default="exact",
                    choices=["exact", "stochastic"])
    ap.add_argument("--random-init", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no automatic "
                         "fallback to the CPU")
    ap.add_argument("--wer", action="store_true",
                    help="transcribe each output and report its WER "
                         "(needs --asr-model)")
    ap.add_argument("--asr-model", default=None,
                    help="local Whisper snapshot dir for --wer")
    return ap


def main(argv=None):
    """Returns [(full_codes, generated_codes)] per manifest row."""
    ap = build_parser()
    args = ap.parse_args(argv)
    auto = str(args.spec).strip().lower().startswith("auto")
    try:
        spec = 0 if auto else int(args.spec)
    except ValueError:
        ap.error(f"--spec takes an integer TAU or auto[:T1,T2..], got "
                 f"{args.spec!r}")
    if args.lanes < 1:
        ap.error("--lanes must be >= 1")
    logging.basicConfig(level=logging.INFO)

    import dataclasses
    import torch
    from voicecraft_tpu_torch.data.phonemes import (build_vocab,
                                                    make_text_tokenizer,
                                                    phones_to_ids)
    from voicecraft_tpu_torch.inference.autospec import resolve_spec_arg
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
    spec, autospec = resolve_spec_arg(args.spec, model)
    if auto and spec == 0:
        log.warning("--spec auto: the model has no MTP heads; plain waves")
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
        metas.append((i, row, prompt_wav,
                      " ".join(row["text"].split(" ")[row["start_ind"]:])))

    outs_all, wers = [], []
    t0 = time.time()
    for lo in range(0, len(reqs), args.lanes):
        wave = reqs[lo:lo + args.lanes]
        stats: dict = {}
        t_wave = time.time()
        mode = spec
        if len(wave) > 1 or spec > 1 or args.kv_fp8:
            # the bandit picks each wave's mode and learns from its
            # measured throughput
            mode = autospec.next_mode() if autospec is not None else spec
            outs = serve_tts_batch(
                model, wave, scfg, seed=args.seed,
                kv_dtype="float8_e4m3fn" if args.kv_fp8 else None, spec=mode,
                stats=stats)
            if autospec is not None:
                autospec.observe(mode, stats["frames"], stats["seconds"],
                                 tok_per_pass=stats["tok_per_pass"])
        else:
            # a lone plain request decodes as tts_torch_cli.py would
            x, y = wave[0]
            outs = [inference_tts(model, x, y, scfg, seed=args.seed,
                                  stats=stats)]
        log.info("wave %d..%d: %d frames in %.2fs (%d %s)%s", lo,
                 lo + len(wave) - 1, sum(g.shape[1] for _, g in outs),
                 time.time() - t_wave, stats["steps"],
                 "passes" if mode > 1 else "steps",
                 f", {stats['tok_per_pass']:.2f} tokens/pass per lane"
                 if mode > 1 else "")
        for (full, gen), (i, row, prompt_wav, to_syn) in zip(
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
            if args.wer:
                from voicecraft_tpu_torch.utils.transcribe import \
                    make_transcriber
                hyp = make_transcriber(args.asr_model, args.device).transcribe(
                    gen_wav, ccfg.sample_rate)
                w = word_error_rate(to_syn, hyp)
                wers.append(w)
                log.info("row %d WER %.3f (%r vs %r)", i, w, to_syn[:60],
                         hyp[:60])
        outs_all += outs
    if autospec is not None:
        log.info("autospec: %s", autospec.snapshot())
    log.info("%d rows in %.1fs", len(rows), time.time() - t0)
    if wers:
        log.info("mean WER over %d rows: %.4f", len(wers),
                 float(np.mean(wers)))
    return outs_all


if __name__ == "__main__":
    main()
