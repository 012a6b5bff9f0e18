#!/usr/bin/env python
"""Speculative-decoding acceptance on held-out data, on the PyTorch port;
the counterpart of spec_acceptance_cli.py.

Given a checkpoint with MTP heads trained on the procedural corpus
(recipes/make_spec_corpus.py -> preprocess_torch_cli.py -> train_torch_cli.py
--n-mtp), runs held-out prompts through

  1. single-stream speculative TTS (inference_tts_spec): tokens per pass
     from the loop's pass count, and the speed against the plain loop on
     the same prompts;
  2. speculative lockstep serving (make_spec_serving_loop): tokens per pass
     per lane over --lanes distinct prompts, against the plain lockstep
     loop (make_serving_tts_loop) on the same wave;
  3. the speculative continuous-batching engine (ContinuousBatcher(spec=
     tau)): frames per device pass, against the plain engine at the same
     burst.

--edit measures speech editing instead: a middle span of each held-out
utterance masked and regenerated through serve_edit_batch at B=1 and
B=--lanes, plain and speculative.  Greedy (temperature <= 0) speculative
output equals the plain loops', so acceptance is a property of the trained
heads alone.

Usage:
  python spec_acceptance_torch_cli.py --model EXP/ckpt_latest \\
      --eval-dir CORPUS/eval --codec-bins 2048 --taus 2 4 8 --n 16
"""

import argparse
import glob
import json
import logging
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True)
    ap.add_argument("--eval-dir", required=True)
    ap.add_argument("--codec", default=None)
    ap.add_argument("--codec-bins", type=int, default=None,
                    help="codebook size of a random codec (must match the "
                         "preprocessing run)")
    ap.add_argument("--taus", type=int, nargs="*", default=[2, 4, 8])
    ap.add_argument("--n", type=int, default=16,
                    help="held-out utterances for the single-stream pass")
    ap.add_argument("--lanes", type=int, default=8,
                    help="serving / engine lanes")
    ap.add_argument("--prompt-sec", type=float, default=2.0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (speculative output equals plain); > 0 "
                         "measures sampled acceptance (with --spec-sampling "
                         "stochastic)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--spec-sampling", default="exact",
                    choices=["exact", "stochastic"])
    ap.add_argument("--spec-draft-temperature", type=float, default=-1.0,
                    help="stochastic mode's draft temperature (< 0: the "
                         "sampling temperature)")
    ap.add_argument("--edit", action="store_true",
                    help="measure speech-editing acceptance instead of TTS "
                         "(serve_edit_batch at B=1 and B=--lanes)")
    ap.add_argument("--edit-span", type=float, nargs=2, default=[0.4, 0.7],
                    metavar=("FRAC_START", "FRAC_END"),
                    help="masked interval as fractions of the utterance")
    ap.add_argument("--skip-engine", action="store_true")
    ap.add_argument("--engine-burst", type=int, default=0,
                    help="engine burst (default 4 * tau)")
    ap.add_argument("--engine-requests", type=int, default=2,
                    help="submit N * lanes held-out requests to the engine "
                         "(cycled)")
    ap.add_argument("--skip-serving", action="store_true")
    ap.add_argument("--skip-single", action="store_true")
    ap.add_argument("--kv-fp8", action="store_true",
                    help="fp8 KV slab for serving and the engine")
    ap.add_argument("--fp8", action="store_true",
                    help="the weight-only fp8 decoder (utils/quantize.py)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no automatic "
                         "fallback to the CPU")
    return ap


def load_eval_items(eval_dir, codec, tok, phn2num, n, prompt_sec):
    from voicecraft_tpu_torch.data.phonemes import phones_to_ids
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.utils import audio as au
    ccfg = codec.cfg
    items = []
    for wav_path in sorted(glob.glob(os.path.join(eval_dir, "*.wav")))[:n]:
        with open(wav_path[:-4] + ".txt") as f:
            text = f.read().strip()
        wav = au.load_audio(wav_path, ccfg.sample_rate)
        codes = ec.encode_bucketed(codec, wav)[0].astype(np.int32)
        x = np.asarray(phones_to_ids(tok.phonemize(text), phn2num), np.int32)
        items.append({"x": x,
                      "prompt": codes[:, :int(prompt_sec * ccfg.frame_rate)],
                      "codes": codes, "id": os.path.basename(wav_path)})
    return items


def _ceil(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def run_edit_mode(args, model, items, scfg, results):
    """Editing acceptance: a middle span of each held-out utterance masked
    and regenerated, plain against speculative, at B=1 and B=lanes, in one
    serve_edit_batch geometry (pads) for every configuration; each runs
    twice, warm then measured."""
    from voicecraft_tpu_torch.inference.editing import fractional_edit_span
    from voicecraft_tpu_torch.inference.serving import serve_edit_batch

    cfg = model.cfg
    f0, f1 = args.edit_span
    kv_dtype = "float8_e4m3fn" if args.kv_fp8 else None
    ereqs = []
    for it in items:
        span = fractional_edit_span(it["codes"].shape[1], f0, f1)
        if span is not None:
            ereqs.append((it["x"], it["codes"], [span]))
    results["edit"] = {"span": [f0, f1], "n_items": len(ereqs)}
    if not ereqs:
        logging.warning("no eval utterance long enough for edit span (%s, "
                        "%s); skipping edit mode", f0, f1)
        results["edit"]["skipped"] = "no utterance long enough"
        return
    K = cfg.n_codebooks
    x_max = max(len(x) for x, _, _ in ereqs)
    y_max = max(c.shape[1] + 2 for _, c, _ in ereqs)
    gmax = max(int(np.ceil((e - s) * 1.5)) + 2 * K + 8
               for _, _, [(s, e)] in ereqs)
    pads = (_ceil(x_max, 32), _ceil(y_max, 64), _ceil(gmax, 128))

    def measure(B, tau):
        for _ in range(2):                     # warm, then measured
            stats: dict = {}
            serve_edit_batch(model, ereqs[:B], scfg, seed=1, pads=pads,
                             spec=tau, kv_dtype=kv_dtype, stats=stats)
        return stats

    for B, name in ((1, "edit_single"), (args.lanes, "edit_serving")):
        if len(ereqs) < B:
            logging.info("not enough items for B=%d, skipping %s", B, name)
            continue
        plain = measure(B, 0)
        plain_fps = plain["frames"] / plain["seconds"]
        results["edit"][name] = {"plain_frames_per_sec": plain_fps,
                                 "lanes": B}
        logging.info("%s plain B=%d: %.0f frames/s", name, B, plain_fps)
        for tau in args.taus:
            if tau - 1 > results["n_mtp"]:
                logging.info("skipping tau=%d (> n_mtp+1)", tau)
                continue
            st = measure(B, tau)
            fps = st["frames"] / st["seconds"]
            results["edit"][name][tau] = {
                "tokens_per_pass_per_lane": st["tok_per_pass"],
                "frames_per_sec": fps, "speedup_vs_plain": fps / plain_fps}
            logging.info("%s tau=%d B=%d: %.2f tok/pass/lane, %.0f frames/s "
                         "(%.2fx plain)", name, tau, B,
                         st["tok_per_pass"] or -1, fps, fps / plain_fps)


def run(args) -> dict:
    import torch
    from voicecraft_tpu_torch.data.phonemes import make_text_tokenizer
    from voicecraft_tpu_torch.inference.engine import ContinuousBatcher
    from voicecraft_tpu_torch.inference.loader import load_codec, load_model
    from voicecraft_tpu_torch.inference.serving import (
        make_serving_tts_loop, make_spec_serving_loop, tts_wave_inputs)
    from voicecraft_tpu_torch.inference.tts import (inference_tts,
                                                    inference_tts_spec)
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig

    cfg, model, phn2num = load_model(args.model, device=args.device)
    if phn2num is None:
        raise SystemExit("the checkpoint carries no phoneme vocabulary")
    n_mtp = len(getattr(model, "mtp_heads", None) or ())
    if n_mtp == 0:
        raise SystemExit("the checkpoint has no MTP heads (train_torch_cli.py "
                         "--n-mtp)")
    kv_dtype = "float8_e4m3fn" if args.kv_fp8 else None
    if args.fp8:
        from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
        model = quantize_decoder_fp8(model)
    _, codec = load_codec(args.codec, random_init=args.codec is None
                          and bool(args.codec_bins), device=args.device,
                          codebook_size=args.codec_bins or 2048)
    tok = make_text_tokenizer("en-us", "grapheme")
    items = load_eval_items(args.eval_dir, codec, tok, phn2num,
                            max(args.n, args.lanes * 2), args.prompt_sec)
    logging.info("loaded %d held-out items", len(items))
    scfg = SamplingConfig(top_k=args.top_k, top_p=1.0,
                          temperature=args.temperature, stop_repetition=3,
                          spec_sampling=args.spec_sampling,
                          spec_draft_temperature=args.spec_draft_temperature)
    results = {"n_mtp": n_mtp, "temperature": args.temperature,
               "spec_sampling": args.spec_sampling,
               "single": {}, "serving": {}, "engine": {}}
    if args.edit:
        run_edit_mode(args, model, items, scfg, results)
        return results

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize()

    # ---- the plain single-stream reference ----
    def run_single_plain():
        t0 = time.perf_counter()
        toks = 0
        for it in items[:args.n]:
            _, gen = inference_tts(model, it["x"], it["prompt"], scfg, seed=1)
            toks += gen.shape[1] + cfg.n_codebooks  # delayed rows incl. eog
        return toks, time.perf_counter() - t0

    if not args.skip_single:
        run_single_plain()                              # warm
        plain_toks, plain_dt = run_single_plain()
        results["single"]["plain_tokens_per_sec"] = plain_toks / plain_dt
        logging.info("plain single-stream: %d rows in %.2fs", plain_toks,
                     plain_dt)

    # ---- one serving wave, composed once, the same pads for plain and
    # speculative (the loops the serving layer builds, called directly) ----
    B = args.lanes
    reqs = [(items[i % len(items)]["x"], items[i % len(items)]["prompt"])
            for i in range(B)]
    (x_pad, y_pad, gen_max), wave = tts_wave_inputs(model, reqs)
    seeds = [1] * B
    geom = dict(batch_size=B, x_pad=x_pad, y_pad=y_pad, gen_max=gen_max,
                scfg=scfg, kv_dtype=kv_dtype)

    def timed_wave(loop):
        loop(model, *wave, seeds)                       # warm
        sync()
        t0 = time.perf_counter()
        res = loop(model, *wave, seeds)
        frames = int(sum(res.n_rows))                   # the host readback
        return res, frames, time.perf_counter() - t0

    def plain_serving_baseline():
        if "plain_frames_per_sec" not in results["serving"]:
            _, frames, dt = timed_wave(make_serving_tts_loop(cfg, **geom))
            results["serving"]["plain_frames_per_sec"] = frames / dt
            logging.info("plain serving B=%d: %.0f frames/s", B, frames / dt)
        return results["serving"]["plain_frames_per_sec"]

    def engine_requests():
        pool = [(it["x"], it["prompt"]) for it in items]
        return [pool[i % len(pool)] for i in range(args.engine_requests * B)]

    def run_engine(spec, burst):
        """A warm run of B requests, then the timed one.  Returns (frames,
        seconds, device passes)."""
        def make():
            return ContinuousBatcher(model, lanes=B, x_pad=x_pad, y_pad=y_pad,
                                     gen_max=gen_max, burst=burst, scfg=scfg,
                                     seed=1, spec=spec, kv_dtype=kv_dtype)
        warm = make()
        for x, y in engine_requests()[:B]:
            warm.submit(x, y)
        warm.run()
        eng = make()
        for x, y in engine_requests():
            eng.submit(x, y)
        sync()
        t0 = time.perf_counter()
        res = eng.run()
        dt = time.perf_counter() - t0
        return (sum(g.shape[1] for _, g in res.values()), dt,
                eng.stats["steps"])

    def plain_engine_baseline(burst):
        key = f"plain_frames_per_sec_burst{burst}"
        if key not in results["engine"]:
            frames, dt, _ = run_engine(0, burst)
            results["engine"][key] = frames / dt
            logging.info("plain engine B=%d burst=%d: %.0f frames/s", B,
                         burst, frames / dt)
        return results["engine"][key]

    for tau in args.taus:
        if tau - 1 > n_mtp:
            logging.info("skipping tau=%d (> n_mtp+1)", tau)
            continue
        if not args.skip_single:
            def run_single_spec():
                t0 = time.perf_counter()
                toks = passes = 0
                for it in items[:args.n]:
                    _, _, st = inference_tts_spec(
                        model, it["x"], it["prompt"], scfg, n_draft=tau,
                        seed=1, return_stats=True)
                    toks += st["tokens"]
                    passes += st["passes"]
                return toks, passes, time.perf_counter() - t0
            run_single_spec()                           # warm
            toks, passes, dt = run_single_spec()
            results["single"][tau] = {
                "tokens_per_pass": toks / max(passes, 1),
                "tokens_per_sec": toks / dt,
                "speedup_vs_plain": (toks / dt) / results["single"][
                    "plain_tokens_per_sec"]}
            logging.info("single tau=%d: %.2f tok/pass, %.0f tok/s (%.2fx "
                         "plain)", tau, toks / max(passes, 1), toks / dt,
                         results["single"][tau]["speedup_vs_plain"])
        if not args.skip_serving:
            plain_fps = plain_serving_baseline()
            res, frames, dt = timed_wave(
                make_spec_serving_loop(cfg, n_draft=tau, **geom))
            results["serving"][tau] = {
                "tokens_per_pass_per_lane": frames / max(res.steps, 1) / B,
                "frames_per_sec": frames / dt,
                "speedup_vs_plain": frames / dt / plain_fps}
            logging.info("serving tau=%d B=%d: %.2f tok/pass/lane, %.0f "
                         "frames/s", tau, B,
                         results["serving"][tau]["tokens_per_pass_per_lane"],
                         frames / dt)
        if not args.skip_engine:
            burst = args.engine_burst or 4 * tau
            plain_eng_fps = plain_engine_baseline(burst)
            frames, dt, passes = run_engine(tau, burst)
            results["engine"][tau] = {
                "burst": burst, "frames_per_pass": frames / max(passes, 1),
                "frames_per_sec": frames / dt,
                "speedup_vs_plain": frames / dt / plain_eng_fps}
            logging.info("engine tau=%d: %.2f frames/device-pass "
                         "(occupancy-inclusive), %.0f frames/s (%.2fx plain "
                         "engine)", tau, frames / max(passes, 1), frames / dt,
                         frames / dt / plain_eng_fps)
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    results = run(args)
    print(json.dumps(results, indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
