#!/usr/bin/env python
"""ASR-free output-quality harness on the PyTorch port; the counterpart of
quality_cli.py.

Synthesizes held-out transcripts of a corpus whose ground-truth waveforms
are known (recipes/make_spec_corpus.py) and scores the generated audio
against them: DTW-aligned log-mel distance, MCD and the duration ratio,
per decode mode, with the codec's resynthesis as the floor.  The
speculative and streaming modes are checked bit-exact against the plain
decode in the same run.

Modes:
  resynth     codec round trip of the ground-truth continuation (floor)
  plain       greedy TTS (temperature 0)
  spec        greedy speculative TTS (inference_tts_spec) + bit-exact check
  stream      the streaming engine (stream_tts) + bit-exact check vs plain
  fp8         the weight-only fp8 decoder, greedy
  sampled     the plain loop at --temperature
  stochastic  speculative stochastic sampling at --temperature
  edit        greedy speech editing: --edit-span of each utterance masked
              and regenerated, the whole utterance and the span scored
  edit_spec   greedy speculative editing + bit-exact check vs edit
  edit_stoch  stochastic speculative editing at --temperature

Usage:
  python quality_torch_cli.py --model EXP/ckpt_latest --eval-dir CORPUS/eval \\
      --codec-bins 2048 --n 8 --modes resynth plain spec fp8
"""

import argparse
import glob
import json
import logging
import os
import time

import numpy as np

ALL_MODES = ("resynth", "plain", "spec", "stream", "fp8", "sampled",
             "stochastic", "edit", "edit_spec", "edit_stoch")
EDIT_MODES = ("edit", "edit_spec", "edit_stoch")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True,
                    help="trainer checkpoint dir, .pth bundle or HF snapshot "
                         "dir (it must carry a phoneme vocabulary)")
    ap.add_argument("--eval-dir", required=True)
    ap.add_argument("--codec", default=None)
    ap.add_argument("--codec-bins", type=int, default=None,
                    help="codebook size of a random codec (must match the "
                         "preprocessing run)")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--prompt-sec", type=float, default=2.0)
    ap.add_argument("--min-sec", type=float, default=0.0,
                    help="skip eval utterances shorter than this; a "
                         "continuation much shorter than the prompt "
                         "measures nothing (e.g. --min-sec 4)")
    ap.add_argument("--modes", nargs="*", default=list(ALL_MODES),
                    choices=list(ALL_MODES))
    ap.add_argument("--edit-span", type=float, nargs=2, default=[0.4, 0.7],
                    help="fractional (start, end) of each utterance to mask "
                         "and regenerate for the edit modes")
    ap.add_argument("--tau", type=int, default=None,
                    help="draft count for the speculative modes (default: "
                         "the checkpoint's full MTP depth)")
    ap.add_argument("--temperature", type=float, default=0.8,
                    help="sampling temperature for sampled / stochastic")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--ref", default="auto", choices=["auto", "gt", "resynth"],
                    help="scoring reference: 'gt' the raw ground truth (a "
                         "real codec); 'resynth' the codec round trip of the "
                         "ground-truth codes (a random codec); 'auto' "
                         "resynth with --codec-bins, else gt")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no automatic "
                         "fallback to the CPU")
    return ap


def run(args):
    """Returns (results, codes): the JSON results, and each mode's
    generated codes per utterance id (for divergence analysis)."""
    from voicecraft_tpu_torch.data.phonemes import (make_text_tokenizer,
                                                    phones_to_ids)
    from voicecraft_tpu_torch.inference.loader import load_codec, load_model
    from voicecraft_tpu_torch.inference.tts import (inference_tts,
                                                    inference_tts_spec)
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    from voicecraft_tpu_torch.utils import audio as au
    from voicecraft_tpu_torch.utils.quality import (duration_ratio,
                                                    log_mel_distance, mcd)

    cfg, model, phn2num = load_model(args.model, device=args.device)
    if phn2num is None:
        raise SystemExit("the checkpoint carries no phoneme vocabulary")
    n_mtp = len(getattr(model, "mtp_heads", None) or ())
    tau = args.tau or (n_mtp + 1 if n_mtp else 0)
    if n_mtp and tau > n_mtp + 1:
        logging.warning("clamping --tau %d to the checkpoint's MTP depth %d",
                        tau, n_mtp + 1)
        tau = n_mtp + 1
    modes = list(args.modes)
    for m in ("spec", "stochastic", "edit_spec", "edit_stoch"):
        if m in modes and (n_mtp == 0 or tau < 2):
            logging.warning("dropping mode %s: checkpoint has no MTP heads", m)
            modes.remove(m)
    tts_modes = [m for m in modes if m not in EDIT_MODES]
    edit_modes = [m for m in modes if m in EDIT_MODES]

    # --codec, or a random codec of --codec-bins entries
    ccfg, codec = load_codec(args.codec, random_init=args.codec is None
                             and bool(args.codec_bins), device=args.device,
                             codebook_size=args.codec_bins or 2048)
    tok = make_text_tokenizer("en-us", "grapheme")
    model_fp8 = None
    if "fp8" in modes:
        from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
        model_fp8 = quantize_decoder_fp8(model)

    greedy = SamplingConfig(top_k=0, top_p=1.0, temperature=0.0,
                            stop_repetition=3)
    sampled = SamplingConfig(top_k=args.top_k, top_p=args.top_p,
                             temperature=args.temperature, stop_repetition=3)
    stoch = SamplingConfig(top_k=args.top_k, top_p=args.top_p,
                           temperature=args.temperature, stop_repetition=3,
                           spec_sampling="stochastic")

    items = []
    for wav_path in sorted(glob.glob(os.path.join(args.eval_dir, "*.wav"))):
        if len(items) >= args.n:
            break
        with open(wav_path[:-4] + ".txt") as f:
            text = f.read().strip()
        wav = au.load_audio(wav_path, ccfg.sample_rate)
        if wav.shape[-1] < args.min_sec * ccfg.sample_rate:
            continue
        codes = ec.encode_bucketed(codec, wav)[0].astype(np.int32)
        x = np.asarray(phones_to_ids(tok.phonemize(text), phn2num), np.int32)
        p_frames = int(args.prompt_sec * ccfg.frame_rate)
        flat = np.asarray(wav).reshape(-1)
        items.append({
            "x": x, "prompt": codes[:, :p_frames],
            "gt_cont_codes": codes[:, p_frames:],
            "gt_cont_wav": flat[int(args.prompt_sec * ccfg.sample_rate):],
            "codes": codes, "gt_wav": flat, "id": os.path.basename(wav_path)})
    ref_kind = args.ref
    if ref_kind == "auto":
        ref_kind = ("resynth" if (args.codec is None and args.codec_bins)
                    else "gt")
    logging.info("scoring %d held-out utterances, modes=%s, tau=%d, ref=%s",
                 len(items), modes, tau, ref_kind)

    def decode_audio(gen_codes):
        return ec.decode_bucketed(codec,
                                  np.asarray(gen_codes)[None])[0].reshape(-1)

    def gen_for(mode, it):
        """-> (audio, generated codes)"""
        x, prompt, seed = it["x"], it["prompt"], args.seed
        if mode == "resynth":
            return decode_audio(it["gt_cont_codes"]), it["gt_cont_codes"]
        if mode == "stream":
            from voicecraft_tpu_torch.inference.streaming import stream_tts
            chunks = list(stream_tts(model, x, prompt, greedy, seed=seed,
                                     codec=codec))
            audio = np.concatenate([c["audio"] for c in chunks
                                    if "audio" in c and c["audio"].size]
                                   or [np.zeros(1, np.float32)])
            return audio, chunks[-1]["gen"]
        if mode in ("spec", "stochastic"):
            _, g = inference_tts_spec(model, x, prompt,
                                      greedy if mode == "spec" else stoch,
                                      n_draft=tau, seed=seed)
        else:
            _, g = inference_tts({"fp8": model_fp8}.get(mode, model), x,
                                 prompt, sampled if mode == "sampled"
                                 else greedy, seed=seed)
        return decode_audio(g), g

    for it in items:
        it["ref_wav"] = (decode_audio(it["gt_cont_codes"])
                         if ref_kind == "resynth" else it["gt_cont_wav"])

    results = {"n": len(items), "tau": tau, "ref": ref_kind,
               "temperature": args.temperature, "modes": {}}
    codes_by_mode = {}
    plain_codes = {}
    for mode in tts_modes:
        lmds, mcds, durs = [], [], []
        bit_exact = [] if mode in ("spec", "stream") else None
        t0 = time.perf_counter()
        t_baseline = 0.0        # lazy-baseline decodes belong to no mode
        for it in items:
            audio, gcodes = gen_for(mode, it)
            codes_by_mode.setdefault(mode, {})[it["id"]] = np.asarray(gcodes)
            # resynth always scores against the raw ground truth: the codec
            # floor that puts the other rows in context
            ref = it["gt_cont_wav"] if mode == "resynth" else it["ref_wav"]
            lmds.append(log_mel_distance(ref, audio, ccfg.sample_rate))
            mcds.append(mcd(ref, audio, ccfg.sample_rate))
            durs.append(duration_ratio(ref, audio))
            if mode == "plain":
                plain_codes[it["id"]] = np.asarray(gcodes)
            if bit_exact is not None:
                if it["id"] not in plain_codes:     # spec/stream without plain
                    tb = time.perf_counter()
                    plain_codes[it["id"]] = inference_tts(
                        model, it["x"], it["prompt"], greedy,
                        seed=args.seed)[1]
                    t_baseline += time.perf_counter() - tb
                p, g = plain_codes[it["id"]], np.asarray(gcodes)
                bit_exact.append(bool(p.shape == g.shape and (p == g).all()))
        entry = {
            "log_mel_dist_mean": float(np.mean(lmds)),
            "log_mel_dist_max": float(np.max(lmds)),
            "mcd_mean": float(np.mean(mcds)),
            "mcd_max": float(np.max(mcds)),
            "duration_ratio_mean": float(np.mean(durs)),
            "seconds": time.perf_counter() - t0 - t_baseline,
        }
        if bit_exact:
            entry["bit_exact_vs_plain"] = all(bit_exact)
        results["modes"][mode] = entry
        logging.info("%-10s lmd %.3f mcd %.2f dB dur %.2f %s", mode,
                     entry["log_mel_dist_mean"], entry["mcd_mean"],
                     entry["duration_ratio_mean"],
                     f"bit_exact={entry.get('bit_exact_vs_plain')}"
                     if "bit_exact_vs_plain" in entry else "")
    codes_by_mode["plain"] = plain_codes

    # edit modes: mask --edit-span of each utterance, regenerate it (the
    # transcript unchanged, so the original utterance is the target), and
    # score the whole utterance and the regenerated span
    if edit_modes:
        from voicecraft_tpu_torch.inference.editing import (
            fractional_edit_span, inference_edit)
        f0, f1 = args.edit_span
        spf = int(round(ccfg.sample_rate / ccfg.frame_rate))
        eitems = []
        for it in items:
            span = fractional_edit_span(it["codes"].shape[1], f0, f1)
            if span is not None:
                eitems.append({**it, "span": span, "ref_full": (
                    decode_audio(it["codes"]) if ref_kind == "resynth"
                    else it["gt_wav"])})
        results["edit_span"] = list(args.edit_span)
        if not eitems:
            logging.warning("no eval utterance long enough for edit span %s; "
                            "skipping edit modes", args.edit_span)
            edit_modes = []
        edit_codes = {}
        for mode in edit_modes:
            scfg_m = stoch if mode == "edit_stoch" else greedy
            tau_m = 0 if mode == "edit" else tau
            lmds, mcds, slmds, smcds, sdurs = [], [], [], [], []
            bit_exact = [] if mode == "edit_spec" else None
            t0 = time.perf_counter()
            t_baseline = 0.0
            for it in eitems:
                s, e = it["span"]
                T = it["codes"].shape[1]
                res = inference_edit(model, it["x"], it["codes"], [(s, e)],
                                     scfg_m, seed=args.seed, spec=tau_m)
                codes_by_mode.setdefault(mode, {})[it["id"]] = res
                audio = decode_audio(res)
                ref = it["ref_full"]
                lmds.append(log_mel_distance(ref, audio, ccfg.sample_rate))
                mcds.append(mcd(ref, audio, ccfg.sample_rate))
                # the span alone: both audios cut at their own span bounds
                gen_len = res.shape[1] - s - (T - e)
                hyp_span = audio[s * spf:(s + gen_len) * spf]
                ref_span = ref[s * spf:e * spf]
                if len(hyp_span) > spf and len(ref_span) > spf:
                    slmds.append(log_mel_distance(ref_span, hyp_span,
                                                  ccfg.sample_rate))
                    smcds.append(mcd(ref_span, hyp_span, ccfg.sample_rate))
                sdurs.append(gen_len / max(e - s, 1))
                if mode == "edit":
                    edit_codes[it["id"]] = res
                if bit_exact is not None:
                    if it["id"] not in edit_codes:   # edit_spec without edit
                        tb = time.perf_counter()
                        edit_codes[it["id"]] = inference_edit(
                            model, it["x"], it["codes"], [(s, e)], scfg_m,
                            seed=args.seed, spec=0)
                        t_baseline += time.perf_counter() - tb
                    p = edit_codes[it["id"]]
                    bit_exact.append(bool(p.shape == res.shape
                                          and (p == res).all()))
            mean = lambda v: float(np.mean(v)) if v else None
            entry = {
                "log_mel_dist_mean": mean(lmds),
                "mcd_mean": mean(mcds),
                "span_log_mel_dist_mean": mean(slmds),
                "span_mcd_mean": mean(smcds),
                "span_duration_ratio_mean": mean(sdurs),
                "seconds": time.perf_counter() - t0 - t_baseline,
            }
            if bit_exact:
                entry["bit_exact_vs_edit"] = all(bit_exact)
            results["modes"][mode] = entry
            nan = float("nan")
            logging.info("%-10s lmd %.3f mcd %.2f dB | span lmd %.3f mcd "
                         "%.2f dB dur %.2f %s", mode,
                         entry["log_mel_dist_mean"] or nan,
                         entry["mcd_mean"] or nan,
                         entry["span_log_mel_dist_mean"] or nan,
                         entry["span_mcd_mean"] or nan,
                         entry["span_duration_ratio_mean"] or nan,
                         f"bit_exact={entry.get('bit_exact_vs_edit')}"
                         if "bit_exact_vs_edit" in entry else "")
        codes_by_mode["edit"] = edit_codes
    return results, codes_by_mode


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    results, _ = run(args)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
