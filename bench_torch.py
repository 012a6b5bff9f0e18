#!/usr/bin/env python3
"""Benchmark of the PyTorch port (voicecraft_tpu_torch): the twin of
bench.py, giga830M on one CUDA card by default.

    python3 bench_torch.py [--bf16] [--serve N | --edit-serve N | --engine N
        | --spec TAU | --stream | --train | --train-profile] [...]

Prints one JSON line per measurement, in bench.py's shape:
  {"metric": "tts_rtf_830m", "value": <x realtime>, "unit": "x_realtime",
   "vs_baseline": <ratio>}

Every mode runs bench.py's geometry, sampling settings, metric name and
unit over the port's counterpart of the JAX function: the single-stream
decode loop (models/voicecraft.py:make_decode_loop with bench_mode, or
make_spec_decode_loop), lockstep serving (inference/serving.py),
continuous batching (inference/engine.py), streaming
(inference/streaming.py) and training (training/step.py with ScaledAdam
and the Eden schedule on a synthetic batch, training/synthetic.py).
Weights are random, from seed 0, with bf16 matrices; the default is
bench.py's serving configuration, weight-only fp8 decoder matrices
(utils/quantize.py) with packed qkv, and its default run ends with the
32-lane serving line (fp8 slab), printed last.

Each time is the best of --iters runs after one warm-up run, with the
card synchronised before every clock read.  ``--device cpu`` runs on the
CPU (smoke runs; the preset's bf16 becomes f32 there); without CUDA and
without it, the script stops.  bench.py's --platform (a JAX backend) and
--unroll (XLA's unrolling of the layer scan; the port's layer loop is
plain Python) have no counterpart.

Baseline, as bench.py's: the reference publishes ~1x realtime on a T4, so
vs_baseline == value.
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' for smoke runs (no fallback: "
                         "without CUDA the default stops)")
    ap.add_argument("--preset", default="giga830M")
    ap.add_argument("--frames", type=int, default=500,
                    help="codec frames to generate (50 = 1 s of audio)")
    ap.add_argument("--prompt-frames", type=int, default=150)
    ap.add_argument("--phones", type=int, default=120)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 weights (parity mode); default is the "
                         "serving config: weight-only fp8 decoder")
    ap.add_argument("--serve", type=int, default=0, metavar="LANES",
                    help="aggregate multi-stream serving throughput with N "
                         "distinct-prompt lanes instead of single-stream "
                         "latency")
    ap.add_argument("--train", action="store_true",
                    help="training throughput (codec tokens/s/card, "
                         "forward + backward + ScaledAdam)")
    ap.add_argument("--train-attn", default=None,
                    choices=["dense", "chunked"],
                    help="training attention for --train (default: the "
                         "preset's cfg.train_attn)")
    ap.add_argument("--train-fused", action="store_true",
                    help="the single-phase step even for >400M models (the "
                         "port's eager step is the same either way; the "
                         "flag names the metric)")
    ap.add_argument("--train-remat", default=None,
                    choices=["full", "dots", "attn", "attn_ffn1", "none"],
                    help="recompute policy for --train (default: the "
                         "preset's cfg.train_remat)")
    ap.add_argument("--train-batch", type=int, default=0,
                    help="training batch size (default: 8 for >400M "
                         "models, else 16)")
    ap.add_argument("--edit-serve", type=int, default=0, metavar="LANES",
                    help="aggregate batched speech-editing throughput with N "
                         "distinct edit requests in lockstep, run to budget")
    ap.add_argument("--engine", type=int, default=0, metavar="LANES",
                    help="continuous-batching aggregate throughput: 2x "
                         "LANES mixed-length requests, lanes refill "
                         "mid-flight (inference/engine.py)")
    ap.add_argument("--burst", type=int, default=48,
                    help="engine burst size (steps between admission checks)")
    ap.add_argument("--kv-fp8", action="store_true",
                    help="store the KV slab in float8_e4m3fn")
    ap.add_argument("--spec", type=int, default=0, metavar="TAU",
                    help="speculative decode with TAU tokens per pass (TAU-1 "
                         "random MTP head groups, which accept ~nothing: "
                         "the verified-pass rate); add --spec-accept for "
                         "the 100%%-acceptance ceiling")
    ap.add_argument("--spec-sampling", default="exact",
                    choices=["exact", "stochastic"],
                    help="speculative verification mode for --spec")
    ap.add_argument("--spec-accept", action="store_true",
                    help="force-accept every draft (the ceiling: real "
                         "per-pass cost, perfect acceptance)")
    ap.add_argument("--fused-ffn", action="store_true",
                    help="the decode FFN through the fused kernel "
                         "(single-stream mode only)")
    ap.add_argument("--no-pack-qkv", action="store_true",
                    help="keep separate wq/wk/wv products (default packs "
                         "them into one [D, 3D] product in fp8 mode)")
    ap.add_argument("--steps-per-iter", type=int, default=1,
                    help="decode steps between host syncs (the same "
                         "output; make_decode_loop's steps_per_iter)")
    ap.add_argument("--train-profile", action="store_true",
                    help="training cost ladder: forward only, gradients "
                         "(with recompute), the ScaledAdam update, and a "
                         "GEMM probe at the step's shapes (bf16, and fp8 "
                         "through torch._scaled_mm)")
    ap.add_argument("--profile-dir", default=None,
                    help="with --train-profile: also write a torch.profiler "
                         "trace of 3 steps into this dir")
    ap.add_argument("--steady", action="store_true",
                    help="with --engine: 8x LANES uniform-length requests, "
                         "so ramp-up and ramp-down are amortised")
    ap.add_argument("--stream", action="store_true",
                    help="streaming TTS first-audio latency "
                         "(inference/streaming.py over the engine, burst "
                         "from --burst)")
    ap.add_argument("--stream-no-pipeline", action="store_true",
                    help="with --stream: read each burst before the next "
                         "(the engine's pipeline off)")
    ap.add_argument("--stream-no-codec", action="store_true",
                    help="with --stream: frames-only chunks (no codec)")
    return ap


def _ceil(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class _Bench:
    """One invocation's settings, device and printed results."""

    def __init__(self, args):
        self.args = args
        self.dev = torch.device(args.device)
        self.results = []

    def clock(self) -> float:
        """perf_counter after the card has finished its queued work."""
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.perf_counter()

    def timed(self, fn):
        """(fn(), its wall seconds between two synchronised clock reads)."""
        t0 = self.clock()
        out = fn()
        return out, self.clock() - t0

    def best(self, fn):
        """(output, seconds) of the fastest of --iters timed calls of fn."""
        return min((self.timed(fn) for _ in range(self.args.iters)),
                   key=lambda r: r[1])

    def emit(self, result: dict) -> None:
        print(json.dumps(result), flush=True)
        self.results.append(result)


def main(argv=None) -> list:
    """Runs the mode the flags select; prints and returns its JSON lines."""
    args = build_parser().parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("bench_torch: torch.cuda.is_available() is false; "
                         "pass --device cpu for a CPU smoke run")
    args.fp8 = not args.bf16
    if args.spec_accept:
        args.spec_sampling = "exact"   # ceilings use exact verification
    b = _Bench(args)
    if args.train_profile:
        _bench_train_profile(b)
        return b.results
    if args.train:
        _bench_train(b)
        return b.results

    from voicecraft_tpu_torch.inference.loader import load_model
    from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8

    name = (torch.cuda.get_device_name(b.dev) if b.dev.type == "cuda"
            else "cpu")
    _err(f"device: {b.dev} ({name})")
    overrides = dict(n_mtp=args.spec - 1) if args.spec else None
    cfg, model, _ = load_model(args.preset, random_init=True, seed=0,
                               device=b.dev, overrides=overrides)
    if args.fp8:
        model = quantize_decoder_fp8(model, pack_qkv=not args.no_pack_qkv)
    rng = np.random.default_rng(0)

    if args.serve:
        _bench_serving(b, cfg, model, rng)
    elif args.edit_serve:
        _bench_edit_serving(b, cfg, model, rng)
    elif args.engine:
        _bench_engine(b, cfg, model, rng)
    elif args.spec:
        _bench_spec(b, cfg, model, rng)
    elif args.stream:
        _bench_stream(b, cfg, model, rng)
    else:
        _bench_single(b, cfg, model, rng)
    return b.results


def _tts_inputs(b, cfg, rng):
    """bench.py's single-stream request: random phones and prompt codes,
    the composed prefix and the padded device inputs."""
    from voicecraft_tpu_torch.data import spans
    from voicecraft_tpu_torch.inference.tts import pad_inputs
    args, K = b.args, cfg.n_codebooks
    x_tokens = rng.integers(0, cfg.text_vocab_size, args.phones).astype(np.int32)
    prompt = rng.integers(0, cfg.audio_vocab_size,
                          (K, args.prompt_frames)).astype(np.int32)
    prefix = spans.compose_tts_prefix(prompt, cfg)
    x_pad, y_pad = _ceil(len(x_tokens), 32), _ceil(prefix.length, 64)
    padded = pad_inputs(cfg, x_tokens, prefix, x_pad, y_pad, b.dev)
    return x_tokens, prefix, x_pad, y_pad, padded


def _sampling(args):
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    return SamplingConfig(top_k=40, top_p=1.0, temperature=1.0,
                          stop_repetition=3, spec_sampling=args.spec_sampling)


def _bench_single(b, cfg, model, rng):
    """bench.py main's single stream: the plain decode loop in bench_mode,
    exactly --frames samples (prefill in)."""
    from voicecraft_tpu_torch.models.voicecraft import make_decode_loop
    args = b.args
    x_tokens, prefix, x_pad, y_pad, (xt, yt, mi, qm) = _tts_inputs(b, cfg, rng)
    gen_max = args.frames
    loop = make_decode_loop(cfg, is_tts=True, x_pad=x_pad, y_pad=y_pad,
                            gen_max=gen_max, scfg=_sampling(args),
                            bench_mode=True, fused_ffn=args.fused_ffn,
                            kv_dtype="float8_e4m3fn" if args.kv_fp8 else None,
                            steps_per_iter=args.steps_per_iter)

    def run(seed):
        gen = torch.Generator(device=b.dev).manual_seed(seed)
        return b.timed(lambda: loop(model, xt, len(x_tokens), yt,
                                    prefix.length, mi, qm, 1, gen))

    out, compile_time = run(0)
    n_gen = out.gen_cnt
    if n_gen != gen_max:
        raise AssertionError(f"bench_mode recorded {n_gen} of {gen_max} frames")
    _err(f"compile+first run: {compile_time:.1f}s, generated {n_gen} frames")
    best = min(run(i + 1)[1] for i in range(args.iters))
    rtf = args.frames / cfg.encodec_sr / best
    _err(f"decode: {best:.3f}s for {args.frames} frames "
         f"({args.frames / best:.0f} steps/s incl. prefill)")
    b.emit({
        "metric": "tts_rtf_830m" + ("" if args.fp8 else "_bf16"),
        "value": round(rtf, 3),
        "unit": "x_realtime",
        "vs_baseline": round(rtf / 1.0, 3),
    })
    if args.fp8:
        # the default run also measures the serving headline, 32 lockstep
        # lanes with the fp8 slab, printed last (bench.py:254-263)
        args.serve, args.kv_fp8 = 32, True
        _bench_serving(b, cfg, model, rng,
                       extra={"single_stream_rtf": round(rtf, 3)})


def _bench_spec(b, cfg, model, rng):
    """Speculative single-stream decode (bench.py _bench_spec): TAU tokens
    fed a pass; random MTP heads reject ~every draft unless --spec-accept."""
    from voicecraft_tpu_torch.models.voicecraft import make_spec_decode_loop
    args, tau = b.args, b.args.spec
    x_tokens, prefix, x_pad, y_pad, (xt, yt, mi, _) = _tts_inputs(b, cfg, rng)
    loop = make_spec_decode_loop(
        cfg, x_pad=x_pad, y_pad=y_pad, gen_max=args.frames,
        scfg=_sampling(args), n_draft=tau, bench_mode=True,
        force_accept=args.spec_accept,
        kv_dtype="float8_e4m3fn" if args.kv_fp8 else None)

    def run(seed):
        return b.timed(lambda: loop(model, xt, len(x_tokens), yt,
                                    prefix.length, mi, seed))

    out, dt = run(0)
    _err(f"compile+first: {dt:.1f}s ({out.gen_cnt} tokens in {out.passes} "
         "passes)")
    runs = [run(i + 1) for i in range(args.iters)]
    out, best = min(runs, key=lambda r: r[1])
    n_gen, n_passes = out.gen_cnt, out.passes
    rtf = n_gen / cfg.encodec_sr / best
    _err(f"spec tau={tau} accept={'forced' if args.spec_accept else 'real'}: "
         f"{best:.3f}s for {n_gen} tokens / {n_passes} passes "
         f"({n_passes / best:.0f} passes/s, {n_gen / best:.0f} tokens/s, "
         f"{n_gen / max(n_passes, 1):.2f} tok/pass)")
    b.emit({
        "metric": f"tts_spec_rtf_830m_tau{tau}"
                  + ("_ceiling" if args.spec_accept else ""),
        "value": round(rtf, 3),
        "unit": "x_realtime",
        "vs_baseline": round(rtf, 3),
    })


def _bench_stream(b, cfg, model, rng):
    """Streaming TTS (bench.py _bench_stream): wall ms from the request to
    its first audible chunk (first frames with --stream-no-codec)."""
    from voicecraft_tpu_torch.inference.loader import load_codec
    from voicecraft_tpu_torch.inference.streaming import stream_tts
    args, K = b.args, cfg.n_codebooks
    # a random 16 kHz EnCodec: timing-equivalent
    codec = (None if args.stream_no_codec
             else load_codec(None, random_init=True, seed=0, device=b.dev)[1])
    x_tokens = rng.integers(0, cfg.text_vocab_size, args.phones).astype(np.int32)
    prompt = rng.integers(0, cfg.audio_vocab_size,
                          (K, args.prompt_frames)).astype(np.int32)
    scfg = _sampling(args)

    def run():
        t0 = b.clock()
        first, chunks, frames = None, 0, 0
        for c in stream_tts(model, x_tokens, prompt, scfg, seed=1,
                            codec=codec, burst=args.burst,
                            kv_dtype="float8_e4m3fn" if args.kv_fp8 else None,
                            pipeline=not args.stream_no_pipeline):
            ready = (c["frames"].size if args.stream_no_codec
                     else c.get("audio") is not None and c["audio"].size)
            if ready and first is None:
                first = b.clock() - t0
            chunks += 1
            frames += c["frames"].shape[1]
        return first, b.clock() - t0, chunks, frames

    _, total, _, _ = run()                  # warm-up
    _err(f"compile+first run: {total:.1f}s")
    results = [run() for _ in range(args.iters)]
    first = min(r[0] for r in results)
    total = min(r[1] for r in results)
    chunks, frames = results[0][2], results[0][3]
    audio_sec = frames / cfg.encodec_sr
    _err(f"stream: first audio {first * 1e3:.0f} ms, {chunks} chunks, "
         f"{frames} frames ({audio_sec:.1f}s audio) in {total:.2f}s "
         f"({audio_sec / total:.1f}x realtime)")
    b.emit({
        "metric": f"tts_stream_first_audio_ms_burst{args.burst}"
                  + ("_nocodec" if args.stream_no_codec else "")
                  + ("_nopipe" if args.stream_no_pipeline else ""),
        "value": round(first * 1e3, 1),
        "unit": "ms",
        "vs_baseline": round(audio_sec / total, 2),
    })


def _train_setup(b):
    """The preset (with --train-attn / --train-remat; f32 compute on the
    CPU, as bench.py's CPU runs), a trainable model from seed 0, ScaledAdam
    with the Eden schedule, and the batch size."""
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.models.voicecraft import VoiceCraft, param_count
    from voicecraft_tpu_torch.training.optim import (ScaledAdam, eden_schedule,
                                                     stacked_leaves)
    args = b.args
    cfg = PRESETS[args.preset]()
    if args.train_attn:
        cfg = dataclasses.replace(cfg, train_attn=args.train_attn)
    if args.train_remat:
        cfg = dataclasses.replace(cfg, train_remat=args.train_remat)
    if b.dev.type == "cpu" and cfg.compute_dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = VoiceCraft(cfg, b.dev, trainable=True).init_weights(
        torch.Generator(device=b.dev).manual_seed(0))
    opt = ScaledAdam(stacked_leaves(model), lr=eden_schedule(0.05, 3000, 4, 500))
    n_params = param_count(model)
    big = n_params > 4e8
    B = args.train_batch or (8 if big else 16)
    return cfg, model, opt, n_params, big, B


def _bench_train(b):
    """Training step throughput (bench.py _bench_train): forward, backward
    and the ScaledAdam update on a synthetic batch."""
    from voicecraft_tpu_torch.training.step import (make_train_step,
                                                    make_train_step_two_phase)
    from voicecraft_tpu_torch.training.synthetic import synthetic_batch
    args = b.args
    cfg, model, opt, _, big, B = _train_setup(b)
    make = (make_train_step_two_phase if big and not args.train_fused
            else make_train_step)
    step = make(model, opt)
    batch = synthetic_batch(cfg, B=B, Sx=160, y_len=480, seed=1, device=b.dev)
    m, dt = b.timed(lambda: step(batch, 1))
    ntok = float(m["effective_ntoken"])
    _err(f"compile+first step: {dt:.1f}s")
    runs = [b.timed(lambda i=i: step(batch, i)) for i in range(args.iters)]
    m = runs[-1][0]
    if not np.isfinite(float(m["loss"])):
        raise FloatingPointError(f"training loss {float(m['loss'])}")
    b.emit({
        "metric": f"train_tokens_per_sec_{args.preset}"
                  + (f"_{args.train_attn}" if args.train_attn else "")
                  + (f"_{args.train_remat}" if args.train_remat else "")
                  + ("_fused" if args.train_fused else ""),
        "value": round(ntok / min(dt for _, dt in runs), 0),
        "unit": "codec_tokens/s/chip",
        "vs_baseline": 1.0,
    })


def _gemm_probes(b, cfg, M):
    """Standalone GEMMs at the step's dominant shapes: [M, D] x [D, 4D],
    [M, 4D] x [4D, D] and [M, D] x [D, D].  Returns (FLOPs of one probe,
    bf16 (or the compute dtype's) TFLOP/s, fp8 TFLOP/s through
    torch._scaled_mm or None where the device refuses it)."""
    args = b.args
    D = cfg.d_model
    F = 4 * D
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    g = torch.Generator(device=b.dev).manual_seed(0)
    a1 = torch.randn(M, D, generator=g, device=b.dev).to(dt)
    w1 = torch.randn(D, F, generator=g, device=b.dev).to(dt)
    w2 = torch.randn(F, D, generator=g, device=b.dev).to(dt)
    wq = torch.randn(D, D, generator=g, device=b.dev).to(dt)
    flops = 2 * M * (D * F * 2 + D * D)
    n = max(args.iters, 10)

    def timed(fn):
        fn()                                 # warm-up
        t0 = b.clock()
        for _ in range(n):
            fn()
        return (b.clock() - t0) / n

    def probe():
        h = a1 @ w1                          # FFN up
        y = h @ w2                           # FFN down
        q = a1 @ wq                          # attention projection shape
        return (y * q).sum()

    bf16 = flops / timed(probe) / 1e12

    fp8 = None
    if b.dev.type != "cuda":
        # the CPU's _scaled_mm is an emulation, not an fp8 GEMM
        _err("fp8 gemm probe: the card's only (torch._scaled_mm)")
        return flops, bf16, fp8
    try:
        f8 = torch.float8_e4m3fn
        one = torch.ones((), device=b.dev)
        # _scaled_mm takes its second operand column-major
        col = lambda w: w.to(f8).t().contiguous().t()
        a8, w18, w28, wq8 = a1.to(f8), col(w1), col(w2), col(wq)

        def probe8():
            mm = lambda a, w: torch._scaled_mm(a, w, scale_a=one, scale_b=one,
                                               out_dtype=torch.bfloat16)
            h = mm(a8, w18)
            y = mm(h.to(f8), w28)
            q = mm(a8, wq8)
            return (y * q).sum()

        fp8 = round(flops / timed(probe8) / 1e12, 1)
    except (RuntimeError, NotImplementedError) as e:
        _err(f"fp8 gemm probe failed: {e!r}")
    return flops, bf16, fp8


def _bench_train_profile(b):
    """Training cost ladder (bench.py _bench_train_profile): forward only
    (no recompute, no grad), gradients with the preset's recompute, the
    ScaledAdam update, each timed alone at the benchmark batch, then the
    GEMM probes; prints bench.py's attribution fields."""
    from voicecraft_tpu_torch.models.voicecraft import forward_train
    from voicecraft_tpu_torch.training.synthetic import synthetic_batch
    from voicecraft_tpu_torch.utils.profiling import device_trace
    args = b.args
    cfg, model, opt, n_params, _, B = _train_setup(b)
    Sx, Sy = 160, 480
    batch = synthetic_batch(cfg, B=B, Sx=Sx, y_len=Sy, seed=1, device=b.dev)
    params = [p for p in model.parameters() if p.requires_grad]

    def best_of(fn):
        fn()                                 # warm-up
        return b.best(fn)[1]

    def fwd():
        with torch.no_grad():
            return float(forward_train(model, batch, seed=1, remat=False)["loss"])

    out = {}

    def grads():
        for p in params:
            p.grad = None
        o = forward_train(model, batch, seed=1, remat=True)
        o["loss"].backward()
        out.update(ntok=float(o["effective_ntoken"]), loss=o["loss"].item())

    t_fwd = best_of(fwd)
    t_grads = best_of(grads)
    ntok = out["ntok"]
    # the update, chained: each call steps the state the last one left
    # (the gradients of the last grads() call stay in place)
    t_upd = best_of(opt.step)

    if args.profile_dir:
        with device_trace(args.profile_dir):
            for _ in range(3):
                grads()
                opt.step()
            b.clock()
        _err(f"profiler trace written to {args.profile_dir}")

    M = B * (Sx + Sy)                        # tokens in the step
    probe_flops, gemm_tflops, gemm_fp8_tflops = _gemm_probes(b, cfg, M)

    # FLOPs as bench.py counts them: ~6 N FLOPs a sequence position
    # (forward 2N, backward 4N) over B (Sx + Sy) positions
    t_step = t_grads + t_upd
    step_flops = 6.0 * n_params * M
    remat_sched = t_grads - 3.0 * t_fwd
    b.emit({
        "metric": f"train_profile_{args.preset}"
                  + (f"_{args.train_remat}" if args.train_remat else ""),
        "B": B, "tokens_per_step": ntok,
        "tokens_per_sec": round(ntok / t_step, 0),
        "t_fwd_s": round(t_fwd, 4),
        "t_grads_s": round(t_grads, 4),
        "t_update_s": round(t_upd, 4),
        "t_step_s": round(t_step, 4),
        "achieved_tflops": round(step_flops / t_step / 1e12, 1),
        "gemm_probe_tflops": round(gemm_tflops, 1),
        "gemm_probe_fp8_tflops": gemm_fp8_tflops,
        "frac_fwd": round(t_fwd / t_step, 3),
        "frac_ideal_bwd": round(2.0 * t_fwd / t_step, 3),
        "frac_remat_sched": round(remat_sched / t_step, 3),
        "frac_update": round(t_upd / t_step, 3),
    })


def _bench_serving(b, cfg, model, rng, extra=None):
    """Aggregate throughput of N distinct-prompt lanes in lockstep (bench.py
    _bench_serving); with --spec TAU the speculative serving loop, in
    bench_mode."""
    from voicecraft_tpu_torch.inference.serving import (make_serving_tts_loop,
                                                        make_spec_serving_loop,
                                                        tts_wave_inputs)
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    args = b.args
    B, K, tau = args.serve, cfg.n_codebooks, args.spec
    x_pad, y_pad, gen_max = 128, 192, args.frames
    scfg = SamplingConfig(top_k=40, stop_repetition=3,
                          spec_sampling=args.spec_sampling)
    xt = rng.integers(0, cfg.text_vocab_size, (B, x_pad))
    reqs = [(xt[i], rng.integers(0, cfg.audio_vocab_size,
                                 (K, args.prompt_frames)))
            for i in range(B)]
    _, wave = tts_wave_inputs(model, reqs, (x_pad, y_pad, gen_max))
    kv_dtype = "float8_e4m3fn" if args.kv_fp8 else None
    if tau > 1:
        loop = make_spec_serving_loop(
            cfg, batch_size=B, n_draft=tau, x_pad=x_pad, y_pad=y_pad,
            gen_max=gen_max, scfg=scfg, kv_dtype=kv_dtype, bench_mode=True,
            force_accept=args.spec_accept)
    else:
        loop = make_serving_tts_loop(
            cfg, batch_size=B, x_pad=x_pad, y_pad=y_pad, gen_max=gen_max,
            scfg=scfg, kv_dtype=kv_dtype)
    run = lambda: loop(model, *wave, [0] * B)
    _err(f"compile+first run: {b.timed(run)[1]:.1f}s")
    out, best = b.best(run)
    frames = sum(out.n_rows)
    if tau > 1:
        _err(f"spec serving tau={tau} "
             f"accept={'forced' if args.spec_accept else 'real'}: "
             f"{best:.2f}s for {frames} frames across {B} lanes "
             f"({out.steps} passes, {frames / max(out.steps, 1) / B:.2f} "
             f"tok/pass/lane)")
    else:
        _err(f"serving: {best:.2f}s for {frames} frames across {B} lanes")
    rtf = frames / cfg.encodec_sr / best
    suffix = ("" if tau <= 1 else
              f"_spec{tau}" + ("_ceiling" if args.spec_accept else ""))
    b.emit({
        "metric": f"tts_serving_rtf_830m_b{B}{suffix}",
        "value": round(rtf, 2),
        "unit": "x_realtime_per_chip",
        "vs_baseline": round(rtf, 2),
        **(extra or {}),
    })


def _bench_edit_serving(b, cfg, model, rng):
    """Aggregate batched speech-editing throughput (bench.py
    _bench_edit_serving): N distinct one-span edits in lockstep, every
    lane run to its budget (bench_mode)."""
    from voicecraft_tpu_torch.inference.serving import (edit_wave_inputs,
                                                        make_serving_edit_loop)
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    args = b.args
    B, K = args.edit_serve, cfg.n_codebooks
    x_pad, y_pad, gen_max = 128, 192, args.frames
    scfg = SamplingConfig(top_k=40, stop_repetition=3)
    xt = rng.integers(0, cfg.text_vocab_size, (B, x_pad))
    iv = [(args.prompt_frames // 4, args.prompt_frames // 2)]
    reqs = [(xt[i], rng.integers(0, cfg.audio_vocab_size,
                                 (K, args.prompt_frames)), iv)
            for i in range(B)]
    _, wave = edit_wave_inputs(model, reqs, (x_pad, y_pad, gen_max))
    loop = make_serving_edit_loop(
        cfg, batch_size=B, x_pad=x_pad, y_pad=y_pad, gen_max=gen_max,
        scfg=scfg, kv_dtype="float8_e4m3fn" if args.kv_fp8 else None,
        bench_mode=True)
    run = lambda: loop(model, *wave, [0] * B)
    _err(f"compile+first run: {b.timed(run)[1]:.1f}s")
    out, best = b.best(run)
    frames = sum(out.n_rows)
    _err(f"edit serving: {best:.2f}s for {frames} frames across {B} lanes")
    rtf = frames / cfg.encodec_sr / best
    b.emit({
        "metric": f"edit_serving_rtf_830m_b{B}",
        "value": round(rtf, 2),
        "unit": "x_realtime_per_chip",
        "vs_baseline": round(rtf, 2),
    })


def _bench_engine(b, cfg, model, rng):
    """Continuous-batching throughput with mid-flight refill (bench.py
    _bench_engine): 2x LANES requests of 60-100% of --frames (8x LANES
    at 100% with --steady), drained through the ContinuousBatcher; the
    wall covers admission prefills, bursts and retirement readbacks."""
    from voicecraft_tpu_torch.inference.engine import ContinuousBatcher
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    args = b.args
    lanes, K = args.engine, cfg.n_codebooks
    n_req = (8 if args.steady else 2) * lanes
    scfg = SamplingConfig(top_k=40, stop_repetition=3,
                          spec_sampling=args.spec_sampling)
    # target lengths through the x_len * (encodec_sr // 5) cap (sampled
    # eog is rare at random init)
    cap_mult = cfg.encodec_sr // 5
    reqs = []
    for i in range(n_req):
        frac = 1.0 if args.steady else (
            0.6 + 0.4 * (i % lanes) / max(lanes - 1, 1))
        target = int(args.frames * frac)
        x_len = (target + args.prompt_frames) // cap_mult + 1
        x = rng.integers(0, cfg.text_vocab_size, x_len).astype(np.int32)
        y = rng.integers(0, cfg.audio_vocab_size,
                         (K, args.prompt_frames)).astype(np.int32)
        reqs.append((x, y))

    eng = ContinuousBatcher(
        model, lanes=lanes, x_pad=128,
        y_pad=((args.prompt_frames + K + 8 + 63) // 64) * 64,
        gen_max=args.frames + 16, burst=args.burst, scfg=scfg, seed=0,
        kv_dtype="float8_e4m3fn" if args.kv_fp8 else None,
        spec=args.spec, spec_force_accept=args.spec_accept)
    t0 = b.clock()
    for x, y in reqs[:lanes]:
        eng.submit(x, y)
    warm = eng.run()
    _err(f"compile+warmup: {b.clock() - t0:.1f}s ({len(warm)} requests)")

    times, frames = [], 0
    g0 = int(eng._lanes.gstep)
    for _ in range(args.iters):
        for x, y in reqs:
            eng.submit(x, y)
        t0 = b.clock()
        results = eng.run()
        times.append(b.clock() - t0)
        frames = sum(g.shape[1] for _, g in results.values())
    best = min(times)
    rtf = frames / cfg.encodec_sr / best
    per_iter = (int(eng._lanes.gstep) - g0) / args.iters
    _err(f"engine: {best:.2f}s for {frames} frames, {n_req} requests "
         f"over {lanes} lanes (burst {args.burst}); "
         f"~{per_iter:.0f} device steps/iter -> {best / per_iter * 1e3:.2f} "
         f"ms/step, lane occupancy "
         f"{frames / (per_iter * lanes) * 100:.0f}%")
    suffix = ("" if args.spec <= 1 else
              f"_spec{args.spec}" + ("_ceiling" if args.spec_accept else ""))
    if args.steady:
        suffix += "_steady"
    b.emit({
        "metric": f"tts_engine_rtf_830m_l{lanes}{suffix}",
        "value": round(rtf, 2),
        "unit": "x_realtime_per_chip",
        "vs_baseline": round(rtf, 2),
    })


if __name__ == "__main__":
    main()
