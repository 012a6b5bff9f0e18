#!/usr/bin/env python3
"""Smoke run of the PyTorch port (voicecraft_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device   the card's name and power limit; TF32 off in matmuls and cuDNN
  2. build    the CUDA kernels from voicecraft_tpu_torch/csrc (nvcc, sm_90a)
  3. kernels  the bf16 rounding points of mha, decode_attention_self and
              apply_heads on the card against the same functions on CPU
              copies of the inputs; each kernel against its plain PyTorch
              version on the card, at the main path's shapes and at edge
              shapes, against a stated tolerance; the fused FFN's bf16
              calls repeated and replayed from a CUDA graph bit for bit;
              kernel, plain and library times from CUDA-graph replays (the
              FFN over a round robin of weight sets larger than L2) beside
              the bound computed from the shapes; the attention kernel's
              grid, and its time against dense mha over a range of S
  4. slice    giga830M in bf16 and the 16 kHz EnCodec, random weights from a
              seed, serving three zero-shot TTS requests through the
              functions tts_torch_cli.py calls: (a) a ~17 s prompt, whose
              prefill goes through the attention kernel, sampled, with the
              fused FFN kernel; (b) the same greedy; (c) the 4.3 s demo
              prompt, dense prefill, greedy, unfused FFN.  Checks the launch
              counts and that every wav is finite; then the logits of the
              kernel path against the plain path after prefill and after 16
              teacher-forced decode steps; then request (a)'s prefill time
              through the attention kernel and through dense mha.
  5. editing  the same model and codec, with codebook 0's eog bias raised by
              EOG_BIAS, serving two multi-span edits through the functions
              edit_torch_cli.py calls: (d) a 21.6 s recording (demo.wav
              tiled 5x) with three masked intervals, whose prefill goes
              through the attention kernel, sampled, fused FFN; (e) the
              4.32 s demo with two, dense prefill, greedy, unfused FFN.
              Checks that every span ends and is non-empty (so the span
              feed queue runs), that the kept frames stand verbatim at their
              offsets, the result's length, finite wavs and exact launch
              counts; then the logits of the kernel path against the plain
              path at (d)'s geometry across a span transition (prefill, K+4
              tokens, the two queued feeds, 8 more tokens).

The last three lines are the card (as nvidia-smi reports it), one JSON
object with each kernel's result, and {"ok": true, "device": {...}}.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0
GEN_MAX = 256
PROMPT = "the sound of birds over the river at dawn"
TARGET = "the river runs past the old mill in the morning light"
LONG_TILES = 4                       # demo.wav (4.32 s) tiled to 17.28 s
EDIT_TILES = 5                       # demo.wav tiled to 21.6 s = 1080 frames
EDIT_GEN_MAX = 384                   # recorded samples per edit request
EDIT_TARGET = "the sound of waves over the sea at dawn"
# Random weights end a span only when codebook 0 draws eog, 1 code of 2051:
# thousands of steps.  Phase 5 adds EOG_BIAS to that logit's bias
# (model.heads.b2[0, eog]) so that every span ends well within
# EDIT_GEN_MAX.  The random heads' logits spread ~0.2 around 0 and their
# largest of 2051 sits near +0.75.  A sweep on an H100 (seeds 0 and 1):
# at 0.3 the spans of (d) and (e) end after 18-85 frames (at most 203
# forwards); at 0.4 (e)'s greedy spans end at their first sample, empty.
EOG_BIAS = 0.3

# kernel vs plain tolerances (both accumulate in f32; they differ in
# summation order, and in bf16 by one or two ulps of the rounded output)
TOL_FLASH_F32 = 1e-4
TOL_FFN_F32 = 1e-4
# the bf16 FFN kernel, per element, in bf16 ulps of max(|out|, 1), against
# its plain version, which rounds at the same points (f32 products, the
# hidden vector rounded to bf16, one output rounding) and sums in another
# order.  The f32 sums then differ by ~1e-6 relative, which can flip the
# output's rounding (1 ulp) and, now and then, a hidden element's rounding:
# that moves out by ulp(h) * |w2| ~ 2^-8 * 0.01, far below an output ulp,
# so 1 more ulp bounds any number of such flips.  2 ulps of 1 are 0.0156,
# under the flat 2e-2 this check replaces.
FFN_ULPS = 2.0
# the FFN timings stream weights as decode does, from device memory: a
# round robin over FFN_SETS weight sets (8 x 67.1 MB bf16, far past the 50
# MB L2)
FFN_SETS = 8
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory, bf16 tensor cores, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
# the bf16 attention kernel, per element, in bf16 ulps of max(|out|, 1).
# Against its plain version, which keeps the probs in f32 where the kernel
# rounds them to bf16: each prob is off by up to 2^-9 of itself, which
# moves p@v by at most 2^-9 max|v| (~1 ulp of 1 for |v| up to ~4), and the
# two outputs' roundings by up to 1 ulp more; 3 bounds the sum.  Against
# dense bf16 mha, which rounds at the same points (f32 logits, probs to
# bf16, f32 p@v, one output rounding), only the summation order and the
# roundings it flips remain: 2.  The floor at 1: the probs' rounding
# errors are summed against v, whose entries are ~1, so they scale with
# |v|, not with a small output
FLASH_VS_PLAIN_ULPS = 3.0
FLASH_VS_MHA_ULPS = 2.0
# the bf16 rounding points on the card against the CPU (which upcasts the
# bf16 operands): one bf16 ulp of the output's largest magnitude, where the
# two devices' f32 sums in different orders flip a rounding, plus 1e-5 of
# that magnitude for the f32 summation order itself; a bf16 logit (the
# fault repaired) costs ~2.5 ulps
REPAIR_F32_SLACK = 1e-5
# kernel path vs plain path logits of giga830M in bf16: the two paths round
# to bf16 at different places (the fused FFN rounds x@w1 once with its bias,
# the unfused one twice; the attention kernel rounds its f32 output once),
# and those bf16 ulps (0.4% relative) pass through 16 residual layers and
# the heads; random-weight logits stay below ~1.5, so 0.05 is a few percent
TOL_LOGITS = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fns, replays: int = 10) -> float:
    """Device time per call of the callables fns, run in turn, from CUDA
    events around replays of one CUDA graph of all of them: the host's
    launch overhead, which an eager loop of short kernels measures instead,
    is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up outside the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * len(fns))


def replay_matches_eager(fn) -> bool:
    """fn() captured in a CUDA graph and replayed equals fn() run eagerly,
    bit for bit."""
    import torch
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(out, eager)


def bound(nbytes: float, flops: float, flop_per_s: float):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(x):
    """The bf16 spacing at |x| (tensor or float), 2^(floor(log2|x|) - 7)."""
    import torch
    x = torch.as_tensor(x, dtype=torch.float32).abs().clamp(min=2.0 ** -100)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def check(name: str, err: float, tol: float) -> None:
    log(f"  {name}: max abs err {err:.3e} (tolerance {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")


def check_ulps(name: str, got, want, limit: float) -> float:
    """Holds bf16 results per element to `limit` ulps of max(|want|, 1);
    returns the max abs error."""
    diff = (got.float() - want.float()).abs()
    ulps = (diff / bf16_ulp(want.float().abs().clamp(min=1.0))).max().item()
    err = diff.max().item()
    log(f"  {name}: max abs err {err:.3e}, {ulps:.2f} ulps of max(|out|, 1) "
        f"(tolerance {limit:g})")
    if not ulps <= limit:
        raise AssertionError(f"{name}: {ulps} ulps > {limit}")
    return err


# ---- phase 3 -----------------------------------------------------------------

def repair_phase():
    """The port's bf16 rounding points on the card (cuBLAS with f32 output)
    against the same functions on CPU copies of the inputs, at giga830M
    width: f32 logits, probs cast to bf16, one rounding after p@v."""
    import copy
    import torch
    from voicecraft_tpu_torch.models.voicecraft import Heads, apply_heads
    from voicecraft_tpu_torch.ops.attention import (decode_attention_self, mha,
                                                    segment_padding_bias)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bf = torch.bfloat16

    def randn(*shape, std=2.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(bf)

    def compare(name, fn, *args):
        got = fn(*args).float()
        cpu = [a.cpu() if isinstance(a, (torch.Tensor, torch.nn.Module)) else a
               for a in args]
        want = fn(*cpu).float()
        scale = want.abs().max().item()
        tol = bf16_ulp(scale).item() + REPAIR_F32_SLACK * scale
        check(f"{name} (max |out| {scale:.3f})",
              (got.cpu() - want).abs().max().item(), tol)

    log("bf16 rounding points, card vs CPU (giga830M width):")
    S, D, H, x_pad = 352, 2048, 16, 96
    for xl, yl in (([93], [256]), ([93, 60], [256, 200])):
        B = len(xl)
        xl = torch.tensor(xl, dtype=torch.int32, device="cuda")
        yl = torch.tensor(yl, dtype=torch.int32, device="cuda")
        compare(f"mha B={B} S=352 H=16 Dh=128",
                lambda q, k, v, b: mha(q, k, v, b, H), randn(B, S, D),
                randn(B, S, D), randn(B, S, D),
                segment_padding_bias(S, x_pad, xl, yl))
    S_max, kv_len = 1408, 1376
    for x_len, xp in ((None, None), (221, 224)):
        args = (randn(1, 1, D), randn(1, S_max, H, D // H),
                randn(1, S_max, H, D // H), torch.tensor(kv_len, device="cuda"),
                randn(1, 1, H, D // H), randn(1, 1, H, D // H),
                None if x_len is None else torch.tensor(x_len, device="cuda"))
        attn = lambda q, kc, vc, n, kn, vn, xl_: decode_attention_self(
            q, kc, vc, n, kn, vn, H, x_len=xl_, x_pad=xp)
        compare(f"decode_attention_self slab {S_max} x_pad {xp}", attn, *args)
        # the slab reaches cuBLAS as strided views: no copy of it is made
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        attn(*args)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        slab = args[1].numel() * args[1].element_size()
        log(f"  decode_attention_self allocates {extra} bytes at peak beside "
            f"a {slab}-byte K slab")
        if extra >= slab:
            raise AssertionError("decode_attention_self copied the KV slab")
    heads = Heads(4, D, 1024, 2052, bf, "cuda")
    heads.init_weights(torch.Generator(device="cuda").manual_seed(SEED + 3))
    compare("apply_heads D=2048 N=4", lambda hd, h: apply_heads(hd, h),
            copy.deepcopy(heads), randn(4, D, std=1.0))


def flash_phase(geom_long):
    import torch
    import torch.nn.functional as fnn
    from voicecraft_tpu_torch.ops.attention import mha, segment_padding_bias
    from voicecraft_tpu_torch.ops.flash_attention import (
        flash_prefix_attention, flash_prefix_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(B, S, D, x_lens, y_lens, dtype):
        q, k, v = (torch.randn((B, S, D), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        xl = torch.tensor(x_lens, dtype=torch.int32, device="cuda")
        yl = torch.tensor(y_lens, dtype=torch.int32, device="cuda")
        return q, k, v, xl, yl

    def valid_rows(B, S, x_pad, x_lens, y_lens):
        rows = torch.zeros((B, S), dtype=torch.bool, device="cuda")
        for b in range(B):
            rows[b, :x_lens[b]] = True
            rows[b, x_pad:x_pad + y_lens[b]] = True
        return rows

    def case(name, B, S, D, H, x_pad, x_lens, y_lens, dtype):
        q, k, v, xl, yl = inputs(B, S, D, x_lens, y_lens, dtype)
        args = (q, k, v, xl, yl, x_pad, H)
        got = flash_prefix_attention(*args)
        want = flash_prefix_attention_plain(*args)
        torch.cuda.synchronize()
        rows = valid_rows(B, S, x_pad, x_lens, y_lens)
        if dtype == torch.bfloat16:
            err = check_ulps(name, got[rows], want[rows], FLASH_VS_PLAIN_ULPS)
        else:
            err = (got - want)[rows].abs().max().item()
            check(name, err, TOL_FLASH_F32)
        return err, args, got, rows

    x_len, x_pad, y_len, y_pad = geom_long
    S = x_pad + y_pad
    # the sm90 kernel's grid is (H, B, q tiles of BQ rows), as its launch()
    # sets it
    src = (REPO / "voicecraft_tpu_torch" / "csrc"
           / "flash_prefix_attention_sm90.cu").read_text()
    bq = int(re.search(r"constexpr int BQ = (\d+);", src).group(1))
    blocks = 16 * -(-S // bq)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"flash_prefix_attention, bf16, B=1 S={S} D=2048 H=16 "
        f"(x_len {x_len}, x_pad {x_pad}, y_len {y_len}): grid of {blocks} "
        f"blocks of {bq} q rows = {blocks / sms:.2f} waves over {sms} SMs")
    err, args, got, rows = case("bf16 main-path shape vs plain", 1, S, 2048,
                                16, x_pad, [x_len], [y_len], torch.bfloat16)
    q, k, v, xl, yl = args[:5]
    dense = mha(q, k, v, segment_padding_bias(S, x_pad, xl, yl), 16)
    check_ulps("bf16 main-path shape vs dense bf16 mha", got[rows],
               dense[rows], FLASH_VS_MHA_ULPS)

    def timings(args, dtype_peak, elt):
        """Kernel, plain and library (one call of PyTorch's fused attention
        under the same mask) ms from CUDA-graph replays, and the bound:
        q/k/v/out read or written once, 4*D flops for each (query, allowed
        key) pair: the products of every row against the keys its mask
        allows."""
        q, k, v, xl, yl, xp, H = args
        B, S, D = q.shape
        allowed = segment_padding_bias(S, xp, xl, yl)[:, 0] == 0  # [B, S, S]
        heads = lambda t: t.view(B, S, H, D // H).transpose(1, 2)
        t = dict(
            ms=graph_ms([lambda: flash_prefix_attention(*args)]),
            plain_ms=graph_ms([lambda: flash_prefix_attention_plain(*args)]),
            library_ms=graph_ms([lambda: fnn.scaled_dot_product_attention(
                heads(q), heads(k), heads(v), attn_mask=allowed[:, None])]))
        t["bound_ms"], t["bound_by"] = bound(
            4 * B * S * D * elt, 4 * D * allowed.sum().item(), dtype_peak)
        log(f"  kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library (PyTorch's fused attention) {t['library_ms']:.4f} ms "
            f"per call (CUDA-graph replays); bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), the kernel at {t['bound_ms'] / t['ms']:.0%} "
            f"of it")
        return t

    main = timings(args, BF16_FLOP_PER_S, 2)
    log(f"  eager, host launch included: kernel "
        f"{cuda_ms(lambda: flash_prefix_attention(*args)):.4f} ms per call")
    # edge shapes: B=2 with different lens, S off every tile size, x_pad off
    # the tile grid, every head dim, and a text padding wide enough that
    # whole key tiles in it are skipped (one row with no text at all)
    for B, S2, D, H, xp, xl2, yl2 in (
            (2, 1120, 2048, 16, 224, [221, 150], [896, 700]),
            (2, 600, 256, 2, 400, [30, 0], [200, 150]),
            (1, 33, 64, 4, 8, [5], [20]),
            (2, 130, 128, 8, 32, [7, 32], [98, 50]),
            (2, 200, 256, 4, 48, [30, 48], [100, 152]),
            (1, 333, 256, 8, 64, [50], [250]),
            (1, 300, 512, 4, 70, [64], [230]),
            (1, 1120, 1024, 16, 224, [221], [896]),
            (1, 1120, 512, 16, 224, [221], [896]),
            (1, 1120, 256, 16, 224, [221], [896])):
        case(f"bf16 B={B} S={S2} Dh={D // H} x_pad={xp}", B, S2, D, H, xp,
             xl2, yl2, torch.bfloat16)
    for B, S2, D, H, xp, xl2, yl2 in ((2, 200, 256, 4, 48, [30, 48], [100, 152]),
                                      (2, 130, 128, 8, 32, [7, 32], [98, 50]),
                                      (1, 333, 256, 8, 64, [50], [250]),
                                      (1, 300, 512, 4, 64, [64], [236])):
        case(f"f32 B={B} S={S2} Dh={D // H}", B, S2, D, H, xp, xl2, yl2,
             torch.float32)
    # the f32 kernel (the checks' path) at the main path's width
    _, args32, _, _ = case(f"f32 B=1 S={S} D=2048 (main-path width)", 1, S,
                           2048, 16, x_pad, [x_len], [y_len], torch.float32)
    f32 = timings(args32, F32_FLOP_PER_S, 4)

    log("flash_prefix_attention vs dense bf16 mha, B=1 D=2048 H=16 "
        "(x_len S/5, x_pad x_len+3, the rest audio):")
    crossover = None
    for S2 in (352, 1024, 1120, 2048, 4096):
        xl2 = S2 // 5
        q, k, v, xl, yl = inputs(1, S2, 2048, [xl2], [S2 - xl2 - 3],
                                 torch.bfloat16)
        a = (q, k, v, xl, yl, xl2 + 3, 16)
        bias = segment_padding_bias(S2, xl2 + 3, xl, yl)
        k_ms = cuda_ms(lambda: flash_prefix_attention(*a))
        p_ms = cuda_ms(lambda: flash_prefix_attention_plain(*a))
        d_ms = cuda_ms(lambda: mha(q, k, v, bias, 16))
        log(f"  S={S2}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"dense mha {d_ms:.4f} ms per call")
        if crossover is None and k_ms < d_ms:
            crossover = S2
    log(f"  crossover: the kernel beats dense mha from S={crossover} on "
        f"(FLASH_PREFILL_MIN_LEN stays 1024)")
    return dict(max_abs_err=err, **main, f32=f32)


def quantize_fp8(w):
    """[in, out] -> {'q': e4m3 [in, out], 'scale': bf16 [1, out]}, the
    per-output-channel layout of voicecraft_tpu/utils/quantize.py."""
    import torch
    scale = (w.float().abs().amax(dim=0, keepdim=True) / 448.0).clamp(min=1e-12)
    return {"q": (w.float() / scale).to(torch.float8_e4m3fn),
            "scale": scale.to(torch.bfloat16)}


def ffn_phase():
    """The fused FFN kernels against their plain version: bf16 x (the sm90
    kernel) at the main path's width for B = 1, 4, 8 and at edge widths,
    f32 x (the check kernel); every bf16 call repeated and replayed from a
    CUDA graph bit for bit; then kernel, plain and the unfused cuBLAS pair
    timed over a round robin of FFN_SETS weight sets, against the bound."""
    import torch
    from voicecraft_tpu_torch.ops.fused_decode import (ffn_sm90_blocks,
                                                       fused_ffn,
                                                       fused_ffn_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf = torch.bfloat16

    def weights(D, F, dtype=bf):
        def uni(shape, b):
            return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                    * b).to(dtype)
        return (uni((D, F), D ** -0.5), uni((F,), D ** -0.5),
                uni((F, D), F ** -0.5), uni((D,), F ** -0.5))

    def fp8(ws):
        w1, b1, w2, b2 = ws
        return quantize_fp8(w1), b1, quantize_fp8(w2), b2

    def rows(B, D, dtype=bf):
        return torch.randn((B, D), generator=gen, device="cuda").to(dtype)

    def check_case(name, x, ws):
        got = fused_ffn(x, *ws)
        want = fused_ffn_plain(x, *ws)
        torch.cuda.synchronize()
        if x.dtype == bf:
            err = check_ulps(name, got, want, FFN_ULPS)
            if not torch.equal(fused_ffn(x, *ws), got):
                raise AssertionError(f"{name}: two calls differ")
            if not replay_matches_eager(lambda: fused_ffn(x, *ws)):
                raise AssertionError(f"{name}: CUDA-graph replay differs")
        else:
            err = (got - want).abs().max().item()
            check(name, err, TOL_FFN_F32)
        return err

    log("fused_ffn vs plain; bf16 calls repeated and replayed bit for bit:")
    for D, F in ((1024, 4096), (512, 2048), (64, 256)):
        ws = weights(D, F)
        for B in (1, 8):
            x = rows(B, D)
            check_case(f"bf16 B={B} D={D} F={F}, bf16 weights", x, ws)
            check_case(f"bf16 B={B} D={D} F={F}, fp8 weights", x, fp8(ws))
    # the host's side of a call (the decode step is host-bound): enqueue
    # time at tiny_test's width, where the device keeps up with the host
    ws, x = weights(64, 256), rows(1, 64)
    for _ in range(50):
        fused_ffn(x, *ws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        fused_ffn(x, *ws)
    host_us = (time.perf_counter() - t0) / 500 * 1e6
    torch.cuda.synchronize()
    log(f"  host time per call (enqueue, B=1 D=64 F=256, 500 calls): "
        f"{host_us:.1f} us")
    D, F = 2048, 8192
    ws32 = weights(D, F, torch.float32)
    for B in (1, 8):
        x = rows(B, D, torch.float32)
        check_case(f"f32 B={B} D={D} F={F}, f32 weights", x, ws32)
        check_case(f"f32 B={B} D={D} F={F}, fp8 weights", x, fp8(ws32))
    del ws32

    sets = [weights(D, F) for _ in range(FFN_SETS)]
    fp8_sets = [fp8(ws) for ws in sets]
    log(f"fused_ffn at D={D} F={F}, times over a round robin of {FFN_SETS} "
        f"weight sets (CUDA-graph replays); the library call is the unfused "
        f"cuBLAS pair addmm, relu, addmm on the bf16 weights:")
    result = None
    for B in (1, 4, 8):
        x = rows(B, D)
        library_ms = graph_ms([
            lambda ws=ws: torch.addmm(ws[3], torch.relu(torch.addmm(ws[1], x, ws[0])),
                                      ws[2]) for ws in sets])
        for label, ss, elt in (("bf16", sets, 2), ("fp8", fp8_sets, 1)):
            err = check_case(f"B={B} {label} weights", x, ss[0])
            ms = graph_ms([lambda ws=ws: fused_ffn(x, *ws) for ws in ss])
            plain_ms = graph_ms([lambda ws=ws: fused_ffn_plain(x, *ws)
                                 for ws in ss])
            # weights, x, out and the biases once (fp8: the f32 scales too)
            nbytes = (2 * D * F * elt + 2 * B * D * 2 + (F + D) * 2
                      + (F + D) * 4 * (elt == 1))
            bound_ms, bound_by = bound(nbytes, 4 * B * D * F, BF16_FLOP_PER_S)
            log(f"  B={B} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"cuBLAS pair {library_ms:.4f} ms per call; bound "
                f"{bound_ms:.4f} ms ({bound_by}), the kernel at "
                f"{bound_ms / ms:.0%} of it, {nbytes / ms / 1e9:.2f} TB/s")
            # one call's per-block timeline, after the others' weights
            # streamed through L2: us from the first block's start
            for ws in ss[1:]:
                fused_ffn(x, *ws)
            trace = torch.zeros((ffn_sm90_blocks(F), 4), dtype=torch.int64,
                                device="cuda")
            fused_ffn(x, *ss[0], trace=trace)
            t = (trace - trace[:, 0].min()).double().cpu() / 1e3
            log(f"    timeline of {t.shape[0]} blocks (us): weight streams end "
                f"{t[:, 1].min():.2f} / {t[:, 1].median():.2f} / "
                f"{t[:, 1].max():.2f} (min / median / max), barrier passed "
                f"{t[:, 2].max():.2f}, last block done {t[:, 3].max():.2f}")
            if B == 1 and label == "bf16":            # the main path's shape
                result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=library_ms)
    return result


# ---- phase 4 -----------------------------------------------------------------

class Request:
    def __init__(self, name, wav, transcript, scfg, fused_ffn):
        self.name, self.wav, self.transcript = name, wav, transcript
        self.scfg, self.fused_ffn = scfg, fused_ffn


def prefill_inputs(model, x, prefix):
    """A request's prefill on the card, for text ids x and a composed
    prefix: (embedded prefix, x_lens, y_lens, x_pad, y_pad)."""
    import torch
    from voicecraft_tpu_torch.inference.tts import decode_geometry, pad_inputs
    from voicecraft_tpu_torch.models.voicecraft import embed_prefix
    cfg = model.cfg
    x_pad, y_pad, _ = decode_geometry(cfg, len(x), prefix.length, gen_max=16)
    xt, yt, mi, _ = pad_inputs(cfg, x, prefix, x_pad, y_pad, "cuda")
    xl = torch.tensor([len(x)], dtype=torch.int32, device="cuda")
    yl = torch.tensor([prefix.length], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        emb = embed_prefix(model, xt, yt, mi)
    return emb, xl, yl, x_pad, y_pad


def token_columns(model, n: int):
    """The step embeddings [D] of n random delayed-space columns (seed 7)."""
    import torch
    from voicecraft_tpu_torch.models.voicecraft import column_embedding
    cfg = model.cfg
    tokens = torch.randint(0, cfg.audio_vocab_size, (n, cfg.n_codebooks),
                           generator=torch.Generator(device="cuda").manual_seed(7),
                           device="cuda")
    with torch.inference_mode():
        return [column_embedding(model, t) for t in tokens]


def teacher_forced_logits(model, x, prefix, step_embs, plain: bool):
    """Logits after prefill and after each teacher-forced decode step, one
    step per embedding [D] of step_embs, through the kernels (plain=False)
    or through their plain versions and the unfused FFN (plain=True)."""
    import torch
    from voicecraft_tpu_torch.models import transformer as trm
    from voicecraft_tpu_torch.models.voicecraft import apply_heads, step_input
    from voicecraft_tpu_torch.ops.flash_attention import (
        flash_prefix_attention_plain, prefill_attention)
    cfg = model.cfg
    emb, xl, yl, x_pad, y_pad = prefill_inputs(model, x, prefix)
    if plain:
        attn = lambda q, k, v: flash_prefix_attention_plain(q, k, v, xl, yl,
                                                            x_pad, cfg.nhead)
    else:
        attn = prefill_attention(xl, yl, x_pad, cfg.nhead, x_pad + y_pad)
    cache = trm.init_kv_cache(cfg.num_decoder_layers, 1,
                              x_pad + y_pad + len(step_embs), cfg.nhead,
                              cfg.head_dim, model.dtype, "cuda")
    out = []
    with torch.inference_mode():
        h, cache = trm.prefill(model.decoder, emb, attn, cache)
        out.append(apply_heads(model.heads, h[:, x_pad + prefix.length - 1]))
        pos = torch.tensor(x_pad + prefix.length, device="cuda")
        y_pos = torch.tensor(prefix.length, device="cuda")
        x_len = torch.tensor(len(x), device="cuda")
        for e in step_embs:
            h, cache = trm.decode_step_fast(
                model.decoder, step_input(model, e, y_pos), cache, pos,
                x_len=x_len, x_pad=x_pad, fused_ffn=not plain)
            out.append(apply_heads(model.heads, h[:, 0]))
            pos += 1
            y_pos += 1
    return out


def prefill_times(model, x, prefix):
    """A request's prefill (trm.prefill over every layer) in ms, through
    prefill_attention (the attention kernel at S >= 1024) and through dense
    mha, from CUDA events."""
    import torch
    from voicecraft_tpu_torch.models import transformer as trm
    from voicecraft_tpu_torch.ops.attention import mha, segment_padding_bias
    from voicecraft_tpu_torch.ops.flash_attention import prefill_attention
    cfg = model.cfg
    emb, xl, yl, x_pad, y_pad = prefill_inputs(model, x, prefix)
    S = x_pad + y_pad
    bias = segment_padding_bias(S, x_pad, xl, yl)
    cache = trm.init_kv_cache(cfg.num_decoder_layers, 1, S, cfg.nhead,
                              cfg.head_dim, model.dtype, "cuda")
    paths = (("kernel", prefill_attention(xl, yl, x_pad, cfg.nhead, S)),
             ("dense mha", lambda q, k, v: mha(q, k, v, bias, cfg.nhead)))
    with torch.inference_mode():
        return S, {name: cuda_ms(lambda: trm.prefill(model.decoder, emb, attn,
                                                     cache), reps=5, warmup=2)
                   for name, attn in paths}


# ---- phase 5 -----------------------------------------------------------------

class EditRequest:
    def __init__(self, name, wav, target, intervals, scfg, fused_ffn):
        self.name, self.wav, self.target = name, wav, target
        self.intervals, self.scfg, self.fused_ffn = intervals, scfg, fused_ffn


def kept_frames_verbatim(res, codes, intervals, span_frames) -> bool:
    """Each kept interval of codes stands in res at its offset after the
    generated spans before it, and nothing else is in res."""
    starts = [s for s, _ in intervals]
    ends = [e for _, e in intervals]
    off = 0
    for j, (lo, hi) in enumerate(zip([0] + ends, starts + [codes.shape[1]])):
        if not np.array_equal(res[:, off:off + hi - lo], codes[:, lo:hi]):
            return False
        off += hi - lo + (span_frames[j] if j < len(span_frames) else 0)
    return off == res.shape[1]


def edit_phase(model, codec):
    """Phase 5: two multi-span edits on the main path (launch counts set to
    0 before and read after), then the kernel path's logits against the
    plain path's across a span transition.  Returns the launch counts."""
    import torch
    from voicecraft_tpu_torch.data.phonemes import (build_vocab,
                                                    make_text_tokenizer,
                                                    phones_to_ids)
    from voicecraft_tpu_torch.data.spans import compose_edit_prefix
    from voicecraft_tpu_torch.inference.editing import inference_edit
    from voicecraft_tpu_torch.inference.tts import decode_geometry
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import (SamplingConfig,
                                                        column_embedding)
    from voicecraft_tpu_torch.ops import _native
    from voicecraft_tpu_torch.utils import audio as au
    cfg = model.cfg
    K, L = cfg.n_codebooks, cfg.num_decoder_layers
    with torch.no_grad():
        model.heads.b2[0, cfg.eog] += EOG_BIAS
    log(f"[5 editing] codebook 0's eog bias raised by {EOG_BIAS}")

    # the requests' inputs, as edit_torch_cli.py makes them: text ids of the
    # target transcript, codes of the whole recording
    tok = make_text_tokenizer("en-us", "grapheme")
    demo = au.load_audio(str(REPO / "demo" / "demo.wav"), 16000)
    requests = [
        EditRequest("d", np.tile(demo, (1, EDIT_TILES)),
                    " ".join([EDIT_TARGET] * EDIT_TILES),
                    [(200, 240), (520, 570), (860, 900)],
                    SamplingConfig(top_k=40, top_p=1.0, temperature=1.0), True),
        EditRequest("e", demo, EDIT_TARGET, [(40, 70), (130, 160)],
                    SamplingConfig(top_k=40, top_p=1.0, temperature=0.0), False)]
    for r in requests:
        r.phones = tok.phonemize(r.target)
    vocab = build_vocab([r.phones for r in requests])
    for r in requests:
        r.x = np.asarray(phones_to_ids(r.phones, vocab), np.int32)
        r.codes = ec.encode_bucketed(codec, r.wav)[0]
        r.prefix, r.queue_ids = compose_edit_prefix(r.codes, r.intervals, cfg)
    d = requests[0]
    x_pad, y_pad, _ = decode_geometry(cfg, len(d.x), d.prefix.length,
                                      is_tts=False, n_spans=len(d.intervals),
                                      gen_max=EDIT_GEN_MAX)
    if d.codes.shape[1] != 1080 or x_pad + y_pad < 1024:
        raise AssertionError(f"request (d): {d.codes.shape[1]} frames, "
                             f"prefill {x_pad} + {y_pad} < 1024")

    _native.reset_launch_counts()
    for r in requests:
        before = dict(_native.LAUNCHES)
        stats = {}
        t0 = time.time()
        res = inference_edit(model, r.x, r.codes, r.intervals, r.scfg,
                             seed=SEED, gen_max=EDIT_GEN_MAX,
                             fused_ffn=r.fused_ffn, stats=stats)
        wall = time.time() - t0
        wav = ec.decode_bucketed(codec, res[None])[0]
        d_flash = _native.LAUNCHES["flash_prefix_attention"] - before["flash_prefix_attention"]
        d_ffn = _native.LAUNCHES["fused_ffn"] - before["fused_ffn"]
        Sp, steps, feeds = stats["prefill_len"], stats["steps"], stats["feeds"]
        m, span_frames = len(r.intervals), stats["span_frames"]
        frames = sum(span_frames)
        log(f"  request ({r.name}): {r.codes.shape[1]} frames, {m} masked "
            f"intervals {r.intervals}, x_len {len(r.x)}, Sp {Sp}, "
            f"{'sampled' if r.scfg.temperature > 0 else 'greedy'}, fused_ffn "
            f"{r.fused_ffn}: {stats['spans_done']} spans done, frames "
            f"{span_frames}, {steps} forwards ({feeds} feeds) in {wall:.3f} s "
            f"= {frames / wall:.1f} frames/s ({steps / wall:.1f} forwards/s); "
            f"launches flash {d_flash}, ffn {d_ffn}")
        want_flash = L if Sp >= 1024 else 0
        want_ffn = L * steps if r.fused_ffn else 0
        if d_flash != want_flash or d_ffn != want_ffn:
            raise AssertionError(f"request ({r.name}): launches flash {d_flash} "
                                 f"(want {want_flash}), ffn {d_ffn} "
                                 f"(want {want_ffn})")
        masked = sum(e - s for s, e in r.intervals)
        if stats["spans_done"] != m or min(span_frames) <= 0:
            raise AssertionError(f"request ({r.name}): {stats['spans_done']} of "
                                 f"{m} spans done, frames {span_frames}")
        if not (kept_frames_verbatim(res, r.codes, r.intervals, span_frames)
                and res.shape == (K, r.codes.shape[1] - masked + frames)
                and wav.shape == (res.shape[1] * codec.cfg.hop_length,)
                and np.isfinite(wav).all()):
            raise AssertionError(f"request ({r.name}): bad output: result "
                                 f"{res.shape}, wav {wav.shape}, finite "
                                 f"{np.isfinite(wav).all()}")
    launches = dict(_native.LAUNCHES)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched by the edits")

    for r in requests:
        S, pre = prefill_times(model, r.x, r.prefix)
        log(f"  request ({r.name}) prefill, {L} layers at S={S}: "
            f"{pre['kernel']:.3f} ms through prefill_attention "
            f"({'the attention kernel' if S >= 1024 else 'dense'}), "
            f"{pre['dense mha']:.3f} ms through dense mha")

    # across a span transition at (d)'s geometry: K+4 tokens, the two feeds
    # the queue makes (the next span's mask embedding, an empty column),
    # then 8 tokens
    cols = token_columns(model, K + 12)
    with torch.inference_mode():
        feeds = [model.mask_emb[d.queue_ids[1]].to(model.dtype),
                 column_embedding(model, torch.full((K,), cfg.empty_token,
                                                    device="cuda"))]
    steps = cols[:K + 4] + feeds + cols[K + 4:]
    k_path = teacher_forced_logits(model, d.x, d.prefix, steps, plain=False)
    p_path = teacher_forced_logits(model, d.x, d.prefix, steps, plain=True)
    scale = max(t.abs().max().item() for t in p_path)
    errs = [(a - b).abs().max().item() for a, b in zip(k_path, p_path)]
    log(f"  logits at (d)'s geometry, kernel path vs plain path (max |logit| "
        f"{scale:.3f}):")
    check("after prefill", errs[0], TOL_LOGITS)
    check(f"after {K + 4} teacher-forced tokens", max(errs[1:K + 5]), TOL_LOGITS)
    check("after the mask and empty feeds", max(errs[K + 5:K + 7]), TOL_LOGITS)
    check("after 8 more tokens", max(errs[K + 7:]), TOL_LOGITS)
    return launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.data.phonemes import (build_vocab,
                                                    make_text_tokenizer,
                                                    phones_to_ids)
    from voicecraft_tpu_torch.data.spans import compose_tts_prefix
    from voicecraft_tpu_torch.inference.loader import load_codec, load_model
    from voicecraft_tpu_torch.inference.tts import decode_geometry, inference_tts
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    from voicecraft_tpu_torch.ops import _native
    from voicecraft_tpu_torch.utils import audio as au

    # ---- 1. device ----
    card = card_line()
    log(f"[1 device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----
    t0 = time.time()
    lib_path, build_log = _native.build()
    _native.lib()
    log(f"[2 build] {lib_path.relative_to(REPO)} in {time.time() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())

    # the requests' inputs, as tts_torch_cli.py makes them
    tok = make_text_tokenizer("en-us", "grapheme")
    demo = au.load_audio(str(REPO / "demo" / "demo.wav"), 16000)
    long_wav = np.tile(demo, (1, LONG_TILES))
    long_text = " ".join([PROMPT] * LONG_TILES)
    sampled = SamplingConfig(top_k=40, top_p=1.0, temperature=1.0)
    greedy = SamplingConfig(top_k=40, top_p=1.0, temperature=0.0)
    requests = [Request("a", long_wav, long_text, sampled, True),
                Request("b", long_wav, long_text, greedy, True),
                Request("c", demo, PROMPT, greedy, False)]
    for r in requests:
        r.phones = tok.phonemize(r.transcript + " " + TARGET)
    vocab = build_vocab([r.phones for r in requests])
    for r in requests:
        r.x = np.asarray(phones_to_ids(r.phones, vocab), np.int32)
    long_frames = -(-long_wav.shape[1] // 320)
    x_pad, y_pad, _ = decode_geometry(PRESETS["giga830M"](), len(requests[0].x),
                                      long_frames + 1, gen_max=GEN_MAX)
    if x_pad + y_pad < 1024:
        raise AssertionError(f"long prompt prefill {x_pad + y_pad} < 1024")

    # ---- 3. kernels vs plain ----
    log("[3 kernels]")
    repair_phase()
    flash = flash_phase((len(requests[0].x), x_pad, long_frames + 1, y_pad))
    ffn = ffn_phase()

    # ---- 4. the slice ----
    t0 = time.time()
    cfg, model, _ = load_model("giga830M", random_init=True, seed=SEED,
                               device="cuda")
    ccfg, codec = load_codec(None, random_init=True, seed=SEED, device="cuda",
                             codebook_size=cfg.audio_vocab_size)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[4 slice] giga830M {model.dtype} ({n_params / 1e6:.1f}M params) and "
        f"codec built in {time.time() - t0:.1f} s")

    _native.reset_launch_counts()
    for r in requests:
        before = dict(_native.LAUNCHES)
        t0 = time.time()
        codes = ec.encode_bucketed(codec, r.wav)[0]
        t_enc = time.time() - t0
        stats = {}
        t0 = time.time()
        full, gen = inference_tts(model, r.x, codes, r.scfg, seed=SEED,
                                  gen_max=GEN_MAX, fused_ffn=r.fused_ffn,
                                  stats=stats)
        wall = time.time() - t0
        t0 = time.time()
        wav = ec.decode_bucketed(codec, full[None])[0]
        t_dec = time.time() - t0
        d_flash = _native.LAUNCHES["flash_prefix_attention"] - before["flash_prefix_attention"]
        d_ffn = _native.LAUNCHES["fused_ffn"] - before["fused_ffn"]
        Sp, steps = stats["prefill_len"], stats["steps"]
        log(f"  request ({r.name}): prompt {r.wav.shape[1] / 16000:.2f} s = "
            f"{codes.shape[1]} frames, x_len {len(r.x)}, Sp {Sp}, "
            f"{'sampled' if r.scfg.temperature > 0 else 'greedy'}, "
            f"fused_ffn {r.fused_ffn}: {steps} decode steps, {gen.shape[1]} "
            f"frames in {wall:.3f} s = {gen.shape[1] / wall:.1f} frames/s "
            f"({steps / wall:.1f} steps/s); encode {t_enc:.3f} s, "
            f"decode {t_dec:.3f} s; launches flash {d_flash}, ffn {d_ffn}")
        L = cfg.num_decoder_layers
        want_flash = L if Sp >= 1024 else 0
        want_ffn = L * steps if r.fused_ffn else 0
        if d_flash != want_flash or d_ffn != want_ffn:
            raise AssertionError(f"request ({r.name}): launches flash {d_flash} "
                                 f"(want {want_flash}), ffn {d_ffn} "
                                 f"(want {want_ffn})")
        if not (np.array_equal(full[:, :codes.shape[1]], codes)
                and full.shape == (cfg.n_codebooks, codes.shape[1] + gen.shape[1])
                and wav.shape == (full.shape[1] * ccfg.hop_length,)
                and np.isfinite(wav).all()):
            raise AssertionError(f"request ({r.name}): bad output: full "
                                 f"{full.shape}, wav {wav.shape}, finite "
                                 f"{np.isfinite(wav).all()}")
    launches = dict(_native.LAUNCHES)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched by the slice")

    long_prefix = compose_tts_prefix(ec.encode_bucketed(codec, long_wav)[0], cfg)
    steps = token_columns(model, 16)
    k_path = teacher_forced_logits(model, requests[0].x, long_prefix, steps,
                                   plain=False)
    p_path = teacher_forced_logits(model, requests[0].x, long_prefix, steps,
                                   plain=True)
    scale = max(t.abs().max().item() for t in p_path)
    errs = [(a - b).abs().max().item() for a, b in zip(k_path, p_path)]
    log(f"  logits, kernel path vs plain path (max |logit| {scale:.3f}):")
    check("after prefill", errs[0], TOL_LOGITS)
    check("after 16 teacher-forced decode steps", max(errs[1:]), TOL_LOGITS)
    S, pre = prefill_times(model, requests[0].x, long_prefix)
    log(f"  request (a) prefill, {cfg.num_decoder_layers} layers at S={S}: "
        f"{pre['kernel']:.3f} ms through the attention kernel, "
        f"{pre['dense mha']:.3f} ms through dense mha")

    # ---- 5. editing ----
    edit_launches = edit_phase(model, codec)
    launches = {name: n + edit_launches[name] for name, n in launches.items()}

    kernels = [
        dict(name="flash_prefix_attention", route="cuda",
             source="voicecraft_tpu_torch/csrc/flash_prefix_attention_sm90.cu",
             replaces="voicecraft_tpu/ops/flash_attention.py:82",
             variant={"bf16": "sm90 wgmma+tma "
                              "(csrc/flash_prefix_attention_sm90.cu)",
                      "f32": "simt (csrc/flash_prefix_attention.cu)"},
             launches=launches["flash_prefix_attention"], **flash),
        dict(name="fused_ffn", route="cuda",
             source="voicecraft_tpu_torch/csrc/fused_ffn_sm90.cu",
             replaces="voicecraft_tpu/ops/fused_decode.py:58",
             variant={"bf16": "sm90 tma+mma.sync, one cooperative launch "
                              "(csrc/fused_ffn_sm90.cu)",
                      "f32": "simt (csrc/fused_ffn.cu)"},
             launches=launches["fused_ffn"], **ffn),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
