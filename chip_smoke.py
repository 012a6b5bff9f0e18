#!/usr/bin/env python3
"""Smoke run of the PyTorch port (voicecraft_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device   the card's name and power limit; TF32 off in matmuls and cuDNN
  2. build    the CUDA kernels from voicecraft_tpu_torch/csrc (nvcc, sm_90a)
  3. kernels  the bf16 rounding points of mha, decode_attention_self,
              apply_heads and the fp8 _proj / apply_heads on the card against
              the same functions on CPU copies of the inputs; the codec on
              the card under PyTorch's default TF32 flags (the CLIs') against
              the CPU, codes exactly; the bf16 _proj per element against the
              f32 product rounded once, at the decode step's and serving's
              shapes; each kernel
              against its plain PyTorch version on the card, at the main
              paths' shapes (the attention kernel at B=1, for best-of-N B=4,
              and for serving B=8 with distinct per-lane lengths; the FFN on the layers of a giga830M-width stack and on
              quantize_decoder_fp8's output of them) and at edge shapes,
              against a stated tolerance; the fused FFN's bf16 calls repeated
              and replayed from a CUDA graph bit for bit; kernel, plain and
              library times from CUDA-graph replays (the FFN over a round
              robin of weight sets larger than L2) beside the bound computed
              from the shapes; the attention kernel's grid, and its time
              against dense mha over a range of S
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
              tokens, the two queued feeds, 8 more tokens).  The eog bias
              is restored afterwards.
  6. paths    the same model and codec: (f) best-of-N, N=4 paths of request
              (b)'s prompt prefilled through the attention kernel at B=4,
              sampled through inference_tts_batch, and greedy, whose kept
              path must equal request (b)'s greedy output under the
              tie-aware rule; (g) the fp8 decoder, quantize_decoder_fp8(
              pack_qkv=True) of the same weights, serving requests (a) and
              (b) with the fused FFN on its fp8 route: launch counts by
              route, kernel-path vs plain-path logits, fp8 vs bf16 logits,
              weight bytes, and one decode step's device time and device
              operations in both precisions; (h) speculative TTS at (b)'s
              geometry with three random MTP head groups and tau=4: greedy
              output equal to (b)'s under the tie-aware rule, tau tokens per
              pass under force_accept, a stochastic-verification run, and
              the device operations per pass; (i) speculative editing of
              request (d) with tau=4 and the eog bias raised: every span
              ends non-empty, kept frames verbatim.  Each path's launch
              counts are set to 0 just before it and read just after.
  7. serving  the same model and codec through inference/serving.py, each
              wave's launch counts set to 0 just before it and read just
              after (the attention kernel L times per prefill from 1024
              columns, never in a step; no FFN kernel): (j) 8 distinct TTS
              requests (prompts of 2-17 s cut from demo.wav, per-lane seeds),
              prefilled through the attention kernel at B=8, sampled and
              greedy, three greedy lanes against their own single-stream
              decode under the tie-aware rule, device operations and device
              ms per step at B=1 and B=8 (torch.profiler over 16 steps of a
              short wave, the prefill outside the window); (k) bench.py's serving geometry, 32
              lanes of the fp8 decoder with the fp8 KV slab and with a bf16
              slab: slab bytes, frames/s, device ms per step, peak
              allocation, the fp8 slab's logits against the bf16 slab's over
              16 teacher-forced steps; (l) 4 distinct edit requests of 1-3
              spans with the eog bias raised, greedy and sampled: greedy
              lanes end every span non-empty, sampled lanes end or reach the
              budget, kept frames verbatim everywhere, and the greedy wave's
              own rows, two lanes against their single-stream edit under
              ties; (m) speculative serving
              with 3 random MTP head groups, tau 4: the 8 TTS lanes greedy
              against (j)'s under ties, force_accept at 4 tokens a pass a
              lane, and the 4 edit lanes; (n) bench_mode at bench.py's
              single-stream geometry, bf16 and fp8 with the fp8 slab (frames/s
              best of 3), and the speculative loop (one run): exactly gen_max
              rows each.

The last three lines are the card (as nvidia-smi reports it), one JSON
object with each kernel's result, and {"ok": true, "device": {...}}.
"""

import contextlib
import json
import re
import subprocess
import sys
import time
import types
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
# the speculative edit (phase 6 (i)) draws under per-token-index keys, so
# its spans are other samples than phase 5's: the budget leaves room for
# spans twice as long (one run on an H100 drew spans of 321, 30 and 21)
SPEC_EDIT_GEN_MAX = 2 * EDIT_GEN_MAX
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
# fp8 weight-only against bf16, logits after prefill, relative in norm: an
# e4m3 weight carries 3 mantissa bits (a relative rounding error of up to
# 2^-4, ~1.8% rms), which moves each product by ~2% of its scale; the JAX
# package holds its fp8 hidden states within 5% of bf16 (tests/
# test_quantize.py), and the logits, through 16 layers and the heads, within
# 10% is the bound here
FP8_REL_TOL = 0.10
# the codec's wav from one set of codes, card vs CPU: both decode in f32
# (no TF32), so the difference is summation order through ~30 conv layers
# and an LSTM, far under 1e-3 of a signal of amplitude ~1
CODEC_WAV_TOL = 1e-3
N_BEST = 4                           # best-of-N paths (phase 6 (f))
N_MTP = 3                            # MTP head groups (phase 6 (h), (i))
TAU = 4                              # tokens per speculative pass
# phase 7 (j): 8 lanes, prompts cut from demo.wav tiled to 17.28 s, each
# lane's text (words of PROMPT and TARGET) ~10 phones a second of prompt,
# so that its length cap lies past the prompt; the wave's pads: Sp 1024,
# through the attention kernel at B=8
SERVE_SECONDS = (2.0, 3.2, 4.32, 6.0, 8.5, 11.0, 14.0, 17.28)
SERVE_PADS = (128, 896, GEN_MAX)     # x_pad, y_pad, gen_max
SERVE_SEEDS = tuple(range(11, 19))
SERVE_COMPARED = (0, 4, 7)           # greedy lanes held against one stream
PROFILE_STEPS = 16                   # serving steps in a profiled window
# phase 7 (k): bench.py's serving geometry (bench.py:663-688) and (n) its
# single-stream one (bench.py:190-209)
BENCH_LANES, BENCH_X_PAD, BENCH_Y_PAD, BENCH_PROMPT = 32, 128, 192, 150
BENCH_PHONES, BENCH_FRAMES = 120, 500
# the fp8 KV slab against a bf16 slab, logits relative in norm, 16 teacher-
# forced steps of the fp8 decoder: e4m3 keeps 3 mantissa bits, so each k/v
# is off by up to 2^-4 of itself (~1.8% rms), as each fp8 weight is; the
# attention averages those errors over hundreds of keys and the logits carry
# them through 16 layers, so the fp8 weights' bound (FP8_REL_TOL) holds here
KV_FP8_REL_TOL = 0.10
# phase 7 (l): 4 edit lanes, the recordings of (d) and (e) and two more
EDIT_SERVE = (("d", [(200, 240), (520, 570), (860, 900)]),
              ("e", [(40, 70), (130, 160)]),
              ("d", [(300, 360)]),
              ("dd", [(60, 100), (300, 330)]))


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

def repair_phase(tf32_defaults):
    """The port's bf16 rounding points on the card (cuBLAS with f32 output)
    against the same functions on CPU copies of the inputs, at giga830M
    width: f32 logits, probs cast to bf16, one rounding after p@v; then the
    codec under the CLIs' TF32 flags and the bf16 _proj (codec_check,
    proj_check)."""
    import copy
    import types
    import torch
    from voicecraft_tpu_torch.models.transformer import _proj
    from voicecraft_tpu_torch.models.voicecraft import Heads, apply_heads
    from voicecraft_tpu_torch.utils.quantize import _quantize_matrix
    from voicecraft_tpu_torch.ops.attention import (
        decode_attention_multi, decode_attention_multi_block,
        decode_attention_self, mha, segment_padding_bias)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bf = torch.bfloat16

    def randn(*shape, std=2.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(bf)

    def compare(name, fn, *args, ulps=1):
        got = fn(*args).float()
        cpu = [a.cpu() if isinstance(a, (torch.Tensor, torch.nn.Module)) else a
               for a in args]
        want = fn(*cpu).float()
        scale = want.abs().max().item()
        tol = ulps * bf16_ulp(scale).item() + REPAIR_F32_SLACK * scale
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
    # lockstep serving's slab products at B > 1 (ops/attention.py:
    # slab_scores / slab_pv, one product over the lanes with block-diagonal
    # queries), per-lane lengths at phase 7 (j)'s geometry
    B8, (sx, sy, sg) = 8, SERVE_PADS
    S_max, y_start = sx + sy + sg, sx + sy
    xls = torch.tensor([18, 28, 37, 47, 66, 82, 103, 128], device="cuda")
    pls = torch.tensor([101, 161, 217, 301, 426, 551, 701, 896], device="cuda")
    gls = torch.tensor([0, 3, 17, 40, 77, 101, 150, 252], device="cuda")
    for T in (1, TAU):
        args = (randn(B8, T, D), randn(B8, S_max, H, D // H),
                randn(B8, S_max, H, D // H), randn(B8, T, H, D // H),
                randn(B8, T, H, D // H))
        if T == 1:
            name = "decode_attention_multi"
            attn = lambda q, kc, vc, kn, vn: decode_attention_multi(
                q, kc, vc, torch.tensor(y_start + 100, device=q.device), kn,
                vn, H, xls.to(q.device), sx, pls.to(q.device), y_start)
        else:
            name = "decode_attention_multi_block"
            attn = lambda q, kc, vc, kn, vn: decode_attention_multi_block(
                q, kc, vc, gls.to(q.device), kn, vn, H, xls.to(q.device), sx,
                pls.to(q.device), y_start)
        compare(f"{name} B={B8} T={T} slab {S_max}", attn, *args)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        attn(*args)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        slab = args[1].numel() * args[1].element_size()
        log(f"  {name} allocates {extra} bytes at peak beside a {slab}-byte "
            f"K slab")
        if extra >= slab:
            raise AssertionError(f"{name} copied the KV slab")
    heads = Heads(4, D, 1024, 2052, bf, "cuda")
    heads.init_weights(torch.Generator(device="cuda").manual_seed(SEED + 3))
    compare("apply_heads D=2048 N=4", lambda hd, h: apply_heads(hd, h),
            copy.deepcopy(heads), randn(4, D, std=1.0))
    # the fp8 forms: _proj rounds its product to bf16 before the scale,
    # apply_heads scales in f32
    fp8_heads = types.SimpleNamespace(w1=_quantize_matrix(heads.w1), b1=heads.b1,
                                      w2=_quantize_matrix(heads.w2), b2=heads.b2)
    compare("apply_heads fp8 D=2048 N=4",
            lambda w1, b1, w2, b2, h: apply_heads(types.SimpleNamespace(
                w1=w1, b1=b1, w2=w2, b2=b2), h),
            fp8_heads.w1, fp8_heads.b1, fp8_heads.w2, fp8_heads.b2,
            randn(4, D, std=1.0))
    # two more bf16 roundings after the product (the scale, the bias), each
    # of which a flipped product rounding can move by one more ulp
    w = _quantize_matrix(randn(D, 3 * D, std=D ** -0.5))
    compare("_proj fp8 [4, 2048] x [2048, 6144]", _proj, randn(4, D, std=1.0),
            w, randn(3 * D, std=0.02), ulps=2)
    codec_check(tf32_defaults)
    proj_check()


@contextlib.contextmanager
def tf32_flags(cudnn: bool, matmul: bool):
    """torch.backends' TF32 flags set inside the block, restored after."""
    import torch
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def codec_check(tf32_defaults):
    """The 16 kHz codec (random weights from SEED) on the card under the
    TF32 flags the CLIs run with (PyTorch's defaults, tf32_defaults), and on
    the CPU: demo.wav's codes compared exactly, and the wav decoded from the
    CPU's codes within CODEC_WAV_TOL on both."""
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.inference.loader import load_codec
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.utils import audio as au
    card = PRESETS["giga830M"]().audio_vocab_size
    ccfg, codec = load_codec(None, random_init=True, seed=SEED, device="cuda",
                             codebook_size=card)
    cpu = ec.Encodec(ccfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in codec.state_dict().items()})
    demo = au.load_audio(str(REPO / "demo" / "demo.wav"), 16000)
    want = ec.encode_bucketed(cpu, demo)
    with tf32_flags(*tf32_defaults):
        got = ec.encode_bucketed(codec, demo)
        wav = ec.decode_bucketed(codec, want)
    n_diff = int((got != want).sum())
    err = float(np.abs(wav - ec.decode_bucketed(cpu, want)).max())
    log(f"codec on the card under the CLIs' TF32 flags (cudnn "
        f"{tf32_defaults[0]}, matmul {tf32_defaults[1]}) vs the CPU, "
        f"demo.wav ({want.shape[-1]} frames x {want.shape[1]} codebooks): "
        f"{n_diff} of {want.size} codes differ (must be 0); decoded wav max "
        f"abs err {err:.3e} (tolerance {CODEC_WAV_TOL:g})")
    if n_diff or not err <= CODEC_WAV_TOL:
        raise AssertionError(f"codec card vs CPU: {n_diff} codes differ, wav "
                             f"err {err}")


def proj_check():
    """The bf16 _proj on the card per element against the f32 product
    rounded once to bf16 (JAX's _proj), at the decode step's and serving's
    shapes, zero bias: at most 1 bf16 ulp of the output's largest
    magnitude (one flipped rounding)."""
    import torch
    from voicecraft_tpu_torch.models.transformer import _proj
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bf = torch.bfloat16
    log("bf16 _proj on the card vs the f32 product rounded once "
        f"(allow_bf16_reduced_precision_reduction "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}):")
    for m, k, n in ((1, 2048, 2048), (1, 2048, 8192), (1, 8192, 2048),
                    (32, 2048, 2048), (32, 2048, 8192), (32, 8192, 2048)):
        x = torch.randn((m, k), generator=gen, device="cuda").to(bf)
        w = ((torch.rand((k, n), generator=gen, device="cuda") * 2 - 1)
             * k ** -0.5).to(bf)
        b = torch.zeros((n,), dtype=bf, device="cuda")
        got = _proj(x, w, b).float()
        want = (x.float() @ w.float()).to(bf).float()
        ulp = bf16_ulp(want.abs().max()).item()
        diff = (got - want).abs()
        log(f"  x [{m}, {k}] @ [{k}, {n}]: max abs err {diff.max().item():.3e}"
            f" = {diff.max().item() / ulp:.2f} ulps of max |out| "
            f"{want.abs().max().item():.3f}; elements off: "
            f"{int((diff > 0).sum())} of {diff.numel()} (tolerance 1 ulp)")
        if not diff.max().item() <= ulp:
            raise AssertionError(f"_proj [{m}, {k}] x [{k}, {n}]: "
                                 f"{diff.max().item() / ulp} ulps")


def flash_phase(geom_long, geom_serve):
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
    # best-of-N's prefill: N_BEST copies of the main path's prompt
    name = f"bf16 B={N_BEST} S={S} D=2048 H=16 (best-of-N prefill)"
    err4, args4, _, _ = case(name, N_BEST, S, 2048, 16, x_pad,
                             [x_len] * N_BEST, [y_len] * N_BEST, torch.bfloat16)
    cases = [dict(case=name, max_abs_err=err4,
                  **timings(args4, BF16_FLOP_PER_S, 2))]
    # serving's prefill (phase 7 (j)): 8 lanes, each with its own text and
    # prompt lengths; the longest prompt set to fill y_pad, the shortest
    # ending inside the first key tile of the prompt segment
    sx_pad, sy_pad, sx_lens, sy_lens = geom_serve
    sy_lens = list(sy_lens)
    sy_lens[sy_lens.index(max(sy_lens))] = sy_pad
    first_tile_end = (sx_pad // bq + 1) * bq
    if not sx_pad + min(sy_lens) < first_tile_end:
        raise AssertionError(f"the shortest lane's prompt ends at "
                             f"{sx_pad + min(sy_lens)}, past the first key "
                             f"tile of the prompt (ends {first_tile_end})")
    name = (f"bf16 B={len(sx_lens)} S={sx_pad + sy_pad} D=2048 H=16 (serving "
            f"prefill, x_lens {sx_lens}, y_lens {sy_lens})")
    err8, args8, _, _ = case(name, len(sx_lens), sx_pad + sy_pad, 2048, 16,
                             sx_pad, sx_lens, sy_lens, torch.bfloat16)
    cases.append(dict(case=name, max_abs_err=err8,
                      **timings(args8, BF16_FLOP_PER_S, 2)))
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
    return dict(max_abs_err=err, **main, f32=f32, cases=cases)


def ffn_phase():
    """The fused FFN kernels against their plain version: bf16 x (the sm90
    kernel) at the main path's width for B = 1, 4, 8 and at edge widths,
    f32 x (the check kernel); every bf16 call repeated and replayed from a
    CUDA graph bit for bit; then kernel, plain and the unfused cuBLAS pair
    timed over a round robin of FFN_SETS weight sets, against the bound."""
    import dataclasses
    import torch
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.models.voicecraft import VoiceCraft
    from voicecraft_tpu_torch.ops.fused_decode import (ffn_sm90_blocks,
                                                       fused_ffn,
                                                       fused_ffn_plain)
    from voicecraft_tpu_torch.utils.quantize import (_quantize_matrix,
                                                     quantize_decoder_fp8)
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
        return _quantize_matrix(w1), b1, _quantize_matrix(w2), b2

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

    # the weight sets: the layers of a giga830M-width stack of FFN_SETS
    # layers with the model's init, and quantize_decoder_fp8's output of it
    stack = VoiceCraft(dataclasses.replace(PRESETS["giga830M"](),
                                           num_decoder_layers=FFN_SETS),
                       "cuda").init_weights(gen)
    layer_ffn = lambda layer: (layer.w1, layer.b1, layer.w2, layer.b2)
    sets = [layer_ffn(layer) for layer in stack.decoder.layers]
    fp8_sets = [layer_ffn(layer) for layer
                in quantize_decoder_fp8(stack).decoder.layers]
    log(f"fused_ffn at D={D} F={F}, times over a round robin of the "
        f"{FFN_SETS} layers of a giga830M-width stack, bf16 and as "
        f"quantize_decoder_fp8 leaves them (CUDA-graph replays); the library "
        f"call is the unfused cuBLAS pair addmm, relu, addmm on the bf16 "
        f"weights:")
    result, cases = None, []
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
            numbers = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
            if B == 1 and label == "bf16":            # the main path's shape
                result = dict(numbers, library_ms=library_ms)
            elif B == 1:
                # no library call takes fp8 weights with bf16 x
                cases.append(dict(case="fp8 weights of quantize_decoder_fp8, "
                                       "B=1 D=2048 F=8192",
                                  **numbers, library_ms=None))
    return dict(result, cases=cases)


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


@contextlib.contextmanager
def raised_eog_bias(model):
    """Codebook 0's eog bias raised by EOG_BIAS inside the block, restored
    bit for bit after it."""
    import torch
    saved = model.heads.b2.detach().clone()
    with torch.no_grad():
        model.heads.b2[0, model.cfg.eog] += EOG_BIAS
    try:
        yield
    finally:
        with torch.no_grad():
            model.heads.b2.copy_(saved)


def edit_requests(model, codec):
    """Requests (d) and (e), their inputs made as edit_torch_cli.py makes
    them: text ids of the target transcript, codes of the whole recording,
    the composed prefix and the queued mask ids."""
    from voicecraft_tpu_torch.data.phonemes import (build_vocab,
                                                    make_text_tokenizer,
                                                    phones_to_ids)
    from voicecraft_tpu_torch.data.spans import compose_edit_prefix
    from voicecraft_tpu_torch.inference.tts import decode_geometry
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    from voicecraft_tpu_torch.utils import audio as au
    cfg = model.cfg
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
    return requests


def edit_phase(model, codec, requests):
    """Phase 5: two multi-span edits on the main path (launch counts set to
    0 before and read after), then the kernel path's logits against the
    plain path's across a span transition.  Returns the launch counts."""
    import torch
    from voicecraft_tpu_torch.inference.editing import inference_edit
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import column_embedding
    from voicecraft_tpu_torch.ops import _native
    cfg = model.cfg
    K, L = cfg.n_codebooks, cfg.num_decoder_layers
    d = requests[0]
    log(f"[5 editing] codebook 0's eog bias raised by {EOG_BIAS}")

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



# ---- phase 6 -----------------------------------------------------------------

class DrawRecorder:
    """Inside the block, every draw of the port's decode loops keeps a
    device copy of the adjusted logits it samples from (no host sync), and
    every speculative pass notes its first token index, so that each token
    index maps to the logits it was finally drawn from."""

    def __enter__(self):
        import voicecraft_tpu_torch.inference.serving as sv
        import voicecraft_tpu_torch.inference.spec_common as sc
        import voicecraft_tpu_torch.models.voicecraft as vc
        self.logits, self.passes = [], []
        self._mods = (vc, sc, sv)
        self._orig = (vc.sample, sc.spec_verify_pass)
        sample, spec_pass = self._orig

        def recording_sample(generator, lg, *a, **kw):
            self.logits.append(lg.detach().clone())
            return sample(generator, lg, *a, **kw)

        def recording_pass(*a, **kw):
            self.passes.append((kw["t"], len(self.logits), kw["tau"]))
            return spec_pass(*a, **kw)

        vc.sample = recording_sample
        sc.spec_verify_pass = sv.spec_verify_pass = recording_pass
        return self

    def __exit__(self, *exc):
        (vc, sc, sv), (sample, spec_pass) = self._mods, self._orig
        vc.sample = sample
        sc.spec_verify_pass = sv.spec_verify_pass = spec_pass

    def lane(self, b):
        """by_index of lane b (each draw [B, K, card]; a serving pass's t is
        the lanes' token counts [B], a single stream's one int)."""
        if not self.passes:
            return [la[b] for la in self.logits]
        out = {}
        for t, first, tau in self.passes:
            tb = t if isinstance(t, int) else int(t[b])
            for i in range(tau):
                out[tb + i] = self.logits[first + i][b]
        return [out[k] for k in sorted(out)]

    def by_index(self):
        """The logits of each token index: the draws in order for a plain
        loop; for an exact-verification speculative loop (tau draws a pass,
        the first at the pass's token index t, each draw [1, K, card]) the
        last draw of each index, which is the accepted one."""
        return self.lane(0) if self.passes else self.logits


def same_under_ties(name, got, ref, got_la, ref_la):
    """Recorded rows got / ref [n, K] (numpy) with the logits each row was
    drawn from: equal up to their first difference, where both draws (on
    the same prefix) must agree within TOL_LOGITS and ref's top-2 margin
    must be under twice their largest difference, a near-tie that the
    paths' other bf16 summation orders may flip.  Without a difference,
    equal in length too."""
    import torch
    n = min(len(got), len(ref))
    g, r = torch.stack(got_la[:n]), torch.stack(ref_la[:n])
    if g.shape != r.shape:
        raise AssertionError(f"{name}: draws {tuple(g.shape)} against "
                             f"{tuple(r.shape)}")
    diff = (g - r).abs().reshape(n, -1).amax(dim=1).cpu()
    for j in range(n):
        if not np.array_equal(got[j], ref[j]):
            top2 = ref_la[j].float().topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).min().item()
            log(f"  {name}: the first {j} rows equal, then a near-tie: top-2 "
                f"margin {margin:.4f}, the two draws' logits differ by "
                f"{diff[j]:.4f} there (at most {diff[:j + 1].max():.4f} "
                f"along the way)")
            if not (diff[:j + 1].max() <= TOL_LOGITS and margin <= 2 * diff[j]):
                raise AssertionError(f"{name}: rows differ at {j} beyond a tie")
            return j
    log(f"  {name}: all {n} rows equal; logits within {diff.max():.4f}")
    if len(got) != len(ref):
        raise AssertionError(f"{name}: {len(got)} rows against {len(ref)}")
    return n


def device_ops(fn):
    """(fn(), the CUDA kernels and memory operations the device ran during
    it, from torch.profiler; None when it saw no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return out, n or None


def step_profile(run, n):
    """(device operations, device ms) per step of the serving wave that
    run() decodes, from torch.profiler over n whole steps: the profiler
    starts at the wave's second decode_step_multi and stops at its
    (n + 2)-th, so the window holds n forwards, n sampler calls and their
    bookkeeping, and not the prefill.  The wave must run n + 2 steps or
    more.  Each step ends in a host sync, so the window's device time must
    fit in its wall time.  (None, None) when the profiler saw no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from voicecraft_tpu_torch.models import transformer as trm
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    step, calls, marks = trm.decode_step_multi, [0], []

    def marked(*a, **kw):
        calls[0] += 1
        if calls[0] in (2, n + 2):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if len(marks) == 1:
                prof.start()
            else:
                prof.stop()
        return step(*a, **kw)

    trm.decode_step_multi = marked
    try:
        run()
    finally:
        trm.decode_step_multi = step
        if len(marks) == 1:
            prof.stop()
    if len(marks) < 2:
        raise AssertionError(f"the profiled wave ended before {n + 2} steps")
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        return None, None
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    window = (marks[1] - marks[0]) * 1e3
    if busy > window:
        raise AssertionError(f"the profiler's device ms {busy:.3f} exceed "
                             f"the window's wall ms {window:.3f}")
    return len(ev) / n, busy / n


def step_costs(model, x, prefix, fused_ffn):
    """One decode step (decode_step_fast and the heads) at a request's
    geometry: device ms from CUDA-graph replays, and device operations per
    step over 8 eager steps."""
    import torch
    from voicecraft_tpu_torch.models import transformer as trm
    from voicecraft_tpu_torch.models.voicecraft import apply_heads, step_input
    from voicecraft_tpu_torch.ops.flash_attention import prefill_attention
    cfg = model.cfg
    emb, xl, yl, x_pad, y_pad = prefill_inputs(model, x, prefix)
    cache = trm.init_kv_cache(cfg.num_decoder_layers, 1, x_pad + y_pad + 8,
                              cfg.nhead, cfg.head_dim, model.dtype, "cuda")
    col = token_columns(model, 1)[0]
    with torch.inference_mode():
        trm.prefill(model.decoder, emb,
                    prefill_attention(xl, yl, x_pad, cfg.nhead, x_pad + y_pad),
                    cache)
        pos = torch.tensor(x_pad + prefix.length, device="cuda")
        y_pos = torch.tensor(prefix.length, device="cuda")
        x_len = torch.tensor(len(x), device="cuda")
        x_t = step_input(model, col, y_pos)

        def step():
            h, _ = trm.decode_step_fast(model.decoder, x_t, cache, pos,
                                        x_len=x_len, x_pad=x_pad,
                                        fused_ffn=fused_ffn)
            return apply_heads(model.heads, h[:, 0])

        ms = graph_ms([step])
        _, ops = device_ops(lambda: [step() for _ in range(8)])
    return ms, None if ops is None else ops / 8


def block_vs_step_logits(model, x, prefix, step_embs):
    """Max |logit difference| at each of the step_embs [D] fed after the
    prefill, through decode_step_block in blocks of TAU against
    decode_step_fast one at a time (unfused FFN both)."""
    import torch
    from voicecraft_tpu_torch.models import transformer as trm
    from voicecraft_tpu_torch.models.voicecraft import apply_heads
    from voicecraft_tpu_torch.ops.flash_attention import prefill_attention
    cfg = model.cfg
    emb, xl, yl, x_pad, y_pad = prefill_inputs(model, x, prefix)
    S = x_pad + y_pad
    dtype = model.dtype
    pe = model.pe[prefix.length:prefix.length + len(step_embs)].to(dtype)
    feed = (torch.stack(step_embs) + model.alpha_audio.to(dtype) * pe)[None]
    out = []
    with torch.inference_mode():
        for block in (1, TAU):
            cache = trm.init_kv_cache(cfg.num_decoder_layers, 1,
                                      S + len(step_embs), cfg.nhead,
                                      cfg.head_dim, dtype, "cuda")
            trm.prefill(model.decoder, emb,
                        prefill_attention(xl, yl, x_pad, cfg.nhead, S), cache)
            x_len = torch.tensor(len(x), device="cuda")
            hs = []
            for i in range(0, len(step_embs), block):
                pos = torch.tensor(x_pad + prefix.length + i, device="cuda")
                step = trm.decode_step_fast if block == 1 else trm.decode_step_block
                h, _ = step(model.decoder, feed[:, i:i + block], cache, pos,
                            x_len=x_len, x_pad=x_pad)
                hs.append(h[0])
            out.append(apply_heads(model.heads, torch.cat(hs)))
    return (out[0] - out[1]).abs().amax(dim=(1, 2)).tolist()


def weight_bytes(module) -> int:
    return sum(t.numel() * t.element_size()
               for t in module.state_dict().values())


def check_launches(name, got, want):
    """The launch counts of one path (reset just before it) against what it
    must launch; each kernel of the path launched at least once."""
    log(f"  ({name}) launches: " + ", ".join(f"{k} {v}" for k, v in got.items()))
    for k, v in want.items():
        if got[k] != v:
            raise AssertionError(f"({name}): {k} launched {got[k]} times, "
                                 f"want {v}")


def paths_phase(model, codec, requests, edits, ccfg):
    """Phase 6: best-of-N, the fp8 decoder, speculative TTS and speculative
    editing, each path with its launch counts set to 0 just before it and
    read just after.  Returns the launch counts of each path."""
    import dataclasses
    import torch
    from voicecraft_tpu_torch.data.spans import compose_tts_prefix
    from voicecraft_tpu_torch.inference.editing import inference_edit
    from voicecraft_tpu_torch.inference.tts import (decode_geometry,
                                                    inference_tts,
                                                    inference_tts_batch,
                                                    inference_tts_spec,
                                                    pad_inputs, run_decode)
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import (SamplingConfig,
                                                        init_mtp_heads,
                                                        make_batch_tts_loop,
                                                        make_spec_decode_loop)
    from voicecraft_tpu_torch.ops import _native
    from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
    cfg = model.cfg
    L = cfg.num_decoder_layers
    a, b = requests[0], requests[1]
    prefix = compose_tts_prefix(b.codes, cfg)
    x_pad, y_pad, gen_max = decode_geometry(cfg, len(b.x), prefix.length,
                                            gen_max=GEN_MAX)
    Sp = x_pad + y_pad
    xt, yt, mi, _ = pad_inputs(cfg, b.x, prefix, x_pad, y_pad, "cuda")
    sampled = SamplingConfig(top_k=40, top_p=1.0, temperature=1.0)
    greedy = SamplingConfig(top_k=40, top_p=1.0, temperature=0.0)
    out = []

    def finite_wav(name, full):
        wav = ec.decode_bucketed(codec, full[None])[0]
        if not (wav.shape == (full.shape[1] * ccfg.hop_length,)
                and np.isfinite(wav).all()):
            raise AssertionError(f"({name}): wav {wav.shape}, finite "
                                 f"{np.isfinite(wav).all()}")

    # request (b) greedy, the reference of (f) and (h), with its draws
    with DrawRecorder() as rec:
        ref, _ = run_decode(model, is_tts=True, x_tokens=b.x, prefix=prefix,
                            n_spans=1, scfg=greedy, seed=SEED, gen_max=GEN_MAX,
                            return_raw=True, fused_ffn=True)
    ref_la = rec.by_index()
    log(f"[6 paths] reference: request (b) greedy, {len(ref)} rows")

    # ---- (f) best-of-N ----
    _native.reset_launch_counts()
    stats = {}
    t0 = time.time()
    full, gen = inference_tts_batch(model, b.x, b.codes, sampled,
                                    batch_size=N_BEST, seed=SEED,
                                    gen_max=GEN_MAX, stats=stats)
    wall = time.time() - t0
    launches = dict(_native.LAUNCHES)
    steps = stats["steps"]
    log(f"  (f) best-of-{N_BEST}, sampled, Sp {stats['prefill_len']}: {steps} "
        f"forwards at B={N_BEST}, path {stats['keep']} kept, {gen.shape[1]} "
        f"frames in {wall:.3f} s = {gen.shape[1] / wall:.1f} frames/s "
        f"({steps / wall:.1f} forwards/s); kernel launches per forward: "
        f"flash 0 ({launches['flash_prefix_attention']} in the prefill), "
        f"ffn 0")
    check_launches("f", launches, {"flash_prefix_attention": L, "fused_ffn": 0})
    finite_wav("f", full)
    out.append(launches)
    loop = make_batch_tts_loop(cfg, batch_size=N_BEST, x_pad=x_pad, y_pad=y_pad,
                               gen_max=gen_max, scfg=greedy)
    with DrawRecorder() as rec:
        res = loop(model, xt, len(b.x), yt, prefix.length, mi, None)
    got = res.gen_buf[:res.gen_cnt, res.keep].cpu().numpy()
    same_under_ties(f"(f) greedy best-of-{N_BEST} kept path vs (b)", got, ref,
                    [la[res.keep] for la in rec.logits], ref_la)

    # ---- (g) the fp8 decoder ----
    qmodel = quantize_decoder_fp8(model, pack_qkv=True)
    log(f"  (g) fp8 weight-only, packed qkv: decoder weights "
        f"{weight_bytes(model.decoder)} bytes in bf16, "
        f"{weight_bytes(qmodel.decoder)} in fp8; heads "
        f"{weight_bytes(model.heads)} / {weight_bytes(qmodel.heads)}")
    _native.reset_launch_counts()
    for r in (a, b):
        before = dict(_native.LAUNCHES)
        stats = {}
        t0 = time.time()
        full, gen = inference_tts(qmodel, r.x, r.codes, r.scfg, seed=SEED,
                                  gen_max=GEN_MAX, fused_ffn=True, stats=stats)
        wall = time.time() - t0
        steps = stats["steps"]
        d_ffn = _native.LAUNCHES["fused_ffn"] - before["fused_ffn"]
        log(f"  (g) request ({r.name}) fp8, "
            f"{'sampled' if r.scfg.temperature > 0 else 'greedy'}, fused FFN: "
            f"{steps} forwards, {gen.shape[1]} frames in {wall:.3f} s = "
            f"{gen.shape[1] / wall:.1f} frames/s ({steps / wall:.1f} "
            f"forwards/s); ffn launches per forward {d_ffn / steps:.1f}")
        if d_ffn != L * steps:
            raise AssertionError(f"(g) request ({r.name}): {d_ffn} FFN "
                                 f"launches, want {L * steps}")
        finite_wav("g", full)
    launches = dict(_native.LAUNCHES)
    routes = dict(_native.ROUTE_LAUNCHES)
    log(f"  (g) launches by route: {routes}")
    check_launches("g", launches, {"flash_prefix_attention": 2 * L,
                                   "fused_ffn": launches["fused_ffn"]})
    if routes.get("fused_ffn:sm90/fp8", 0) != launches["fused_ffn"] or \
            launches["fused_ffn"] == 0:
        raise AssertionError(f"(g): FFN launches off the fp8 route: {routes}")
    out.append(launches)
    long_prefix = compose_tts_prefix(a.codes, cfg)
    cols = token_columns(model, 16)
    k_path = teacher_forced_logits(qmodel, a.x, long_prefix, cols, plain=False)
    p_path = teacher_forced_logits(qmodel, a.x, long_prefix, cols, plain=True)
    errs = [(u - v).abs().max().item() for u, v in zip(k_path, p_path)]
    log(f"  (g) fp8 logits, kernel path vs plain path:")
    check("after prefill", errs[0], TOL_LOGITS)
    check("after 16 teacher-forced decode steps", max(errs[1:]), TOL_LOGITS)
    bf = teacher_forced_logits(model, a.x, long_prefix, [], plain=True)[0]
    q8 = p_path[0]
    rel = ((q8 - bf).norm() / bf.norm()).item()
    agree = (q8.argmax(-1) == bf.argmax(-1)).float().mean().item()
    log(f"  (g) fp8 vs bf16 logits after prefill: max abs diff "
        f"{(q8 - bf).abs().max().item():.4f}, relative (norm) {rel:.4f} "
        f"(tolerance {FP8_REL_TOL}), top-1 agreement over the codebooks "
        f"{agree:.2f}")
    if not rel <= FP8_REL_TOL:
        raise AssertionError(f"(g) fp8 vs bf16 logits: {rel} > {FP8_REL_TOL}")
    for label, m in (("bf16", model), ("fp8", qmodel)):
        for fused in (False, True):
            ms, ops = step_costs(m, a.x, long_prefix, fused)
            log(f"  (g) decode step at (a)'s geometry, {label} weights, "
                f"{'fused' if fused else 'unfused'} FFN: {ms:.4f} ms of device "
                f"time (CUDA-graph replays), "
                f"{'not measured' if ops is None else f'{ops:.1f}'} device "
                f"operations per step")
    del qmodel

    # ---- (h) speculative TTS ----
    model.mtp_heads = init_mtp_heads(
        dataclasses.replace(cfg, n_mtp=N_MTP),
        torch.Generator(device="cuda").manual_seed(SEED + 4), "cuda")
    log(f"  (h) {N_MTP} random MTP head groups, tau {TAU}")
    with DrawRecorder() as rec:     # the loop binds the recording pass
        loop = make_spec_decode_loop(cfg, x_pad=x_pad, y_pad=y_pad,
                                     gen_max=gen_max, scfg=greedy, n_draft=TAU)
        res = loop(model, xt, len(b.x), yt, prefix.length, mi, SEED)
    got = res.gen_buf[:res.gen_cnt].cpu().numpy()
    same_under_ties("(h) greedy speculative vs (b)", got, ref, rec.by_index(),
                    ref_la)
    errs = block_vs_step_logits(model, a.x, compose_tts_prefix(a.codes, cfg),
                                token_columns(model, 16))
    log(f"  (h) logits of 16 teacher-forced tokens, blocks of {TAU} "
        f"(decode_step_block) vs one at a time (decode_step_fast):")
    check("largest difference", max(errs), TOL_LOGITS)
    runs = (("greedy", greedy, False), ("greedy, force_accept", greedy, True),
            ("sampled, stochastic verification",
             dataclasses.replace(sampled, spec_sampling="stochastic"), False))
    _native.reset_launch_counts()
    for label, scfg, force in runs:
        before = dict(_native.LAUNCHES)
        t0 = time.time()
        full, gen, st = inference_tts_spec(model, b.x, b.codes, scfg,
                                           n_draft=TAU, seed=SEED,
                                           gen_max=GEN_MAX, return_stats=True,
                                           force_accept=force)
        wall = time.time() - t0
        d_flash = (_native.LAUNCHES["flash_prefix_attention"]
                   - before["flash_prefix_attention"])
        log(f"  (h) {label}, Sp {st['prefill_len']}: {st['tokens']} tokens in "
            f"{st['passes']} passes ({st['tokens_per_pass']:.2f} tokens/pass), "
            f"{gen.shape[1]} frames in {wall:.3f} s = {gen.shape[1] / wall:.1f} "
            f"frames/s ({st['passes'] / wall:.1f} passes/s); kernel launches "
            f"per pass: flash 0 ({d_flash} in the prefill), ffn 0")
        if force and st["passes"] != -(-st["tokens"] // TAU):
            raise AssertionError(f"(h) force_accept: {st['tokens']} tokens in "
                                 f"{st['passes']} passes, not {TAU} a pass")
        finite_wav("h", full)
    launches = dict(_native.LAUNCHES)
    check_launches("h", launches, {"flash_prefix_attention": 3 * L,
                                   "fused_ffn": 0})
    out.append(launches)
    (_, _, st), ops = device_ops(lambda: inference_tts_spec(
        model, b.x, b.codes, greedy, n_draft=TAU, seed=SEED, gen_max=128,
        return_stats=True, force_accept=True))
    per_pass = "not measured" if ops is None else f"{ops / st['passes']:.1f}"
    log(f"  (h) device operations per pass (force_accept, {st['passes']} "
        f"passes, the prefill included): {per_pass}")

    # ---- (i) speculative editing ----
    d = edits[0]
    with raised_eog_bias(model):
        _native.reset_launch_counts()
        stats = {}
        t0 = time.time()
        res = inference_edit(model, d.x, d.codes, d.intervals, d.scfg,
                             seed=SEED, gen_max=SPEC_EDIT_GEN_MAX, stats=stats,
                             spec=TAU)
        wall = time.time() - t0
    launches = dict(_native.LAUNCHES)
    m, span_frames = len(d.intervals), stats["span_frames"]
    frames = sum(span_frames)
    log(f"  (i) speculative edit of ({d.name}), tau {TAU}, eog bias raised by "
        f"{EOG_BIAS}, Sp {stats['prefill_len']}: {stats['spans_done']} spans "
        f"done, frames {span_frames}, {stats['steps']} passes ({stats['feeds']} "
        f"feed passes) in {wall:.3f} s = {frames / wall:.1f} frames/s "
        f"({stats['steps'] / wall:.1f} passes/s); kernel launches per pass: "
        f"flash 0 ({launches['flash_prefix_attention']} in the prefill), ffn 0")
    check_launches("i", launches, {"flash_prefix_attention": L, "fused_ffn": 0})
    masked = sum(e - s for s, e in d.intervals)
    if stats["spans_done"] != m or min(span_frames) <= 0:
        raise AssertionError(f"(i): {stats['spans_done']} of {m} spans done, "
                             f"frames {span_frames}")
    if not (kept_frames_verbatim(res, d.codes, d.intervals, span_frames)
            and res.shape == (cfg.n_codebooks, d.codes.shape[1] - masked + frames)):
        raise AssertionError(f"(i): bad output {res.shape}")
    finite_wav("i", res)
    out.append(launches)
    del model.mtp_heads
    return out

# ---- phase 7 -----------------------------------------------------------------

def serving_texts():
    """(j)'s lane texts: words of PROMPT and TARGET, lane b from word 3b on,
    up to 22 phones for the 2 s prompt and 128 for the 17.28 s one (the
    lanes' length caps, 10 frames a phone, lie past their prompts)."""
    from voicecraft_tpu_torch.data.phonemes import make_text_tokenizer
    tok = make_text_tokenizer("en-us", "grapheme")
    words = (PROMPT + " " + TARGET).split()
    lo, hi = SERVE_SECONDS[0], SERVE_SECONDS[-1]
    texts = []
    for b, sec in enumerate(SERVE_SECONDS):
        want = round(22 + 106 * (sec - lo) / (hi - lo))
        text, n = "", 0
        while True:
            cand = (text + " " + words[(3 * b + n) % len(words)]).strip()
            if len(tok.phonemize(cand)) > want:
                break
            text, n = cand, n + 1
        texts.append(text)
    return texts


def check_wav(name, codec, ccfg, codes):
    """The codec's wav of codes [K, T]: finite, T hops long."""
    from voicecraft_tpu_torch.models import encodec as ec
    wav = ec.decode_bucketed(codec, codes[None])[0]
    if not (wav.shape == (codes.shape[1] * ccfg.hop_length,)
            and np.isfinite(wav).all()):
        raise AssertionError(f"({name}): wav {wav.shape}, finite "
                             f"{np.isfinite(wav).all()}")


@contextlib.contextmanager
def serving_results():
    """Inside the block, the plain serving edit loops that serve_edit_batch
    makes append each ServingResult (rows, span of each row) to the list
    the block gets."""
    from voicecraft_tpu_torch.inference import serving as sv
    make, results = sv.make_serving_edit_loop, []

    def keeping(*a, **kw):
        loop = make(*a, **kw)

        def run(*args):
            results.append(loop(*args))
            return results[-1]
        return run

    sv.make_serving_edit_loop = keeping
    try:
        yield results
    finally:
        sv.make_serving_edit_loop = make


def edit_row_logits(draws, span_of, lane=None):
    """The draw each recorded edit row came from: every step draws (a feed
    step too, its draw thrown away), and each span transition feeds 2
    steps, so row r of span j is step r + 2j's draw."""
    pick = (lambda d: d) if lane is None else (lambda d: d[lane])
    return [pick(draws[r + 2 * int(j)]) for r, j in enumerate(span_of)]


def serving_phase(model, codec, ccfg, serve, edits):
    """Phase 7: lockstep serving (inference/serving.py) at giga830M, each
    wave with its launch counts set to 0 just before it and read just
    after.  Returns the launch counts of each wave."""
    import dataclasses
    import torch
    from voicecraft_tpu_torch.data.spans import (compose_edit_prefix,
                                                 compose_tts_prefix)
    from voicecraft_tpu_torch.inference import serving as sv
    from voicecraft_tpu_torch.inference.tts import (decode_geometry, pad_inputs,
                                                    run_decode)
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models import transformer as trm
    from voicecraft_tpu_torch.models.voicecraft import (
        SamplingConfig, apply_heads, init_mtp_heads, make_decode_loop,
        make_spec_decode_loop, prefill_lanes)
    from voicecraft_tpu_torch.ops import _native
    from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
    cfg = model.cfg
    K, L, H, Dh = (cfg.n_codebooks, cfg.num_decoder_layers, cfg.nhead,
                   cfg.head_dim)
    f8 = "float8_e4m3fn"
    sampled = SamplingConfig(top_k=40, top_p=1.0, temperature=1.0)
    greedy = SamplingConfig(top_k=40, top_p=1.0, temperature=0.0)
    bench_scfg = SamplingConfig(top_k=40, top_p=1.0, temperature=1.0,
                                stop_repetition=3)
    out = []

    def counted(label, fn, sp):
        """fn(), its wall s; the launch counts set to 0 just before and read
        just after: the attention kernel L times when the prefill has 1024
        columns or more, else never, and no FFN kernel."""
        _native.reset_launch_counts()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_native.LAUNCHES)
        check_launches(label, launches, {
            "flash_prefix_attention": L if sp >= 1024 else 0, "fused_ffn": 0})
        out.append(launches)
        return res, wall

    def per_step(label, m, reqs, pads, seeds, scfg, kv=None):
        """Device operations and device ms per step of the serving loop,
        over PROFILE_STEPS steps of one short wave (step_profile)."""
        g = PROFILE_STEPS + 2
        _, a = sv.tts_wave_inputs(m, reqs, pads[:2] + (g,))
        loop = sv.make_serving_tts_loop(
            cfg, batch_size=len(reqs), x_pad=pads[0], y_pad=pads[1],
            gen_max=g, scfg=scfg, kv_dtype=kv)
        costs, _ = counted(f"{label} profile", lambda: step_profile(
            lambda: loop(m, *a, seeds), PROFILE_STEPS), pads[0] + pads[1])
        return costs

    # ---- (j) TTS serving, 8 lanes ----
    for r in serve:
        r.codes = ec.encode_bucketed(codec, r.wav)[0]
    reqs = [(r.x, r.codes) for r in serve]
    B = len(reqs)
    pads, args = sv.tts_wave_inputs(model, reqs, SERVE_PADS)
    x_pad, y_pad, gen_max = pads
    Sp = x_pad + y_pad
    p_lens = [int(p) for p in args[3]]
    log(f"[7 serving] (j) {B} lanes, prompts {list(SERVE_SECONDS)} s: prefix "
        f"lengths {p_lens}, x_lens {[int(x) for x in args[1]]}, Sp {Sp}, "
        f"gen_max {gen_max}, seeds {list(SERVE_SEEDS)}")
    if p_lens != [r.prefix_len for r in serve]:
        raise AssertionError(f"(j): prefix lengths {p_lens}, phase 3's B={B} "
                             f"case took {[r.prefix_len for r in serve]}")
    stats = {}
    outs, wall = counted("j sampled", lambda: sv.serve_tts_batch(
        model, reqs, sampled, pads=SERVE_PADS, seeds=SERVE_SEEDS,
        stats=stats), Sp)
    frames = sum(g.shape[1] for _, g in outs)
    log(f"  (j) sampled: {stats['steps']} steps, lanes finished "
        f"{stats['done']}, frames {[g.shape[1] for _, g in outs]}: "
        f"{frames} frames in {wall:.3f} s = {frames / wall:.1f} frames/s "
        f"aggregate ({stats['steps'] / wall:.1f} steps/s)")
    if not (all(stats["done"]) or stats["steps"] == gen_max):
        raise AssertionError("(j) sampled: a lane neither ended nor reached "
                             "gen_max")
    for b, (full, _) in enumerate(outs):
        if not np.array_equal(full[:, :reqs[b][1].shape[1]], reqs[b][1]):
            raise AssertionError(f"(j) lane {b}: prompt not kept")
        check_wav(f"j lane {b}", codec, ccfg, full)
    # greedy: the serving loop itself, its draws recorded for the tie rule
    loop = sv.make_serving_tts_loop(cfg, batch_size=B, x_pad=x_pad,
                                    y_pad=y_pad, gen_max=gen_max, scfg=greedy)
    with DrawRecorder() as rec:
        res_j, wall = counted("j greedy", lambda: loop(model, *args,
                                                        SERVE_SEEDS), Sp)
    log(f"  (j) greedy: {res_j.steps} steps, lanes finished {res_j.done}, "
        f"rows {res_j.n_rows}: {sum(res_j.n_rows)} rows in {wall:.3f} s = "
        f"{sum(res_j.n_rows) / wall:.1f} rows/s aggregate "
        f"({res_j.steps / wall:.1f} steps/s)")
    j_rows = [res_j.gen_buf[:n, b].cpu().numpy()
              for b, n in enumerate(res_j.n_rows)]
    j_la = [rec.lane(b) for b in range(B)]
    for b in SERVE_COMPARED:
        x, codes = reqs[b]
        prefix = compose_tts_prefix(codes, cfg)
        gx, gy, _ = decode_geometry(cfg, len(x), prefix.length, gen_max=gen_max)
        with DrawRecorder() as rec1:
            (ref, _), _ = counted(f"j lane {b} single stream", lambda: run_decode(
                model, is_tts=True, x_tokens=x, prefix=prefix, n_spans=1,
                scfg=greedy, seed=SEED, gen_max=gen_max, return_raw=True),
                gx + gy)
        same_under_ties(f"(j) lane {b} ({SERVE_SECONDS[b]} s) vs its own "
                        f"single-stream decode", j_rows[b], ref, j_la[b],
                        rec1.by_index())
    for lanes in ([0], list(range(B))):
        ops, ms = per_step(f"j B={len(lanes)}", model,
                           [reqs[b] for b in lanes], SERVE_PADS,
                           [SERVE_SEEDS[b] for b in lanes], sampled)
        log(f"  (j) serving step at B={len(lanes)}, sampled: "
            f"{'not measured' if ops is None else f'{ops:.1f}'} device "
            f"operations and {'not measured' if ms is None else f'{ms:.4f}'} "
            f"device ms per step (torch.profiler, {PROFILE_STEPS} steps)")

    # ---- (k) bench.py's serving geometry: 32 lanes, fp8 weights ----
    qmodel = quantize_decoder_fp8(model, pack_qkv=True)
    rng = np.random.default_rng(SEED)
    bench = [(rng.integers(0, cfg.text_vocab_size, BENCH_X_PAD),
              rng.integers(0, cfg.audio_vocab_size, (K, BENCH_PROMPT)))
             for _ in range(BENCH_LANES)]
    kpads = (BENCH_X_PAD, BENCH_Y_PAD, GEN_MAX)
    _, kargs = sv.tts_wave_inputs(qmodel, bench, kpads)
    ksp = BENCH_X_PAD + BENCH_Y_PAD
    zeros = [0] * BENCH_LANES
    log(f"  (k) bench.py's serving geometry: {BENCH_LANES} lanes, x_pad "
        f"{BENCH_X_PAD}, y_pad {BENCH_Y_PAD}, {BENCH_PROMPT}-frame random "
        f"prompts, top-k 40, stop_repetition 3, gen_max {GEN_MAX}, "
        f"quantize_decoder_fp8(pack_qkv=True)")
    for kv in (f8, None):
        elt = 1 if kv else 2
        slab = L * 2 * BENCH_LANES * (ksp + GEN_MAX) * H * Dh * elt
        loop = sv.make_serving_tts_loop(cfg, batch_size=BENCH_LANES,
                                        x_pad=BENCH_X_PAD, y_pad=BENCH_Y_PAD,
                                        gen_max=GEN_MAX, scfg=bench_scfg,
                                        kv_dtype=kv)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res, wall = counted(f"k {kv or 'bf16'} slab", lambda: loop(
            qmodel, *kargs, zeros), ksp)
        peak = torch.cuda.max_memory_allocated() - base
        frames = sum(res.n_rows)
        ops, ms = per_step(f"k {kv or 'bf16'}", qmodel, bench, kpads, zeros,
                           bench_scfg, kv)
        log(f"  (k) {kv or 'bf16'} slab ({slab} bytes): {res.steps} steps, "
            f"{frames} frames in {wall:.3f} s = {frames / wall:.1f} frames/s "
            f"aggregate ({res.steps / wall:.1f} steps/s); "
            f"{'not measured' if ms is None else f'{ms:.4f}'} device ms and "
            f"{'not measured' if ops is None else f'{ops:.1f}'} device "
            f"operations per step; peak allocation over the weights "
            f"{peak} bytes")
    log(f"  (k) the fp8 slab is upcast to bf16 per layer and step: "
        f"{L * 2 * BENCH_LANES * (ksp + GEN_MAX) * H * Dh * 5} bytes of "
        f"device traffic a step at full length (1 read + 2 written + 2 read "
        f"per element) against the bf16 slab's "
        f"{L * 2 * BENCH_LANES * (ksp + GEN_MAX) * H * Dh * 2}")
    cols = token_columns(model, 16)
    x_t, x_l, y_t, p_l = kargs
    xl32 = torch.as_tensor(x_l, device="cuda").to(torch.int32)
    pl32 = torch.as_tensor(p_l, device="cuda").to(torch.int32)
    no_mask = torch.full((1, BENCH_Y_PAD), -1, device="cuda")
    tf = {}
    with torch.inference_mode():
        for kv in (None, f8):
            _, lg, cache = prefill_lanes(qmodel, x_t, xl32, y_t, pl32, no_mask,
                                         ksp + len(cols), kv)
            logits = [lg]
            pos = torch.tensor(ksp, device="cuda")
            for i, e in enumerate(cols):
                y_pos = pl32.long() + i
                feed = (e[None] + qmodel.alpha_audio.to(e.dtype)
                        * qmodel.pe[y_pos].to(e.dtype))[:, None]
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                h, cache = trm.decode_step_multi(
                    qmodel.decoder, feed, cache, pos, xl32, BENCH_X_PAD, pl32,
                    ksp)
                torch.cuda.synchronize()
                extra = torch.cuda.max_memory_allocated() - base
                logits.append(apply_heads(qmodel.heads, h[:, 0]))
                pos += 1
            layer = cache[0, 0].numel() * cache.element_size()
            log(f"  (k) {kv or 'bf16'} slab: one decode_step_multi allocates "
                f"{extra} bytes at peak beside a {layer}-byte K slab of one "
                f"layer")
            if kv is None and extra >= layer:
                raise AssertionError("(k): the bf16 slab was copied")
            tf[kv] = logits
    rel = max(((a - b).norm() / b.norm()).item()
              for a, b in zip(tf[f8], tf[None]))
    log(f"  (k) fp8 slab vs bf16 slab, logits after prefill and 16 "
        f"teacher-forced steps: relative (norm) at most {rel:.4f} "
        f"(tolerance {KV_FP8_REL_TOL})")
    if not rel <= KV_FP8_REL_TOL:
        raise AssertionError(f"(k) fp8 slab vs bf16: {rel}")

    # ---- (l) edit serving, 4 lanes ----
    d, e = edits
    dd_codes = ec.encode_bucketed(codec, np.tile(e.wav, (1, 2)))[0]
    src = {"d": (d.x, d.codes), "e": (e.x, e.codes),
           "dd": (d.x[:2 * len(e.x) + 1], dd_codes)}
    lanes = [(*src[k], iv) for k, iv in EDIT_SERVE]
    lpads0, _ = sv.edit_wave_inputs(model, lanes)
    lpads = lpads0[:2] + (EDIT_GEN_MAX,)
    lsp = lpads[0] + lpads[1]

    def edit_wave(label, scfg, spec=0, gen_max=EDIT_GEN_MAX):
        stats = {}
        res, wall = counted(label, lambda: sv.serve_edit_batch(
            model, lanes, scfg, seed=SEED, pads=lpads[:2] + (gen_max,),
            spec=spec, stats=stats), lsp)
        frames = stats["frames"]
        log(f"  ({label}) {len(lanes)} edit lanes {[len(iv) for *_, iv in lanes]}"
            f" spans, Sp {lsp}: {stats['steps']} "
            f"{'passes' if spec else 'steps'}, lanes done {stats['done']}, "
            f"span frames {stats['span_frames']}, {frames} rows in "
            f"{wall:.3f} s = "
            f"{frames / wall:.1f} rows/s aggregate")
        for b, ((_, codes, iv), r, sf) in enumerate(zip(lanes, res,
                                                         stats["span_frames"])):
            masked = sum(hi - lo for lo, hi in iv)
            # a greedy lane ends every span (plain: non-empty, as phase 5's;
            # speculative lanes part from them at near-ties); a sampled lane
            # may draw eog (biased up) at a span's first row, or stop at its
            # budget (the wave runs until every lane is done or there)
            if scfg.temperature <= 0 and not (stats["done"][b]
                                              and (spec or min(sf) > 0)):
                raise AssertionError(f"({label}) lane {b}: done "
                                     f"{stats['done'][b]}, span frames {sf}")
            if not (kept_frames_verbatim(r, codes, iv, sf) and r.shape == (
                    K, codes.shape[1] - masked + sum(sf))):
                raise AssertionError(f"({label}) lane {b}: bad result {r.shape}")
            check_wav(f"{label} lane {b}", codec, ccfg, r)

    with raised_eog_bias(model):
        log(f"  (l) codebook 0's eog bias raised by {EOG_BIAS}")
        with DrawRecorder() as rec, serving_results() as kept:
            edit_wave("l greedy", greedy)
        res_l, = kept
        edit_wave("l sampled", sampled)
        for b in (0, 1):
            x, codes, iv = lanes[b]
            n = res_l.n_rows[b]
            rows = res_l.gen_buf[:n, b].cpu().numpy()
            span_of = res_l.span_buf[:n, b].cpu().numpy()
            prefix, qids = compose_edit_prefix(codes, iv, cfg)
            gx, gy, _ = decode_geometry(cfg, len(x), prefix.length,
                                        is_tts=False, n_spans=len(iv),
                                        gen_max=EDIT_GEN_MAX)
            with DrawRecorder() as rec1:
                (ref, ref_span), _ = counted(
                    f"l lane {b} single stream", lambda: run_decode(
                        model, is_tts=False, x_tokens=x, prefix=prefix,
                        n_spans=len(iv), scfg=greedy, queue_mask_ids=qids,
                        seed=SEED, gen_max=EDIT_GEN_MAX, return_raw=True),
                    gx + gy)
            same_under_ties(f"(l) greedy lane {b} vs its own single-stream "
                            f"edit", rows, ref,
                            edit_row_logits(rec.logits, span_of, b),
                            edit_row_logits(rec1.logits, ref_span))

    # ---- (m) speculative serving ----
    model.mtp_heads = init_mtp_heads(
        dataclasses.replace(cfg, n_mtp=N_MTP),
        torch.Generator(device="cuda").manual_seed(SEED + 4), "cuda")
    log(f"  (m) {N_MTP} random MTP head groups, tau {TAU}")
    loop = sv.make_spec_serving_loop(cfg, batch_size=B, n_draft=TAU,
                                     x_pad=x_pad, y_pad=y_pad, gen_max=gen_max,
                                     scfg=greedy)
    with DrawRecorder() as rec:
        res_m, wall = counted("m greedy", lambda: loop(model, *args,
                                                        SERVE_SEEDS), Sp)
    frames = sum(res_m.n_rows)
    log(f"  (m) greedy: {res_m.steps} passes, rows {res_m.n_rows}, "
        f"{frames / res_m.steps / B:.2f} tokens per pass per lane, {frames} "
        f"rows in {wall:.3f} s = {frames / wall:.1f} rows/s aggregate")
    for b in range(B):
        same_under_ties(f"(m) speculative lane {b} vs (j) greedy lane {b}",
                        res_m.gen_buf[:res_m.n_rows[b], b].cpu().numpy(),
                        j_rows[b], rec.lane(b), j_la[b])
    loop = sv.make_spec_serving_loop(cfg, batch_size=B, n_draft=TAU,
                                     x_pad=x_pad, y_pad=y_pad, gen_max=gen_max,
                                     scfg=greedy, bench_mode=True,
                                     force_accept=True)
    res, wall = counted("m force_accept", lambda: loop(model, *args,
                                                        SERVE_SEEDS), Sp)
    per = sum(res.n_rows) / res.steps / B
    log(f"  (m) force_accept, bench_mode: {res.steps} passes, {per:.2f} "
        f"tokens per pass per lane, {sum(res.n_rows)} rows in {wall:.3f} s = "
        f"{sum(res.n_rows) / wall:.1f} rows/s aggregate")
    if res.n_rows != [gen_max] * B or res.steps * TAU != gen_max:
        raise AssertionError(f"(m) force_accept: rows {res.n_rows} in "
                             f"{res.steps} passes, not {TAU} a pass a lane")
    with raised_eog_bias(model):
        edit_wave("m edit", greedy, spec=TAU, gen_max=SPEC_EDIT_GEN_MAX)

    # ---- (n) bench_mode, bench.py's single-stream geometry ----
    rng = np.random.default_rng(SEED + 1)
    x = rng.integers(0, cfg.text_vocab_size, BENCH_PHONES)
    prefix = compose_tts_prefix(
        rng.integers(0, cfg.audio_vocab_size, (K, BENCH_PROMPT)), cfg)
    nx, ny, _ = decode_geometry(cfg, len(x), prefix.length, gen_max=16)
    xt, yt, mi, qm = pad_inputs(cfg, x, prefix, nx, ny, "cuda")
    log(f"  (n) bench_mode at bench.py's geometry: {BENCH_PHONES} phones, "
        f"{BENCH_PROMPT} prompt frames, {BENCH_FRAMES} frames, Sp {nx + ny}, "
        f"fused FFN")
    for label, m, kv in (("bf16", model, None), ("fp8, fp8 slab", qmodel, f8)):
        loop = make_decode_loop(cfg, is_tts=True, x_pad=nx, y_pad=ny,
                                gen_max=BENCH_FRAMES, scfg=bench_scfg,
                                bench_mode=True, fused_ffn=True, kv_dtype=kv)
        _native.reset_launch_counts()
        times, forwards = [], 0
        for i in range(3):
            t0 = time.time()
            res = loop(m, xt, len(x), yt, prefix.length, mi, qm, 1,
                       torch.Generator(device="cuda").manual_seed(i))
            times.append(time.time() - t0)
            forwards += res.forwards
            if res.gen_cnt != BENCH_FRAMES:
                raise AssertionError(f"(n) {label}: {res.gen_cnt} rows, not "
                                     f"{BENCH_FRAMES}")
        launches = dict(_native.LAUNCHES)
        check_launches(f"n {label}", launches, {
            "flash_prefix_attention": 0, "fused_ffn": L * forwards})
        out.append(launches)
        log(f"  (n) {label}: {BENCH_FRAMES} rows each of 3 runs, best "
            f"{min(times):.3f} s = {BENCH_FRAMES / min(times):.1f} frames/s")
    # one run: with random MTP heads nearly every sampled draft is rejected,
    # so it takes ~1 pass a row
    loop = make_spec_decode_loop(cfg, x_pad=nx, y_pad=ny, gen_max=BENCH_FRAMES,
                                 scfg=bench_scfg, n_draft=TAU, bench_mode=True)
    res, wall = counted("n speculative", lambda: loop(
        model, xt, len(x), yt, prefix.length, mi, SEED), nx + ny)
    log(f"  (n) speculative, tau {TAU}, bench_mode: {res.gen_cnt} rows in "
        f"{res.passes} passes, {wall:.3f} s = {res.gen_cnt / wall:.1f} "
        f"frames/s (one run)")
    if res.gen_cnt != BENCH_FRAMES:
        raise AssertionError(f"(n) speculative: {res.gen_cnt} rows")
    del model.mtp_heads, qmodel
    return out


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
    # the CLIs run under PyTorch's defaults (phase 3 checks the codec there)
    tf32_defaults = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
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
    # phase 7 (j)'s lanes: prompts cut from demo.wav tiled, their texts
    cfg0 = PRESETS["giga830M"]()
    serve = []
    for sec, text in zip(SERVE_SECONDS, serving_texts()):
        wav = long_wav[:, :round(sec * 16000)]
        serve.append(types.SimpleNamespace(
            wav=wav, x=np.asarray(phones_to_ids(tok.phonemize(text), vocab),
                                  np.int32),
            prefix_len=compose_tts_prefix(np.zeros(
                (cfg0.n_codebooks, -(-wav.shape[1] // 320)), np.int64),
                cfg0).length))

    # ---- 3. kernels vs plain ----
    log("[3 kernels]")
    repair_phase(tf32_defaults)
    flash = flash_phase((len(requests[0].x), x_pad, long_frames + 1, y_pad),
                        (SERVE_PADS[0], SERVE_PADS[1], [len(r.x) for r in serve],
                         [r.prefix_len for r in serve]))
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
        codes = r.codes = ec.encode_bucketed(codec, r.wav)[0]
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
    edits = edit_requests(model, codec)
    with raised_eog_bias(model):
        edit_launches = edit_phase(model, codec, edits)
    launches = {name: n + edit_launches[name] for name, n in launches.items()}

    # ---- 6. best-of-N, fp8, speculative TTS and editing ----
    t0 = time.time()
    for path_launches in paths_phase(model, codec, requests, edits, ccfg):
        launches = {name: n + path_launches[name]
                    for name, n in launches.items()}
    log(f"[6 paths] done in {time.time() - t0:.1f} s")

    # ---- 7. lockstep serving ----
    t0 = time.time()
    for wave_launches in serving_phase(model, codec, ccfg, serve, edits):
        launches = {name: n + wave_launches[name]
                    for name, n in launches.items()}
    log(f"[7 serving] done in {time.time() - t0:.1f} s")

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
