#!/usr/bin/env python3
"""Smoke run of the PyTorch port (voicecraft_tpu_torch) on one CUDA card
(and, with --cards 4, of its mesh on four).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device   the card's name and power limit; TF32 off in matmuls and cuDNN
  2. build    the CUDA kernels from voicecraft_tpu_torch/csrc (nvcc, sm_90a)
              into voicecraft_tpu_torch/build/kernels/<hash>/
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
              against dense mha over a range of S; the engine's ring
              attention over an fp8 slab against its plain version at
              tts830e.stream32's step shape and at small head dims, timed
              beside PyTorch's fused attention on the upcast slab; Kimi
              Linear's KDA recurrence (csrc/kda_recurrent.cu) against its
              plain version at kimilinear.stream32's decode shape (32
              lanes, T 1) and at a refill's prefill (1 lane, T 544, and a
              lane shorter than T), repeated and replayed bit for bit,
              timed against the state's bytes; and its launches, 20 an
              engine step, in a full-depth, full-width Kimi Linear stack
              (8 experts held) serving two requests through the engine
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
  6. paths    giga830M cut to PATH_DEPTH's 2 layers (full width, random
              weights from the same seed; phases 6-11 run this model) and
              the same codec: (f) best-of-N, N=4 paths of request
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
  7. serving  phase 6's model and the codec through inference/serving.py,
              each wave's launch counts set to 0 just before it and read just
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
              lane, and the 4 edit lanes; (n) the speculative loop in
              bench_mode at bench.py's single-stream geometry, 128 frames,
              one run: exactly gen_max rows (phase 14 (B) runs the plain
              loop's bench_mode, fused, bf16 and fp8 with the fp8 slab).
  8. engine   phase 6's model and the codec through inference/engine.py,
              inference/streaming.py and serve_torch_cli.py, each run's
              launch counts set to 0 just before it and read just after (the
              attention kernel L times per prefill call from 1024 columns:
              the startup wave at B=8 and every refill at B=1): (o) the
              continuous-batching engine, 16 requests ((j)'s 8 prompts, two
              texts each) over 8 lanes in bursts of 48, greedy (each request
              against its own single-stream decode under the tie-aware rule,
              its rows and draws kept by EngineRecorder) and sampled, device
              operations and ms per engine step (step_profile over one
              burst); 64 requests over 32 lanes at bench.py's engine
              geometry with fp8 weights and the fp8 slab; the speculative
              engine (random MTP heads, tau 4) greedy against the plain
              engine's rows and force_accept at 4 tokens a pass; (p)
              stream_tts of request (a)'s 17.28 s prompt (the kernel at
              B=1), greedy, pipeline on and off: the streamed frames are
              gen, gen against the single stream under ties, the streamed
              audio against decode_bucketed of gen, first-audio latency;
              (q) serve_torch_cli.Engine on giga830M behind a
              ThreadingHTTPServer on 127.0.0.1: /healthz, two concurrent
              /tts (one wave), /rerun, /edit with demo_alignment.csv's rows
              and /tts_stream of the 17.28 s prompt (the kernel), each HTTP
              200 with audio of the expected length, latencies printed.

  9. training giga830M at full width with the e830M recipe (ScaledAdam lr
              0.05, codebook weights 5 1 0.5 0.1, chunked attention, remat
              "attn", the preset's dropouts, f32 master weights, bf16
              compute) on a synthetic manifest of 256 + 16 utterances of
              2-20 s (write_manifest_tree, codes from a seed, phones of
              phase 7's texts): (r) forward_train's loss and every
              gradient at 2 layers, the card in bf16 against the CPU in f32,
              and chunked against dense attention on the card, within the
              stated tolerances; (s) Trainer.train at full depth, 8 steps at
              max_num_tokens 20,000 (the recipe's 100,000 cut), validate
              and save: finite metrics, no NaN skip, step 1's loss per token
              within 5% of ln(card) x mean(weights); tokens/s, s a step,
              the optimizer update's ms and device operations, peak memory,
              the device-busy share of two steps (torch.profiler); one fixed
              batch for 6 steps without dropout, its loss falling; the
              chunked attention's forward + backward for one layer beside
              PyTorch's fused attention under the same mask and the bound;
              (t) one step at the recipe's 100,000 tokens, its peak memory;
              (u) the checkpoint through load_model in bf16 serving request
              (a)'s prompt greedy (64 frames): the attention kernel launches
              16 times, the prompt frames stand verbatim, the wav is finite.
 10. toolbox  the icefall toolbox (models/scaling.py) on every path, each
              counted run's launch counts set to 0 just before it and read
              just after: (v) each scaling Function's forward and backward
              on the card in f32 and bf16 against the CPU in f32, on an
              activation of the e830M batch's shape [8, 1424, 2048]; (w)
              giga830M with basicnorm + doubleswish in bf16 at 2 layers,
              random weights from a seed, serving request (a)'s prompt
              greedy for 64 frames through inference_tts (the attention
              kernel L times, the
              fused FFN never: fused_ffn=True raises), forwards/s, the
              kernel path's logits against the plain path's after prefill
              and 16 teacher-forced steps, then 8 lanes through
              serve_tts_batch (the kernel at B=8), two greedy lanes against
              their single-stream decodes under the tie-aware rule; (x)
              forward_train's loss and every gradient with balancedbasicnorm
              + balanceddoubleswish at 2 layers, the card in bf16 against
              the CPU in f32, in the eval and the train form, and
              Trainer.train for 4 steps of the e830M recipe with basicnorm +
              doubleswish at 2 layers (finite metrics, no NaN skip, every
              log_eps moved; s a step, peak memory); (y) phase 9's
              checkpoint through export_torch_cli.py --format pth, reloaded
              through load_model: the state dict and one prefill's logits
              equal bit for bit; (z) recipes/make_spec_corpus.py,
              preprocess_torch_cli.py (random 2048-bin codec), the toolbox
              model at 2 layers with 3 MTP head groups trained on it, then
              quality_torch_cli.py (7 modes) and
              spec_acceptance_torch_cli.py (TTS and --edit) on its
              checkpoint: each ends normally with every mode reported, and
              a false bit-exact field is re-derived with both paths' draws
              and must be a near-tie.
 11. mesh     parallel/mesh.py on one card: a one-rank NCCL group and a
              1 x 1 mesh; (j)'s 8-lane greedy wave through
              serve_tts_batch(mesh=), its tokens the no-mesh wave's bit for
              bit (L attention launches in its prefill, none a step); an
              engine run (8 requests over 4 lanes) the no-mesh engine's bit
              for bit; (p)'s stream of the 17.28 s prompt over the mesh,
              its consumer closed after the first chunk: cancelled, and
              the frames handed over at most the first chunk's plus one
              burst (L attention launches); 2 Trainer(mesh=) steps on
              phase 9's manifest, the parameters Trainer()'s bit for bit
              (ZeRO-1 is off at data 1).
 13. recipes  recipes/spec_acceptance_torch.sh as a user runs it, on the
              card (DEVICE=cuda), its default preset (proc50M, 7 MTP head
              groups) with small overrides (RECIPE_ENV), WORK under build/
              and ``python`` on the PATH: its acceptance.json parses, with
              tokens a pass and frames/s for taus 2, 4 and 8 in the
              single-stream, serving and engine sections.
 14. bench    bench_torch.main in-process at giga830M width with bench.py's
              geometry (120 phones, 150 prompt frames, 500 frames), --iters
              1, each run's launch counts set to 0 just before it and read
              just after, and its decode forwards counted: (A) the default
              run, fp8 single stream (500 frames) then 32 lanes with the
              fp8 slab, both lines; (B) --fused-ffn --kv-fp8 (fp8 weights
              and slab, then the default run's 32-lane line) and --bf16
              --fused-ffn at 128 frames: 16 FFN launches a forward, all on
              sm90/fp8, then sm90/bf16;
              (C) --bf16 at 128 frames with --steps-per-iter 4 beside 1:
              forwards/s and
              the device operations and ms a step (torch.profiler over 16
              steps); (D) outside the bench, on phase 6's model (2 layers)
              made anew, inference_tts at request (b)'s
              greedy geometry with steps_per_iter 4 against 1 under the
              tie-aware rule, and edit (d) greedy with the eog bias raised,
              run_decode at steps_per_iter 3 with its spans spliced against
              inference_edit: every span done, kept frames verbatim, equal;
              (E) --spec 4 --spec-accept: 4 tokens a pass;
              (F) --edit-serve 8 at 128 frames: every lane to its budget;
              (G) --engine 8,
              and --steady at 64 frames a request; (H) --stream with the
              pipeline on and off at 40 phones; (I) --train and
              --train-profile: the bf16 GEMM probe's TFLOP/s positive and
              at most the dense bf16 peak, the fp8 probe's not null.
 15. install  the port as a user installs it: a wheel built from a copy of
              the checkout (pip wheel --no-deps --no-build-isolation,
              offline), installed with pip install --no-deps --target into
              a temporary directory; the installed voicecraft-tts-torch
              (working directory outside the checkout, PYTHONPATH the target
              alone) and the checkout's tts_torch_cli.py side by side, each
              --model giga830M --random-init --device cuda --fused-ffn
              --top-k 1 --seed 0 on demo.wav tiled to request (a)'s 17.28 s
              prompt: the installed copy imports its own package and builds
              the kernel library from its own csrc into its own build root
              (the path is printed), both runs launch the attention kernel
              16 times (one prefill, Sp >= 1024) and the fused FFN 16 times
              a forward, all on sm90/bf16, every wav is finite, and the two
              runs' wavs are equal byte for byte.

    python3 chip_smoke.py --cards 4

runs phases 1-2 and then only

 12. cards    four cards, four NCCL ranks (torch.multiprocessing spawn,
              TCP rendezvous on 127.0.0.1, a collective timeout; any rank's
              failure fails the run), giga830M in bf16 from seed 0 on every
              rank: (A) (j)'s 8 greedy lanes as one card's wave on each
              card, then at 4 x 1 and 2 x 2, plain and speculative (3 random
              MTP head groups, tau 4), each rank's lanes against the
              one-card wave under the tie-aware rule, 16 attention launches
              per rank (8 local heads at 2 x 2), frames/s, peak memory per
              card; (B) the engine at 4 x 1, 16 requests over 8 lanes, each
              against its single stream under ties, stream_tts at 4 x 1
              with lanes 4, and a stream that rank 0's consumer closes
              after the first chunk at 4 x 1 and at 2 x 2 (the other ranks
              drain theirs): every rank cancelled at the same burst, within
              one burst of the first chunk; (D) the e830M recipe with its
              dropouts at 0 on phase 9's manifest: Trainer(mesh=) 4 steps
              at 4 x 1 with ZeRO-1, without (twice), and at 2 x 2 with
              ZeRO-1, each loss against one card's on the same global
              batches, target tokens/s summed over the cards, s a step,
              peak memory per card, the NCCL kernels' ms in a step
              (torch.profiler), ZeRO-1 against replicated moments bit for
              bit (losses, parameters, the gathered moments); (E) the 2 x 2 run's checkpoint on
              one card: its parameters the gathered ones bit for bit,
              load_model serving a lane; (C) serve_torch_cli.py --mesh 2x2
              under torch.distributed.run: two concurrent /tts in one wave
              and an /edit.  It refuses to run on fewer than 4 cards.

The last three lines are the card (as nvidia-smi reports it), one JSON
object with each kernel's result, and {"ok": true, "device": {...}};
--cards 4 ends with the card and that last line.
"""

import base64
import contextlib
import csv
import io
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
import wave
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
# Phases 6-8, 10 (w), (x), (z), 11 and 14 (D) run giga830M at its full width
# with its depth cut to PATH_DEPTH's layers (load_model's overrides): their
# decodes are host-bound, the device operations of a step issued one by one
# (~800 at 16 layers, ~50 of them a layer), so the depth sets much of their
# time, and at 16 layers the script ran past its 1,200 s limit.  Phases 4-5
# (the slice and editing), 9 (training), 8 (q) (the server), 12 and 14's
# bench runs keep the preset's 16.
PATH_DEPTH = dict(num_decoder_layers=2)
# Random weights end a span only when codebook 0 draws eog, 1 code of 2051:
# thousands of steps.  Phase 5 adds EOG_BIAS to that logit's bias
# (model.heads.b2[0, eog]) so that every span ends well within
# EDIT_GEN_MAX.  The random heads' logits spread ~0.2 around 0 and their
# largest of 2051 sits near +0.75.  A sweep on an H100 (seeds 0 and 1):
# at 0.3 the spans of (d) and (e) end after 18-85 frames (at most 203
# forwards); at 0.4 (e)'s greedy spans end at their first sample, empty.
# PATH_DEPTH's model draws other greedy paths.  A sweep on an H100 over the
# edit checks of phases 6 (i), 7 (l), (m) and 14 (D) at seed 0
# (recipes/eog_sweep_torch.py): at 2 layers every span ends non-empty
# within its budget at 0.3 and 0.35 (2-66 frames); at 4 layers 0.3 ran
# phase 7 (l)'s lane 0 past EDIT_GEN_MAX (87, 195, 90+ frames).
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
# the engine's ring attention over an fp8 slab (csrc/ring_decode_attention.
# cu), per element, in bf16 ulps of max(|out|, 1), against its plain
# version, which rounds at the same points (f32 logits, f32 softmax, probs
# to bf16, f32 p@v, one output rounding) and sums in another order: the
# output's rounding may flip (1 ulp), and a prob rounded the other way
# moves p@v by 2^-8 of that key's share of |v|, far under an output ulp;
# 2 bounds both.  Its geometry: tts830e.stream32's step (benchmark/traffic/
# stream_poisson32.json): 32 lanes, x_pad 96, y_pad 448, a ring of gen_max
# 448 + burst 48 slots, 16 heads of 128
RING_VS_PLAIN_ULPS = 2.0
# the kernels the single-stream decode loop of phases 4-5 launches (the
# ring kernel runs only in the engine's step on an fp8 slab: phase 8 (o))
DECODE_LOOP_KERNELS = ("flash_prefix_attention", "fused_ffn")
RING_GEOM = dict(B=32, x_pad=96, y_start=96 + 448, W=448 + 48, H=16, Dh=128)
# Kimi Linear's KDA recurrence (csrc/kda_recurrent.cu) against its plain
# version, both f32 from bf16 q / k / v: per element of o and of the final
# state, relative to max(|want|, 1).  The kernel fuses each multiply-add
# and sums dk = 128 terms in 4 partial sums where the plain version sums
# them in another order, ~1e-7 relative a token; the state is a
# contraction (||I - beta k k^T|| <= 1, exp(g) <= 1), so the differences
# of the 544 tokens of a prefill add up to at most ~5e-5.  Its shapes:
# kimilinear.stream32's decode step (32 lanes, 32 heads of 128) and a
# refill's prefill (x_pad 96 + y_pad 448 tokens packed)
KDA_VS_PLAIN_REL = 1e-4
KDA_GEOM = dict(B=32, H=32, dk=128, T_prefill=96 + 448)
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
# (n): the speculative loop's one run of N_FRAMES rows (phase 14 runs and
# times bench.py's 500 frames through bench_torch.py)
N_FRAMES = 128
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
# phase 8 (o): the continuous-batching engine over (j)'s prompts, each with
# two texts (the second from word 3b + ENGINE_TEXT_START on), ENGINE_LANES
# lanes at (j)'s pads (Sp 1024: the startup wave at B=8 and every refill at
# B=1 through the attention kernel), bursts of ENGINE_BURST steps; then at
# bench.py's engine geometry (bench.py:790-830: 2 x 32 requests, 150-frame
# random prompts, y_pad 192, targets 60-100% of the frames), its 500 frames
# cut to BENCH_ENGINE_FRAMES
ENGINE_LANES, ENGINE_BURST, ENGINE_TEXT_START = 8, 48, 11
BENCH_ENGINE_FRAMES = GEN_MAX
# phase 9: training at giga830M with the e830M recipe (recipes/e830M.sh:
# ScaledAdam lr 0.05, codebook weights 5 1 0.5 0.1, chunked attention,
# remat "attn", the preset's dropouts) on a synthetic manifest: TRAIN_UTTS
# training and TRAIN_VALID validation utterances of 2-20 s (100-1,000
# frames) with codes from a seed and phones of phase 7's texts
TRAIN_UTTS, TRAIN_VALID, TRAIN_FRAMES = 256, 16, (100, 1000)
RECIPE = dict(codebook_weight=(5.0, 1.0, 0.5, 0.1), train_attn="chunked",
              train_remat="attn")
TRAIN_TOKENS, RECIPE_TOKENS = 20000, 100000   # (s) and (t); the recipe's is (t)
# (s) steps 2-5 give the rates; step 6's optimizer update and steps 7-8
# run under torch.profiler (which slows the host)
TRAIN_STEPS, FIXED_STEPS = 8, 6
RATE_STEPS, OPT_OPS_STEP, PROFILED_STEPS = (2, 3, 4, 5), 6, (7, 8)
# (r): forward_train's loss and gradients at giga830M width cut to
# NUMERICS_LAYERS layers, the card in bf16 against the CPU in f32, on
# NUMERICS_UTTS utterances of at most NUMERICS_FRAMES frames (5 s).  bf16
# rounds every activation and product to 8 bits (0.4%); the loss averages
# those errors over ~4,000 targets, so 1e-2 of it is a bound with room.  A
# gradient's relative-norm error: the median tensor's within
# TRAIN_GRAD_MEDIAN.  The worst tensor's within TRAIN_GRAD_RTOL: bf16
# moves a fraction f ~ 2^-8 of the FFN's pre-activations across zero, and
# each flipped ReLU gate gets a wholly different gradient, so the tensors
# behind the gates (lin1, its bias, LN2) carry ~sqrt(f) = 6% (measured on
# the CPU in bf16 against f32 at 2 layers of width 256 and 512: 5.0-5.9%,
# the median tensor 0.9%).  The norm is floored at TRAIN_GRAD_FLOOR of the
# largest tensor's: the key biases' gradient is zero in exact arithmetic (a
# query's logits all shift by q.bk) and holds rounding noise on both
# devices.  Chunked against dense attention on the card, both bf16: the
# same tolerances.
NUMERICS_LAYERS, NUMERICS_UTTS, NUMERICS_FRAMES = 2, 4, 250
TRAIN_LOSS_RTOL, TRAIN_GRAD_FLOOR = 1e-2, 1e-3
TRAIN_GRAD_RTOL, TRAIN_GRAD_MEDIAN = 0.10, 2e-2
# (s): step 1's loss per target token against ln(card) x mean(weights),
# the CE of a uniform prediction
STEP1_RTOL = 0.05
U_GEN_MAX = 64                                # (u) the trained model's TTS
# phase 11: the 1 x 1 mesh; its engine run and its Trainer steps
MESH_ENGINE_LANES, MESH_ENGINE_GEN, MESH_STEPS = 4, 128, 2
# phase 12 (--cards 4): MESH_TRAIN_STEPS Trainer steps per run, the NCCL
# time from step MESH_PROFILED_STEP; the recipe with its dropouts at 0, so
# that each step's loss can be held against one card's on the same global
# batches (TRAIN_LOSS_RTOL); ZeRO-1 against replicated moments bit for bit
# (losses, parameters, the gathered moments): both layouts sum the
# gradients through one reduce-scatter and every per-leaf sum in rank
# order.  A hung collective
# fails after MESH_TIMEOUT_S; the ranks' phase after CARDS_PHASE_S; the
# server must answer /healthz within SERVER_START_S.
MESH_TRAIN_STEPS, MESH_PROFILED_STEP = 4, 3
MESH_NO_DROPOUT = dict(text_embedding_dropout=0.0,
                       text_positional_embedding_dropout=0.0,
                       audio_positional_embedding_dropout=0.0,
                       audio_embedding_dropout=0.0, trm_dropout=0.0)
MESH_TIMEOUT_S, CARDS_PHASE_S, SERVER_START_S = 600, 780, 240
# phase 13: recipes/spec_acceptance_torch.sh on the card at its default
# preset (proc50M, 7 MTP head groups: taus 2, 4, 8), cut by its own
# overrides to a run of about a minute and a half
RECIPE_ENV = dict(STEPS="10", N_TRAIN="16", N_EVAL="4", N_SINGLE="1",
                  LANES="2")
RECIPE_TAUS, RECIPE_TIMEOUT_S = (2, 4, 8), 300
# phase 15: the wheel's build and install, then each TTS run, at most
INSTALL_TIMEOUT_S, INSTALL_RUN_TIMEOUT_S = 300, 420
# phase 14: bench_torch.py in-process at bench.py's geometry (bench.py:32-36
# defaults: 120 phones, 150 prompt frames, 500 frames) at one timed run;
# steps_per_iter BENCH_K in (C) and (D), BENCH_EDIT_K for (D)'s edit; (B)'s
# fused FFN at BENCH_FUSED_FRAMES, (C) at BENCH_K_FRAMES, (F) at
# BENCH_EDIT_FRAMES (to stay inside the script's time limit); the engine's
# steady variant at BENCH_STEADY_FRAMES a request (8 waves of
# BENCH_ENGINE_LANES); the stream at BENCH_STREAM_PHONES phones (random
# weights stop at the length cap, ~10 frames a phone past the prompt)
BENCH_ARGS = ["--iters", "1"]
BENCH_K, BENCH_EDIT_K = 4, 3
BENCH_EDIT_LANES = BENCH_ENGINE_LANES = 8
BENCH_STEADY_FRAMES = 64
BENCH_FUSED_FRAMES = 128             # (B): launches, at fewer frames
BENCH_K_FRAMES = 128                 # (C): k = 4 beside 1
BENCH_EDIT_FRAMES = 128              # (F): each edit lane's budget
BENCH_STREAM_PHONES = 40
# phase 10: the icefall toolbox (models/scaling.py).  (v) each scaling
# Function's forward and backward on the card against the CPU in f32, on an
# activation of the e830M batch's shape (phase 9 (t): 8 rows of 400 + 1,024
# positions, width 2048), in bf16 and f32.  The input and the incoming
# gradient are bf16 numbers, so one CPU f32 run is the reference of both:
# f32 within SCALING_F32_RTOL of the reference's largest |value| (the same
# sums in another order), bf16 within SCALING_BF16_RTOL of it (the output's
# own rounding, 2^-8 of an element at most, and the f32 work inside);
# BasicNorm's log_eps gradient, one sum over 23M elements, within
# SCALING_SCALAR_RTOL in either.  (w)-(z): giga830M built with the toolbox
SCALING_SHAPE = (8, 1424, 2048)
SCALING_F32_RTOL, SCALING_BF16_RTOL, SCALING_SCALAR_RTOL = 1e-4, 2.0 ** -7, 1e-3
TOOLBOX = dict(norm="basicnorm", ffn_activation="doubleswish")
TOOLBOX_BALANCED = dict(norm="balancedbasicnorm",
                        ffn_activation="balanceddoubleswish")
W_GEN_MAX = 64                                # (w) request (a), greedy
W_PADS = (128, 896, 128)                      # (w) 8 lanes: Sp 1024
W_COMPARED = (0, 7)                           # (w) lanes vs single streams
X_STEPS, Z_STEPS = 4, 4                       # (x) and (z) Trainer steps
# (z): the procedural corpus (recipes/make_spec_corpus.py) of 8 training and
# 2 held-out utterances of 2-3 words (0.7-1.4 s), 0.6 s prompts: every CLI
# decode runs to its length cap (10 frames a phone) on a model trained 4
# steps, so the words set its length; one engine burst (16) for both taus
CORPUS_ARGS = ("--train", "8", "--eval", "2", "--min-words", "2",
               "--max-words", "3")
CLI_PROMPT_SEC, CLI_N = "0.6", "1"
QUALITY_MODES = ("resynth", "plain", "spec", "stream", "fp8", "edit",
                 "edit_spec")


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


def library_attention(q, k, v, allowed):
    """One call of PyTorch's fused attention, q [B, H, S_q, Dh] against
    k / v [B, H, S_kv, Dh] under the boolean mask ``allowed`` [B, 1, S_q,
    S_kv]: the yardstick that phases 3 and 9 time beside the port's
    attention (phase 3 also beside the ring kernel, on the upcast slab with
    the lanes' own keys appended), used nowhere in the port."""
    import torch.nn.functional as fnn
    return fnn.scaled_dot_product_attention(q, k, v, attn_mask=allowed)  # library_ms


def flash_phase(geom_long, geom_serve):
    import torch
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
            library_ms=graph_ms([lambda: library_attention(
                heads(q), heads(k), heads(v), allowed[:, None])]))
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
    # that prefill's local shape on a 2 x 2 mesh (phase 12): data rank 0's
    # half of the lanes, its model rank's 8 of the 16 heads (D = 1,024)
    nl = len(sx_lens) // 2
    name = (f"bf16 B={nl} S={sx_pad + sy_pad} D=1024 H=8 (the serving "
            f"prefill's local shape on a 2 x 2 mesh: lanes 0-{nl - 1}, 8 of "
            f"16 heads)")
    err22, args22, _, _ = case(name, nl, sx_pad + sy_pad, 1024, 8, sx_pad,
                               sx_lens[:nl], sy_lens[:nl], torch.bfloat16)
    cases.append(dict(case=name, max_abs_err=err22,
                      **timings(args22, BF16_FLOP_PER_S, 2)))
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


def ring_phase():
    """The engine's ring decode attention over an fp8 slab against its
    plain version (the slab upcast, then _attend_one): at tts830e.
    stream32's step shape with random ring geometry (empty lanes, lanes at
    t = 0, a text filling x_pad, a clock far past many wraps), and at head
    dims 16, 32 and 64 with 8 heads; repeated and replayed from a CUDA
    graph bit for bit; kernel, plain and library ms a call from CUDA-graph
    replays over a round robin of slabs larger than L2, beside the bound:
    the allowed keys' fp8 bytes read once, and the whole slab's."""
    import torch
    from voicecraft_tpu_torch.ops.attention import _ring_valid
    from voicecraft_tpu_torch.ops.ring_attention import (
        ring_decode_attention, ring_decode_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED + 24)

    def inputs(B, H, Dh, x_pad, y_start, W, n_slabs=1):
        S = y_start + W
        r = lambda *s: torch.randn(s, generator=gen, device="cuda")
        x = rng.integers(1, x_pad + 1, B)
        p = rng.integers(150, min(401, y_start - x_pad + 1), B)
        t = rng.integers(0, W - 48, B)
        x[:2], p[:2], t[:4] = 1, 1, 0
        x[4 % B] = x_pad
        long = lambda v: torch.as_tensor(v, dtype=torch.long, device="cuda")
        rest = (long(x), x_pad, long(p), y_start, W,
                long(int(rng.integers(10 ** 6, 10 ** 7))), long(t))
        slabs = [(2.0 * r(2, B, S, H, Dh)).to(torch.float8_e4m3fn)
                 for _ in range(n_slabs)]
        q, kn, vn = (r(B, 1, H * Dh).bfloat16(),
                     *(r(B, 1, H, Dh).bfloat16() for _ in range(2)))
        return [(q, sl[0], sl[1], kn, vn, *rest) for sl in slabs]

    def case(name, B, H, Dh, x_pad, y_start, W):
        args = inputs(B, H, Dh, x_pad, y_start, W)[0]
        got = ring_decode_attention(*args)
        want = ring_decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = check_ulps(name, got, want, RING_VS_PLAIN_ULPS)
        if not (torch.equal(ring_decode_attention(*args), got)
                and replay_matches_eager(lambda: ring_decode_attention(*args))):
            raise AssertionError(f"{name}: a repeated or replayed call differs")
        return err

    g = RING_GEOM
    B, H, Dh, S = g["B"], g["H"], g["Dh"], g["y_start"] + g["W"]
    log(f"ring_decode_attention, fp8 slab, bf16 q: B={B} S_max={S} H={H} "
        f"Dh={Dh} (tts830e.stream32's step): grid of {B * H} blocks")
    err = case("fp8 slab, the cell's step shape vs plain", B, H, Dh,
               g["x_pad"], g["y_start"], g["W"])
    for h2, dh2 in ((8, 64), (8, 32), (8, 16)):
        case(f"fp8 slab B={B} S_max={S} H={h2} Dh={dh2}", B, h2, dh2,
             g["x_pad"], g["y_start"], g["W"])
    # a round robin over slabs of 8 x 136 MB, far past the 50 MB L2, as
    # decode reads a fresh layer's slab each call
    sets = inputs(B, H, Dh, g["x_pad"], g["y_start"], g["W"], n_slabs=8)
    xl, xp, pl, ys, W, gs, tl = sets[0][5:]
    valid = _ring_valid(S, xl, xp, pl, ys, W, gs, tl, "cuda")[:, 0, 0]
    n_valid = int(valid.sum().item())
    allowed = torch.cat([valid, torch.ones_like(valid[:, :1])],
                        dim=1)[:, None, None]
    heads = lambda t: t.transpose(1, 2)
    ups = [(heads(torch.cat([a[1].bfloat16(), a[3]], dim=1)),
            heads(torch.cat([a[2].bfloat16(), a[4]], dim=1))) for a in sets]
    qh = heads(sets[0][0].view(B, 1, H, Dh))
    t = dict(
        ms=graph_ms([lambda a=a: ring_decode_attention(*a) for a in sets]),
        plain_ms=graph_ms([lambda a=a: ring_decode_attention_plain(*a)
                           for a in sets]),
        library_ms=graph_ms([lambda u=u: library_attention(
            qh, u[0], u[1], allowed) for u in ups]))
    small = 4 * B * H * Dh * 2                      # q, k_new, v_new, out
    t["bound_ms"], t["bound_by"] = bound(2 * n_valid * H * Dh + small,
                                         4 * (n_valid + B) * H * Dh,
                                         F32_FLOP_PER_S)
    t["slab_bound_ms"], _ = bound(2 * B * S * H * Dh + small, 0, 1.0)
    t["allowed_share"] = n_valid / (B * S)
    log(f"  kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
        f"(PyTorch's fused attention on the upcast slab) "
        f"{t['library_ms']:.4f} ms per call (CUDA-graph replays over 8 "
        f"slabs); bound {t['bound_ms']:.4f} ms ({t['bound_by']}: the "
        f"{t['allowed_share']:.1%} of keys the ring allows), the kernel at "
        f"{t['bound_ms'] / t['ms']:.0%} of it; the whole slab's bytes "
        f"{t['slab_bound_ms']:.4f} ms")
    return dict(max_abs_err=err, **t)


def kda_inputs(gen, B, T, H, dk, lens=None):
    """Random recurrence inputs as a KDA layer makes them: q and k
    L2-normalised per head and v in bf16, the log decay g (f32, <= 0) and
    beta in (0, 1) (f32), and a state [B, H, dk, dk] (f32; 0 where a
    prefill starts it)."""
    import torch
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    unit = lambda t: (t / t.norm(dim=-1, keepdim=True)).bfloat16()
    g = -torch.rand((B, T, H, dk), generator=gen, device="cuda") * 0.5
    beta = torch.sigmoid(r(B, T, H))
    state = (0.1 * r(B, H, dk, dk)) if T == 1 else torch.zeros(
        (B, H, dk, dk), device="cuda")
    return (unit(r(B, T, H, dk)), unit(r(B, T, H, dk)),
            r(B, T, H, dk).bfloat16(), g, beta, state, lens)


def kda_phase():
    """Kimi Linear's KDA recurrence (csrc/kda_recurrent.cu) against its
    plain version: kimilinear.stream32's decode step (32 lanes, T 1) and
    a refill's prefill (1 lane, T 544; and 2 lanes of 544 and 300 real
    tokens), o and the final state within KDA_VS_PLAIN_REL; the decode
    call repeated and replayed from a CUDA graph bit for bit; kernel and
    plain ms a call from CUDA-graph replays over a round robin of 8 states
    (536 MB, far past the 50 MB L2), beside the bound: the state read and
    written once, the inputs and o once."""
    import torch
    from voicecraft_tpu_torch.ops.kda import (kda_recurrent,
                                              kda_recurrent_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    g = KDA_GEOM
    B, H, dk = g["B"], g["H"], g["dk"]

    def case(name, args):
        q, k, v, gg, beta, state, lens = args
        s_k, s_p = state.clone(), state.clone()
        got = kda_recurrent(q, k, v, gg, beta, s_k, lens)
        want = kda_recurrent_plain(q, k, v, gg, beta, s_p, lens)
        torch.cuda.synchronize()
        worst = 0.0
        for what, a, b in (("o", got, want), ("state", s_k, s_p)):
            rel = ((a - b).abs() / b.abs().clamp(min=1.0)).max().item()
            worst = max(worst, rel)
            log(f"  {name}, {what}: max error {rel:.2e} of max(|plain|, 1) "
                f"(tolerance {KDA_VS_PLAIN_REL:g})")
            if not rel <= KDA_VS_PLAIN_REL:
                raise AssertionError(f"{name} {what}: {rel} > "
                                     f"{KDA_VS_PLAIN_REL}")
        return worst

    log(f"kda_recurrent, bf16 q/k/v, f32 state: decode B={B} H={H} dk=dv="
        f"{dk} (kimilinear.stream32's step): grid of {B * H * dk // 32} "
        f"warps")
    dec = kda_inputs(gen, B, 1, H, dk)
    err = case("decode, the cell's step shape vs plain", dec)
    T = g["T_prefill"]
    err = max(err, case(f"prefill B=1 T={T} vs plain",
                        kda_inputs(gen, 1, T, H, dk)))
    lens = torch.tensor([T, 300], device="cuda")
    err = max(err, case(f"prefill B=2 T={T} lens {lens.tolist()} vs plain",
                        kda_inputs(gen, 2, T, H, dk, lens)))

    q, k, v, gg, beta, state, _ = dec
    base = state.clone()

    def again():
        state.copy_(base)
        return kda_recurrent(q, k, v, gg, beta, state)
    first = again()
    if not (torch.equal(again(), first) and replay_matches_eager(again)):
        raise AssertionError("kda_recurrent: a repeated or replayed call "
                             "differs")
    states = [0.1 * torch.randn((B, H, dk, dk), generator=gen,
                                device="cuda") for _ in range(8)]
    t = dict(ms=graph_ms([lambda s=s: kda_recurrent(q, k, v, gg, beta, s)
                          for s in states]))
    t["plain_ms"] = graph_ms([lambda s=s: kda_recurrent_plain(
        q, k, v, gg, beta, s, None) for s in states[:2]])
    pq, pk, pv, pg, pb, ps, _ = kda_inputs(gen, 1, T, H, dk)
    t["prefill_ms"] = graph_ms([lambda: kda_recurrent(pq, pk, pv, pg, pb,
                                                      ps)], replays=3)
    # the cell's decode call: the f32 state read and written, then q, k, v
    # (bf16), g, o (f32) and beta (f32): benchmark/architectures/
    # kimi_linear.py:kda_step_bytes
    nbytes = B * (8 * H * dk * dk + H * (3 * dk * 2 + 2 * dk * 4 + 4))
    t["bound_ms"], t["bound_by"] = bound(nbytes, 6 * B * H * dk * dk,
                                         F32_FLOP_PER_S)
    log(f"  kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms per "
        f"decode call (CUDA-graph replays over 8 states); bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}), the kernel at "
        f"{t['bound_ms'] / t['ms']:.0%} of it; a refill's prefill (T {T}) "
        f"{t['prefill_ms']:.3f} ms")
    return dict(max_rel_err=err, **t)


def kda_launch_phase():
    """kda_recurrent's launches in Kimi Linear's stack at its published
    depth and widths (8 experts held, for memory and time): one a KDA
    layer and step, 20 an engine step, and one a KDA layer per prefill
    call (a wave or a refill), with the step's parts replayed from CUDA
    graphs."""
    import torch
    from voicecraft_tpu_torch.config import kimi_linear_48b_a3b
    from voicecraft_tpu_torch.inference.engine import ContinuousBatcher
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig, VoiceCraft
    from voicecraft_tpu_torch.ops import _native
    import dataclasses
    cfg = dataclasses.replace(kimi_linear_48b_a3b(), n_routed_experts=8)
    model = VoiceCraft(cfg, "cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(SEED + 26)).eval()
    n_kda = len(cfg.kda_layers)
    rng = np.random.default_rng(SEED + 26)
    eng = ContinuousBatcher(model, lanes=4, x_pad=96, y_pad=448, gen_max=96,
                            burst=48,
                            scfg=SamplingConfig(top_k=1, silence_tokens=()))
    for frames in (150, 300, 200):
        eng.submit(rng.integers(0, cfg.text_vocab_size, 40),
                   rng.integers(0, cfg.audio_vocab_size, (4, frames)))
    before = _native.LAUNCHES["kda_recurrent"]
    res = eng.run()
    got = _native.LAUNCHES["kda_recurrent"] - before
    st = eng.stats
    want = n_kda * (st["steps"] + st["waves"] + st["refills"])
    log(f"  kda_recurrent launches in the engine: {got} over {st['steps']} "
        f"steps ({st['graph_steps']} graphed), {st['waves']} waves, "
        f"{st['refills']} refills; want {n_kda} a step and a prefill call: "
        f"{want}")
    if got != want or len(res) != 3 or n_kda != 20:
        raise AssertionError(f"kda_recurrent launched {got} times, want "
                             f"{want}")
    del eng, model
    torch.cuda.empty_cache()
    return dict(per_step=n_kda, engine_launches=got)


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
    # the f32 route (csrc/fused_ffn.cu, the checks' kernel) on f32 copies of
    # the same weight sets; the library call is the cuBLAS pair in f32
    sets32 = [tuple(t.float() for t in ws) for ws in sets]
    log(f"fused_ffn, f32 x and weights (csrc/fused_ffn.cu) at D={D} F={F}, "
        f"the same {FFN_SETS} layers in f32 (CUDA-graph replays); the library "
        f"call is addmm, relu, addmm in f32 (TF32 off):")
    for B in (1, 4, 8):
        x = rows(B, D, torch.float32)
        err = check_case(f"f32 B={B} D={D} F={F}", x, sets32[0])
        ms = graph_ms([lambda ws=ws: fused_ffn(x, *ws) for ws in sets32])
        plain_ms = graph_ms([lambda ws=ws: fused_ffn_plain(x, *ws)
                             for ws in sets32])
        library_ms = graph_ms([lambda ws=ws: torch.addmm(
            ws[3], torch.relu(torch.addmm(ws[1], x, ws[0])), ws[2])
            for ws in sets32])
        nbytes = 2 * D * F * 4 + 2 * B * D * 4 + (F + D) * 4
        bound_ms, bound_by = bound(nbytes, 4 * B * D * F, F32_FLOP_PER_S)
        log(f"  B={B} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"cuBLAS pair {library_ms:.4f} ms per call; bound "
            f"{bound_ms:.4f} ms ({bound_by}), the kernel at "
            f"{bound_ms / ms:.0%} of it")
        cases.append(dict(case=f"f32 x and weights (csrc/fused_ffn.cu), "
                               f"B={B} D={D} F={F}",
                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms))
    del sets32
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


def teacher_forced_logits(model, x, prefix, step_embs, plain: bool,
                          fused_ffn=None):
    """Logits after prefill and after each teacher-forced decode step, one
    step per embedding [D] of step_embs, through the kernels (plain=False)
    or through their plain versions and the unfused FFN (plain=True).
    ``fused_ffn`` False keeps the kernel path's FFN unfused (a model whose
    activation the fused kernel does not compute)."""
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
                x_len=x_len, x_pad=x_pad,
                fused_ffn=(not plain) if fused_ffn is None else fused_ffn)
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
    for name in DECODE_LOOP_KERNELS:
        if launches[name] == 0:
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
        from voicecraft_tpu_torch.ops.graphs import StepGraph as graph
        self.logits, self.passes = [], []
        self._mods = (vc, sc, sv)
        self._orig = (vc.sample, sc.spec_verify_pass, graph.__init__,
                      graph.replay)
        sample, spec_pass, capture, replay = self._orig

        def recording_sample(generator, lg, *a, **kw):
            self.logits.append(lg.detach().clone())
            return sample(generator, lg, *a, **kw)

        def recording_pass(*a, **kw):
            self.passes.append((kw["t"], len(self.logits), kw["tau"]))
            return spec_pass(*a, **kw)

        # a captured decode step (the single-stream loop on the card) draws
        # nothing at its capture: its copies are buffers that each replay
        # fills, so each replay records a copy of them
        def recording_capture(g, *a, **kw):
            n = len(self.logits)
            capture(g, *a, **kw)
            g.recorded_draws = self.logits[n:]
            del self.logits[n:]

        def recording_replay(g):
            replay(g)
            self.logits += [t.clone() for t in getattr(g, "recorded_draws",
                                                       ())]

        vc.sample = recording_sample
        sc.spec_verify_pass = sv.spec_verify_pass = recording_pass
        graph.__init__, graph.replay = recording_capture, recording_replay
        return self

    def __exit__(self, *exc):
        from voicecraft_tpu_torch.ops.graphs import StepGraph
        vc, sc, sv = self._mods
        sample, spec_pass, capture, replay = self._orig
        vc.sample = sample
        sc.spec_verify_pass = sv.spec_verify_pass = spec_pass
        StepGraph.__init__, StepGraph.replay = capture, replay

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


def device_time(fn):
    """(fn(), device ms, device operations) from torch.profiler: the
    summed time and the count of the CUDA kernels and memory operations
    the device ran during it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, sum(e.time_range.elapsed_us() for e in ev) / 1e3, len(ev)


def device_ops(fn):
    """(fn(), the CUDA kernels and memory operations the device ran during
    it, from torch.profiler; None when it saw no device activity)."""
    out, _, n = device_time(fn)
    return out, n or None


@contextlib.contextmanager
def counting_forwards():
    """Inside the block, the yielded [n] counts decoder forwards: calls of
    transformer.decode_step_fast, less the call that a CUDA graph's capture
    of the single-stream loop's step makes (it runs nothing), plus each
    replay of a captured step."""
    from voicecraft_tpu_torch.models import transformer as trm
    from voicecraft_tpu_torch.ops.graphs import StepGraph
    count = [0]
    step = trm.decode_step_fast
    capture, replay = StepGraph.__init__, StepGraph.replay

    def counted_step(*a, **kw):
        count[0] += 1
        return step(*a, **kw)

    def counted_capture(g, *a, **kw):
        capture(g, *a, **kw)
        count[0] -= 1

    def counted_replay(g):
        count[0] += 1
        replay(g)

    trm.decode_step_fast = counted_step
    StepGraph.__init__, StepGraph.replay = counted_capture, counted_replay
    try:
        yield count
    finally:
        trm.decode_step_fast = step
        StepGraph.__init__, StepGraph.replay = capture, replay


def step_profile(run, n, module=None, name="decode_step_multi"):
    """(device operations, device ms) per step of the serving wave that
    run() decodes, from torch.profiler over n whole steps: the profiler
    starts at the wave's second call of module.name (the serving step,
    transformer.decode_step_multi, by default) and stops at its (n + 2)-th,
    so the window holds n forwards, n sampler calls and their bookkeeping,
    and not the prefill.  The wave must run n + 2 steps or more.  The
    window starts and ends in a host sync, so its device time must fit in
    its wall time.  (None, None) when the profiler saw no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from voicecraft_tpu_torch.models import transformer as trm
    module = trm if module is None else module
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    step, calls, marks = getattr(module, name), [0], []

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

    setattr(module, name, marked)
    try:
        run()
    finally:
        setattr(module, name, step)
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

def serving_texts(start: int = 0):
    """(j)'s lane texts: words of PROMPT and TARGET, lane b from word 3b +
    start on, up to 22 phones for the 2 s prompt and 128 for the 17.28 s
    one (the lanes' length caps, 10 frames a phone, lie past their
    prompts)."""
    from voicecraft_tpu_torch.data.phonemes import make_text_tokenizer
    tok = make_text_tokenizer("en-us", "grapheme")
    words = (PROMPT + " " + TARGET).split()
    lo, hi = SERVE_SECONDS[0], SERVE_SECONDS[-1]
    texts = []
    for b, sec in enumerate(SERVE_SECONDS):
        want = round(22 + 106 * (sec - lo) / (hi - lo))
        text, n = "", 0
        while True:
            cand = (text + " " + words[(3 * b + start + n)
                                       % len(words)]).strip()
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
def serving_results(maker: str = "make_serving_edit_loop"):
    """Inside the block, the serving loops that ``maker`` makes (by
    default the plain edit loops of serve_edit_batch) append each
    ServingResult (rows, and each row's span) to the list the block gets."""
    from voicecraft_tpu_torch.inference import serving as sv
    make, results = getattr(sv, maker), []

    def keeping(*a, **kw):
        loop = make(*a, **kw)

        def run(*args):
            results.append(loop(*args))
            return results[-1]
        return run

    setattr(sv, maker, keeping)
    try:
        yield results
    finally:
        setattr(sv, maker, make)


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
        SamplingConfig, apply_heads, init_mtp_heads, make_spec_decode_loop,
        prefill_lanes)
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
    xt, yt, mi, _ = pad_inputs(cfg, x, prefix, nx, ny, "cuda")
    log(f"  (n) speculative bench_mode at bench.py's geometry: "
        f"{BENCH_PHONES} phones, {BENCH_PROMPT} prompt frames, {N_FRAMES} "
        f"frames, Sp {nx + ny}")
    # one run: with random MTP heads nearly every sampled draft is rejected,
    # so it takes ~1 pass a row
    loop = make_spec_decode_loop(cfg, x_pad=nx, y_pad=ny, gen_max=N_FRAMES,
                                 scfg=bench_scfg, n_draft=TAU, bench_mode=True)
    res, wall = counted("n speculative", lambda: loop(
        model, xt, len(x), yt, prefix.length, mi, SEED), nx + ny)
    log(f"  (n) speculative, tau {TAU}, bench_mode: {res.gen_cnt} rows in "
        f"{res.passes} passes, {wall:.3f} s = {res.gen_cnt / wall:.1f} "
        f"frames/s (one run)")
    if res.gen_cnt != N_FRAMES:
        raise AssertionError(f"(n) speculative: {res.gen_cnt} rows")
    del model.mtp_heads, qmodel
    return out


# ---- phase 8 -----------------------------------------------------------------

class EngineRecorder(DrawRecorder):
    """DrawRecorder over a continuous-batching engine's run (one batcher at a
    time, built inside the block or before it): besides each draw's
    adjusted logits and each speculative pass's token counts, it keeps the
    lanes' counts t at each plain step, each burst's first draw, first pass
    and lane -> request map, and each retired request's delayed-space rows,
    so that request(rid) gives the rows and the logits each was drawn from
    (the first draw of a row in a plain burst; a speculative row's last
    draw, the accepted one).  Inside the block the plain engine steps
    eagerly: a step replayed from its CUDA graph runs no Python hook."""

    def __enter__(self):
        super().__enter__()
        import voicecraft_tpu_torch.inference.engine as em
        import voicecraft_tpu_torch.ops.graphs as graphs
        cb = em.ContinuousBatcher
        self._em, self._graphs = em, graphs
        self._eorig = (em.spec_verify_pass, em._lane_decode_step,
                       cb._dispatch_burst, cb._retire,
                       graphs.step_graph_engages)
        pass_, step, dispatch, retire, _ = self._eorig
        graphs.step_graph_engages = lambda model: False
        self.ts, self.bursts, self.kept = [], [], {}
        em.spec_verify_pass = self._mods[1].spec_verify_pass  # recording

        def stepping(*a, **kw):
            self.ts.append(a[9].clone())          # t_lane of this step
            return step(*a, **kw)

        def dispatching(eng):
            # the lane map of the engine's own lanes (over a mesh, its data
            # rank's), which index its draws
            self.bursts.append((len(self.logits), len(self.passes), list(
                eng._lane_req[eng._lo:eng._lo + eng._gen_buf.shape[0]])))
            return dispatch(eng)

        def retiring(eng, status, gen_src, lane_map):
            before = set(eng._results)
            retire(eng, status, gen_src, lane_map)
            for b, rid in enumerate(lane_map):
                if rid is not None and rid in eng._results and rid not in before:
                    f = int(status[b, 2])
                    n = f + 1 if f >= 0 else int(status[b, 1])
                    self.kept[rid] = gen_src[b, :n].copy()

        em._lane_decode_step = stepping
        cb._dispatch_burst, cb._retire = dispatching, retiring
        return self

    def __exit__(self, *exc):
        em, cb = self._em, self._em.ContinuousBatcher
        (em.spec_verify_pass, em._lane_decode_step, cb._dispatch_burst,
         cb._retire, self._graphs.step_graph_engages) = self._eorig
        super().__exit__(*exc)

    def request(self, rid):
        """(rows [n, K], the logits [K, card] each row was drawn from)."""
        import torch
        rows, by_row = self.kept[rid], {}
        ts = torch.stack(self.ts).cpu() if self.ts else None
        ends = self.bursts[1:] + [(len(self.logits), len(self.passes), None)]
        for (d0, p0, lane_map), (d1, p1, _) in zip(self.bursts, ends):
            if rid not in lane_map:
                continue
            b = lane_map.index(rid)
            for t, first, tau in self.passes[p0:p1]:
                tb = int(t[b])
                for i in range(tau):
                    by_row[tb + i] = self.logits[first + i][b]
            if p1 == p0:
                for i in range(d0, d1):
                    by_row.setdefault(int(ts[i, b]), self.logits[i][b])
        return rows, [by_row[r] for r in range(len(rows))]

    def pass_counts(self, rid):
        """The token count t at the start of each speculative pass of rid."""
        out = []
        ends = self.bursts[1:] + [(len(self.logits), len(self.passes), None)]
        for (_, p0, lane_map), (_, p1, _) in zip(self.bursts, ends):
            if rid in lane_map:
                b = lane_map.index(rid)
                out += [int(t[b]) for t, _, _ in self.passes[p0:p1]]
        return out


def wav_bytes(wav, sr=16000) -> bytes:
    """A mono PCM16 WAV file of wav [1, T] or [T]."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(np.round(np.clip(np.reshape(wav, -1), -1, 1) * 32767)
                       .astype("<i2").tobytes())
    return buf.getvalue()


def pcm_of(b64) -> np.ndarray:
    with wave.open(io.BytesIO(base64.b64decode(b64))) as wf:
        return np.frombuffer(wf.readframes(wf.getnframes()), dtype="<i2")


def engine_phase(model, codec, ccfg, serve, texts2, a_req, long_wav):
    """Phase 8: the continuous-batching engine (o), streaming TTS (p) and
    the HTTP server (q) at giga830M, each run's launch counts set to 0 just
    before it and read just after.  Returns the launch counts of each
    run."""
    import dataclasses
    import json as js
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer
    import torch
    import serve_torch_cli
    from voicecraft_tpu_torch.data.phonemes import make_text_tokenizer
    from voicecraft_tpu_torch.data.spans import compose_tts_prefix
    from voicecraft_tpu_torch.inference import engine as em
    from voicecraft_tpu_torch.inference.engine import ContinuousBatcher
    from voicecraft_tpu_torch.inference.streaming import stream_tts
    from voicecraft_tpu_torch.inference.tts import decode_geometry, run_decode
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import (SamplingConfig,
                                                        init_mtp_heads)
    from voicecraft_tpu_torch.ops import _native, graphs
    from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
    cfg = model.cfg
    K, L = cfg.n_codebooks, cfg.num_decoder_layers
    sampled = SamplingConfig(top_k=40, top_p=1.0, temperature=1.0)
    greedy = SamplingConfig(top_k=40, top_p=1.0, temperature=0.0)
    bench_scfg = SamplingConfig(top_k=40, top_p=1.0, temperature=1.0,
                                stop_repetition=3)
    out = []

    def counted(label, fn, want_flash):
        """fn(), its wall s; the launch counts set to 0 just before and read
        just after: the attention kernel want_flash times (an int, or a
        function of fn's result), no FFN kernel."""
        _native.reset_launch_counts()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_native.LAUNCHES)
        want = want_flash(res) if callable(want_flash) else want_flash
        check_launches(label, launches, {"flash_prefix_attention": want,
                                         "fused_ffn": 0})
        out.append(launches)
        return res, wall

    def engine_run(label, m, reqs, scfg, lanes=ENGINE_LANES,
                   pads=SERVE_PADS, record=False, **kw):
        """Every request of reqs through one ContinuousBatcher.run(): the
        attention kernel L times a prefill call (the wave and each refill)
        when x_pad + y_pad >= 1024.  Returns (results in order, engine,
        recorder or None)."""
        eng = ContinuousBatcher(m, lanes=lanes, x_pad=pads[0], y_pad=pads[1],
                                gen_max=pads[2], burst=ENGINE_BURST,
                                scfg=scfg, seed=SEED, **kw)
        ids = [eng.submit(x, y) for x, y in reqs]
        kernel = pads[0] + pads[1] >= 1024
        rec = EngineRecorder() if record else contextlib.nullcontext()
        with rec:
            res, wall = counted(label, eng.run, lambda _: L * (
                eng.stats["waves"] + eng.stats["refills"]) * kernel)
        outs = [res[i] for i in ids]
        st = eng.stats
        frames = sum(g.shape[1] for _, g in outs)
        unit = "pass" if kw.get("spec") else "step"
        units = "passes" if kw.get("spec") else "steps"
        log(f"  ({label}) {len(reqs)} requests over {lanes} lanes, burst "
            f"{ENGINE_BURST}, Sp {pads[0] + pads[1]}, gen_max {pads[2]}: "
            f"{st['bursts']} bursts, {st['steps']} {units}, prefills: "
            f"{st['waves']} wave + {st['refills']} refills; {frames} frames "
            f"in {wall:.3f} s = {frames / wall:.1f} frames/s aggregate "
            f"({st['steps'] / wall:.1f} {units}/s), "
            f"{frames / (st['steps'] * lanes):.2f} frames a lane {unit}"
            f"{'' if kw.get('spec') else ' (lane occupancy)'}")
        for (full, gen), (x, y) in zip(outs, reqs):
            if not (np.array_equal(full[:, :y.shape[1]], y)
                    and full.shape == (K, y.shape[1] + gen.shape[1])
                    and 0 < gen.shape[1] < pads[2]):
                raise AssertionError(f"({label}): bad result {full.shape}, "
                                     f"{gen.shape}")
            if scfg.temperature > 0:     # greedy runs meet their references
                check_wav(label, codec, ccfg, full)
        return outs, eng, (rec if record else None)

    def single_stream(label, x, codes):
        """The request's greedy single-stream decode (run_decode, as
        inference_tts runs it), its rows and their draws."""
        prefix = compose_tts_prefix(codes, cfg)
        gx, gy, _ = decode_geometry(cfg, len(x), prefix.length,
                                    gen_max=GEN_MAX)
        with DrawRecorder() as rec1:
            (ref, _), _ = counted(label, lambda: run_decode(
                model, is_tts=True, x_tokens=x, prefix=prefix, n_spans=1,
                scfg=greedy, seed=SEED, gen_max=GEN_MAX, return_raw=True),
                L if gx + gy >= 1024 else 0)
        return ref, rec1.by_index()

    def capped(rows, ref, ref_la):
        # the engine keeps gen_max - 1 rows of a lane its cap stops (the
        # JAX engine's rule), the single stream gen_max
        if len(rows) == GEN_MAX - 1 and len(ref) == GEN_MAX:
            return ref[:-1], ref_la[:-1]
        return ref, ref_la

    # ---- (o) the continuous-batching engine ----
    reqs = ([(r.x, r.codes) for r in serve]
            + [(x2, r.codes) for r, x2 in zip(serve, texts2)])
    names = [f"{SERVE_SECONDS[i % len(serve)]} s, text {i // len(serve) + 1}"
             for i in range(len(reqs))]
    log(f"[8 engine] (o) {len(reqs)} requests: (j)'s {len(serve)} prompts "
        f"with two texts each, x_lens {[len(x) for x, _ in reqs]}")
    _, eng, rec = engine_run("o greedy", model, reqs, greedy, record=True)
    if eng.stats["waves"] + eng.stats["refills"] < 2:
        raise AssertionError(f"(o): no lane was refilled: {eng.stats}")
    plain = [rec.request(rid) for rid in range(len(reqs))]
    for i in range(len(reqs)):
        (x, codes), (rows, la) = reqs[i], plain[i]
        ref, ref_la = single_stream(f"o request {i} single stream", x, codes)
        ref, ref_la = capped(rows, ref, ref_la)
        same_under_ties(f"(o) request {i} ({names[i]}) vs its single-stream "
                        f"decode", rows, ref, la, ref_la)
    engine_run("o sampled", model, reqs, sampled)
    # one burst of PROFILE_STEPS + 2 steps after the startup wave, stepped
    # eagerly (the profile's window is kept by the step's Python calls)
    peng = ContinuousBatcher(model, lanes=ENGINE_LANES, x_pad=SERVE_PADS[0],
                             y_pad=SERVE_PADS[1], gen_max=SERVE_PADS[2],
                             burst=PROFILE_STEPS + 2, scfg=sampled, seed=SEED)
    for x, y in reqs[:ENGINE_LANES]:
        peng.submit(x, y)
    engages, graphs.step_graph_engages = (graphs.step_graph_engages,
                                          lambda m: False)
    try:
        (ops, ms), _ = counted("o profile", lambda: (
            peng._admit(), step_profile(
                lambda: peng._dispatch_burst().read(), PROFILE_STEPS, em,
                "_lane_decode_step"))[1], L)
    finally:
        graphs.step_graph_engages = engages
    log(f"  (o) engine step at B={ENGINE_LANES}, sampled: "
        f"{'not measured' if ops is None else f'{ops:.1f}'} device "
        f"operations and {'not measured' if ms is None else f'{ms:.4f}'} "
        f"device ms per step (torch.profiler, {PROFILE_STEPS} steps of one "
        f"burst)")
    del peng

    # bench.py's engine geometry: 2 x 32 requests, targets 60-100% of the
    # frames through the x_len length cap, fp8 weights and slab
    qmodel = quantize_decoder_fp8(model, pack_qkv=True)
    rng = np.random.default_rng(SEED + 2)
    cap = cfg.encodec_sr // 5
    breqs = []
    for i in range(2 * BENCH_LANES):
        target = int(BENCH_ENGINE_FRAMES
                     * (0.6 + 0.4 * (i % BENCH_LANES) / (BENCH_LANES - 1)))
        breqs.append((rng.integers(0, cfg.text_vocab_size,
                                   (target + BENCH_PROMPT) // cap + 1),
                      rng.integers(0, cfg.audio_vocab_size,
                                   (K, BENCH_PROMPT))))
    log(f"  (o) bench.py's engine geometry: {2 * BENCH_LANES} requests, "
        f"{BENCH_PROMPT}-frame random prompts, targets 60-100% of "
        f"{BENCH_ENGINE_FRAMES} frames, quantize_decoder_fp8(pack_qkv=True), "
        f"fp8 slab")
    _, eng, _ = engine_run("o bench", qmodel, breqs, bench_scfg,
                           lanes=BENCH_LANES,
                           pads=(BENCH_X_PAD, BENCH_Y_PAD,
                                 BENCH_ENGINE_FRAMES + 16),
                           kv_dtype="float8_e4m3fn")
    # the fp8 slab is read by the ring kernel, once a layer and step
    if out[-1]["ring_decode_attention"] != L * eng.stats["steps"]:
        raise AssertionError(f"(o bench) ring_decode_attention launched "
                             f"{out[-1]['ring_decode_attention']} times, want "
                             f"{L} x {eng.stats['steps']} steps")
    del qmodel

    # the speculative engine, random MTP heads
    model.mtp_heads = init_mtp_heads(
        dataclasses.replace(cfg, n_mtp=N_MTP),
        torch.Generator(device="cuda").manual_seed(SEED + 4), "cuda")
    log(f"  (o) speculative engine: {N_MTP} random MTP head groups, tau {TAU}")
    _, eng, rec = engine_run("o speculative greedy", model, reqs, greedy,
                             record=True, spec=TAU)
    for rid, (rows_p, la_p) in enumerate(plain):
        rows, la = rec.request(rid)
        same_under_ties(f"(o) speculative request {rid} vs the plain "
                        f"engine's", rows, rows_p, la, la_p)
    rows = sum(len(r) for r in rec.kept.values())
    passes = sum(sum(t < len(rec.kept[rid]) for t in rec.pass_counts(rid))
                 for rid in rec.kept)
    log(f"  (o) speculative greedy: {rows / passes:.2f} tokens a pass a lane "
        f"({rows} rows in the {passes} passes that found their request "
        f"unfinished)")
    _, eng, rec = engine_run(
        "o speculative force_accept", model, reqs[:ENGINE_LANES], greedy,
        record=True, spec=TAU, spec_force_accept=True)
    full_passes = []
    for rid in range(ENGINE_LANES):
        n, ts = len(rec.kept[rid]), rec.pass_counts(rid)
        full_passes += [b - a for a, b in zip(ts, ts[1:]) if a + TAU <= n]
    per = float(np.mean(full_passes))
    log(f"  (o) force_accept: {len(full_passes)} passes that ended inside "
        f"their lane's rows accepted {per:.2f} tokens a pass")
    if set(full_passes) != {TAU}:
        raise AssertionError(f"(o) force_accept: {sorted(set(full_passes))} "
                             f"tokens a pass, not {TAU}")
    del model.mtp_heads

    # ---- (p) streaming TTS of request (a)'s prompt ----
    x_a, codes_a = a_req.x, a_req.codes
    prefix_a = compose_tts_prefix(codes_a, cfg)
    gx, gy, _ = decode_geometry(cfg, len(x_a), prefix_a.length,
                                gen_max=GEN_MAX)
    ref, ref_la = single_stream("p single stream", x_a, codes_a)
    streams = {}
    for pipe in (True, False):
        def stream():
            t0, chunks, first = time.perf_counter(), [], None
            for c in stream_tts(model, x_a, codes_a, greedy, seed=SEED,
                                codec=codec, burst=ENGINE_BURST,
                                gen_max=GEN_MAX, pipeline=pipe):
                if first is None and c["audio"].size:
                    first = time.perf_counter() - t0
                chunks.append(c)
            return chunks, first
        with EngineRecorder() as rec:
            (chunks, first), wall = counted(f"p pipeline {pipe}", stream,
                                            L if gx + gy >= 1024 else 0)
        gen = chunks[-1]["gen"]
        audio = np.concatenate([c["audio"] for c in chunks])
        log(f"  (p) stream_tts, 17.28 s prompt, Sp {gx + gy}, greedy, burst "
            f"{ENGINE_BURST}, pipeline {pipe}: {len(chunks)} chunks, "
            f"{gen.shape[1]} frames, first audio after {first * 1e3:.1f} ms, "
            f"{audio.size / ccfg.sample_rate:.2f} s of audio in {wall:.3f} s "
            f"= {audio.size / ccfg.sample_rate / wall:.2f}x realtime")
        if not np.array_equal(np.concatenate([c["frames"] for c in chunks],
                                             axis=1), gen):
            raise AssertionError("(p): the streamed frames are not gen")
        rows, la = rec.request(0)
        r2, la2 = capped(rows, ref, ref_la)
        same_under_ties(f"(p) stream, pipeline {pipe}, vs the single "
                        f"stream", rows, r2, la, la2)
        one_shot = ec.decode_bucketed(codec, gen[None])[0]
        err = float(np.abs(audio - one_shot).max()) if audio.size else 0.0
        if audio.shape != one_shot.shape:
            raise AssertionError(f"(p): audio {audio.shape} against "
                                 f"{one_shot.shape}")
        check("streamed audio vs decode_bucketed of gen", err,
              CODEC_WAV_TOL)
        streams[pipe] = gen
    if not np.array_equal(streams[True], streams[False]):
        raise AssertionError("(p): pipeline on and off differ")

    # ---- (q) the HTTP server, in process ----
    t0 = time.time()
    args = serve_torch_cli.build_parser().parse_args([
        "--model", "giga830M", "--random-init", "--device", "cuda",
        "--seed", str(SEED),
        "--text-backend", "grapheme", "--batch-window-ms", "500"])
    server_eng = serve_torch_cli.Engine(args)
    waves = []

    class Waves(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("micro-batch wave"):
                waves.append(record.getMessage())

    slog = logging.getLogger("voicecraft_tpu_torch.serve")
    handler = Waves()
    slog.addHandler(handler)
    slog.setLevel(logging.INFO)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                serve_torch_cli.make_handler(server_eng))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    log(f"  (q) serve_torch_cli.Engine on giga830M built in "
        f"{time.time() - t0:.1f} s, serving {base}")

    def post(path, payload, raw=False):
        req = urllib.request.Request(base + path,
                                     data=js.dumps(payload).encode(),
                                     method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            if r.status != 200:
                raise AssertionError(f"(q) {path}: HTTP {r.status}")
            body, first = b"", None
            while True:
                blk = r.read(65536)
                if not blk:
                    break
                if first is None and len(body) + len(blk) > 44:
                    first = time.perf_counter() - t0
                body += blk
        lat = time.perf_counter() - t0
        return (body, first, lat) if raw else (js.loads(body), lat)

    def check_tts(name, res, lat):
        pcm = pcm_of(res["wav_b64"])
        log(f"  (q) {name}: HTTP 200 in {lat:.3f} s, {res['gen_sec']:.2f} s "
            f"generated")
        if not (res["gen_sec"] > 0 and pcm.size == round(res["gen_sec"] *
                                                         ccfg.sample_rate)
                and np.abs(pcm).max() > 0):
            raise AssertionError(f"(q) {name}: {pcm.size} samples for "
                                 f"{res['gen_sec']} s")

    demo_b64 = base64.b64encode((REPO / "demo" / "demo.wav").read_bytes()
                                ).decode()
    try:
        _native.reset_launch_counts()
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            info = js.loads(r.read())
        log(f"  (q) /healthz: HTTP {r.status}, {info}")
        results = [None, None]

        def tts(i, text):
            results[i] = post("/tts", {
                "prompt_wav_b64": demo_b64, "prompt_end_sec": 2.0,
                "prompt_transcript": "the sound of birds",
                "target_transcript": text, "seed": SEED})

        ths = [threading.Thread(target=tts, args=(i, t))
               for i, t in enumerate(["the river runs", "the old mill"])]
        [t.start() for t in ths]
        [t.join() for t in ths]
        for i, r in enumerate(results):
            if r is None:
                raise AssertionError(f"(q) /tts {i} failed")
            check_tts(f"/tts {i} (concurrent)", *r)
        log(f"  (q) micro-batch waves: {waves}")
        if not any("2 slot(s) [tts,tts]" in w for w in waves):
            raise AssertionError("(q): the two /tts did not share a wave")
        rr, lat = post("/rerun", {"session": results[0][0]["session"],
                                  "sentence_idx": 0, "seed": 7})
        one = pcm_of(rr["sentence_wav_b64"])
        log(f"  (q) /rerun: HTTP 200 in {lat:.3f} s, {one.size} samples")
        if not (0 < one.size == pcm_of(rr["wav_b64"]).size
                and one.size % ccfg.hop_length == 0):
            raise AssertionError("(q) /rerun: bad audio")
        with open(REPO / "demo" / "demo_alignment.csv") as f:
            rows = [{k: (float(v) if k in ("Begin", "End") else v)
                     for k, v in r.items()} for r in csv.DictReader(f)]
        ed, lat = post("/edit", {
            "wav_b64": demo_b64, "orig_transcript": PROMPT,
            "target_transcript": EDIT_TARGET, "edit_type": "substitution",
            "alignment": rows, "seed": SEED})
        s, e = ed["edit_interval_frames"]
        pcm = pcm_of(ed["wav_b64"])
        kept = 216 - (e - s)
        log(f"  (q) /edit (demo_alignment.csv rows): HTTP 200 in {lat:.3f} "
            f"s, frames [{s}, {e}) regenerated, {pcm.size} samples")
        if not (0 < s < e <= 216 and pcm.size % ccfg.hop_length == 0
                and pcm.size >= kept * ccfg.hop_length):
            raise AssertionError("(q) /edit: bad result")
        launches = dict(_native.LAUNCHES)
        check_launches("q /tts, /rerun, /edit", launches,
                       {"flash_prefix_attention": 0, "fused_ffn": 0})
        out.append(launches)
        # the stream: the 17.28 s prompt, a text of letters every request
        # before has put in the server's vocabulary, 97-128 phones: Sp 1024
        text = " ".join(["the sound of birds"] * 6)
        n_ph = len(make_text_tokenizer("en-us", "grapheme").phonemize(text))
        if not 96 < n_ph <= 128:
            raise AssertionError(f"(q): stream text of {n_ph} phones")
        (body, first, lat), _ = counted("q /tts_stream", lambda: post(
            "/tts_stream", {
                "prompt_wav_b64": base64.b64encode(wav_bytes(long_wav)
                                                   ).decode(),
                "target_transcript": text, "seed": SEED, "burst": 48},
            raw=True), server_eng.cfg.num_decoder_layers)
        pcm = np.frombuffer(body[44:], dtype="<i2")
        log(f"  (q) /tts_stream (17.28 s prompt, {n_ph} phones, Sp 1024): "
            f"HTTP 200, first audio after {first * 1e3:.1f} ms, "
            f"{pcm.size / ccfg.sample_rate:.2f} s of audio in {lat:.3f} s")
        if not (body[:4] == b"RIFF" and body[8:12] == b"WAVE" and pcm.size
                and pcm.size % ccfg.hop_length == 0
                and np.abs(pcm).max() > 0):
            raise AssertionError("(q) /tts_stream: bad stream")
    finally:
        httpd.shutdown()
        httpd.server_close()
        slog.removeHandler(handler)
    return out


# ---- phase 9 -----------------------------------------------------------------

def write_training_manifest(root, tok, texts):
    """TRAIN_UTTS + TRAIN_VALID utterances in the reference's on-disk format
    (data/manifest.py:write_manifest_tree): random codes of 100-1,000 frames
    from a seed, each with the phones of one of ``texts``."""
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.data.manifest import write_manifest_tree
    cfg = PRESETS["giga830M"]()
    rng = np.random.default_rng(SEED)
    phones = [tok.phonemize(t) for t in texts]
    items = [{"id": f"utt{i:04d}", "phones": phones[i % len(phones)],
              "codes": rng.integers(0, cfg.audio_vocab_size,
                                    (cfg.n_codebooks, int(rng.integers(
                                        TRAIN_FRAMES[0], TRAIN_FRAMES[1] + 1))))}
             for i in range(TRAIN_UTTS + TRAIN_VALID)]
    write_manifest_tree(root, items[:TRAIN_UTTS], cfg, "train")
    write_manifest_tree(root, items[TRAIN_UTTS:], cfg, "validation")
    return [it["codes"].shape[1] for it in items]


def grad_errors(got: dict, want: dict):
    """Per-tensor ||got - want|| / max(||want||, TRAIN_GRAD_FLOOR x the
    largest ||want||): (the worst, its name, the median)."""
    norms = {n: w.float().norm().item() for n, w in want.items()}
    floor = TRAIN_GRAD_FLOOR * max(norms.values())
    errs = {n: (got[n].float().cpu() - want[n].float().cpu()).norm().item()
            / max(norms[n], floor) for n in want}
    worst = max(errs, key=errs.get)
    return errs[worst], worst, float(np.median(list(errs.values())))


def numerics_check(root, recipe_cfg, tcfg):
    """(r): forward_train's loss and gradients at giga830M width cut to
    NUMERICS_LAYERS layers, the card (bf16 compute, f32 master weights)
    against the CPU (f32), then chunked against dense on the card."""
    import dataclasses
    import torch
    from voicecraft_tpu_torch.data.manifest import ManifestDataset, collate_train
    from voicecraft_tpu_torch.models.voicecraft import VoiceCraft, forward_train
    cfg = dataclasses.replace(recipe_cfg, num_decoder_layers=NUMERICS_LAYERS)
    ds = ManifestDataset(cfg, tcfg, "train")
    idxs = [i for i, n in enumerate(ds.lengths) if n <= NUMERICS_FRAMES]
    idxs = idxs[:NUMERICS_UTTS]

    def run(model, device):
        batch = collate_train(ds, idxs, np.random.default_rng(SEED),
                              device=device)
        out = forward_train(model, batch, seed=None, remat=True)
        out["loss"].backward()
        return (out, {n: p.grad for n, p in model.named_parameters()},
                batch)

    t0 = time.time()
    cpu = VoiceCraft(dataclasses.replace(cfg, compute_dtype="float32"), "cpu",
                     trainable=True).init_weights(
                         torch.Generator().manual_seed(SEED))
    want, want_g, batch = run(cpu, "cpu")
    t_cpu = time.time() - t0
    results = {}
    for attn in ("chunked", "dense"):
        card = VoiceCraft(dataclasses.replace(cfg, train_attn=attn), "cuda",
                          trainable=True)
        card.load_state_dict(cpu.state_dict())
        results[attn] = run(card, "cuda")[:2]
    B, Sx = batch.x.shape
    log(f"  (r) {NUMERICS_LAYERS} layers at giga830M width, B={B}, "
        f"S={Sx}+{batch.y_tokens.shape[2]}, {int(want['effective_ntoken'])} "
        f"targets; the CPU in f32 took {t_cpu:.1f} s")
    for name, (got, got_g), (ref, ref_g) in (
            ("card bf16 (chunked) vs CPU f32", results["chunked"], (want, want_g)),
            ("chunked vs dense, both on the card", results["chunked"],
             results["dense"])):
        rel = abs(got["loss"].item() - ref["loss"].item()) / abs(ref["loss"].item())
        err, worst, med = grad_errors(got_g, ref_g)
        log(f"  (r) {name}: loss {got['loss'].item():.4f} vs "
            f"{ref['loss'].item():.4f}, rel {rel:.2e} (tolerance "
            f"{TRAIN_LOSS_RTOL:g}); gradients' relative-norm error: worst "
            f"{err:.2e} ({worst}; tolerance {TRAIN_GRAD_RTOL:g}), median "
            f"{med:.2e} (tolerance {TRAIN_GRAD_MEDIAN:g})")
        if not (rel <= TRAIN_LOSS_RTOL and err <= TRAIN_GRAD_RTOL
                and med <= TRAIN_GRAD_MEDIAN):
            raise AssertionError(f"(r) {name}: loss rel {rel}, gradient "
                                 f"error {err} at {worst}, median {med}")
        if got["effective_ntoken"].item() != ref["effective_ntoken"].item():
            raise AssertionError(f"(r) {name}: the target counts differ")


def attention_yardstick(batch, nhead, D):
    """The chunked training attention's forward + backward for one layer
    at a training batch's shape, beside PyTorch's fused attention under the
    same mask (library_attention) and the bound: q/k/v/dO read and
    o/dq/dk/dv written once, 12 x D flops for each allowed (query, key)
    pair (the forward's two products and the backward's four)."""
    import torch
    from voicecraft_tpu_torch.ops.attention import segment_padding_bias
    from voicecraft_tpu_torch.ops.flash_attention import chunked_attention
    B, Sx = batch.x.shape
    S = Sx + batch.y_tokens.shape[2]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, g = (torch.randn((B, S, D), generator=gen, device="cuda")
                  .to(torch.bfloat16).requires_grad_(i < 3) for i in range(4))
    allowed = segment_padding_bias(S, Sx, batch.x_lens, batch.y_lens)[:, 0] == 0
    heads = lambda t: t.view(B, S, nhead, D // nhead).transpose(1, 2)

    def chunked():
        chunked_attention(q, k, v, batch.x_lens, batch.y_lens, Sx,
                          nhead).backward(g)

    def library():
        library_attention(heads(q), heads(k), heads(v),
                          allowed[:, None]).backward(heads(g))

    t = dict(ms=cuda_ms(chunked, reps=5, warmup=2),
             library_ms=cuda_ms(library, reps=5, warmup=2))
    t["bound_ms"], t["bound_by"] = bound(8 * B * S * D * 2,
                                         12 * D * allowed.sum().item(),
                                         BF16_FLOP_PER_S)
    log(f"  chunked attention fwd+bwd, one layer, B={B} S={S} D={D} "
        f"H={nhead}: {t['ms']:.3f} ms (eager, CUDA events); PyTorch's fused "
        f"attention, same mask: {t['library_ms']:.3f} ms; bound "
        f"{t['bound_ms']:.3f} ms ({t['bound_by']})")
    return t


def step_parts(model, opt, batch):
    """Where a training step's time goes: the forward, the backward with
    its recompute and the optimizer's update, each alone.  {part: [wall ms
    between host syncs, device ms, device operations]}, the device numbers
    from a second run under torch.profiler."""
    import torch
    from voicecraft_tpu_torch.models.voicecraft import forward_train
    parts, out = {}, {}
    steps = (("forward", lambda: out.update(forward_train(model, batch))),
             ("backward", lambda: out.pop("loss").backward()),
             ("optimizer", opt.step))
    opt.zero_grad()
    for part, fn in steps:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        parts[part] = [(time.perf_counter() - t) * 1e3]
    opt.zero_grad()
    out.clear()
    for part, fn in steps:
        parts[part] += list(device_time(fn)[1:])
    return parts


def training_phase(requests, codec, tok, tmp):
    """Phase 9: training at giga830M with the e830M recipe.  (r) numerics,
    card against CPU; (s) Trainer.train for TRAIN_STEPS steps at
    TRAIN_TOKENS, validate and save, then one fixed batch for FIXED_STEPS
    steps without dropout; the chunked attention's yardstick; (t) one step
    at the recipe's RECIPE_TOKENS; (u) the trained checkpoint through
    load_model serving request (a)'s prompt, its launch counts set to 0
    just before and read just after.  The manifest and the checkpoints are
    written under ``tmp`` (phase 10 exports the checkpoint and trains on
    the manifest).  Returns ((u)'s launch counts, the yardstick)."""
    import dataclasses
    import gc
    import torch
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.config import TrainConfig
    from voicecraft_tpu_torch.data.manifest import collate_train
    from voicecraft_tpu_torch.data.phonemes import phones_to_ids
    from voicecraft_tpu_torch.inference.loader import load_model
    from voicecraft_tpu_torch.inference.tts import inference_tts
    from voicecraft_tpu_torch.models.voicecraft import (SamplingConfig,
                                                        VoiceCraft)
    from voicecraft_tpu_torch.ops import _native
    from voicecraft_tpu_torch.training.optim import (ScaledAdam,
                                                     eden_schedule,
                                                     stacked_leaves)
    from voicecraft_tpu_torch.training.step import make_train_step
    from voicecraft_tpu_torch.training.trainer import Trainer

    recipe = dataclasses.replace(PRESETS["giga830M"](), **RECIPE)
    w = recipe.codebook_weight
    uniform_ce = float(np.log(recipe.card) * np.mean(w))
    root = os.path.join(tmp, "data")
    texts = (serving_texts() + serving_texts(ENGINE_TEXT_START)
             + [r.transcript + " " + TARGET for r in requests])
    t0 = time.time()
    frames = write_training_manifest(root, tok, texts)
    log(f"[9 training] {TRAIN_UTTS} + {TRAIN_VALID} utterances of "
        f"{min(frames)}-{max(frames)} frames written in "
        f"{time.time() - t0:.1f} s; free disk "
        f"{shutil.disk_usage(tmp).free / 1e9:.0f} GB")

    def tcfg(exp, tokens):
        return TrainConfig(dataset_dir=root, exp_dir=os.path.join(tmp, exp),
                           max_num_tokens=tokens, lr=0.05,
                           optimizer_name="ScaledAdam", seed=1,
                           val_every_n_steps=10 ** 6,
                           print_every_n_steps=1)

    # ---- (r) numerics, card against CPU ----
    numerics_check(root, recipe, tcfg("r", TRAIN_TOKENS))
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (s) the Trainer, the recipe's settings at TRAIN_TOKENS ----
    t0 = time.time()
    tr = Trainer(recipe, tcfg("exp", TRAIN_TOKENS), device="cuda")
    torch.cuda.synchronize()
    log(f"  (s) Trainer built in {time.time() - t0:.1f} s: "
        f"{sum(p.numel() for p in tr.model.parameters()) / 1e6:.1f}M f32 "
        f"parameters, {len(tr.optimizer.groups)} ScaledAdam leaves, "
        f"{len(tr.batcher.epoch_batches(0))} batches an epoch")
    save, saves = tr.save, []

    def timed_save(tag, **kw):
        t = time.perf_counter()
        save(tag, **kw)
        saves.append(f"{tag} {time.perf_counter() - t:.1f} s")
    tr.save = timed_save
    rec = timed_train(tr, TRAIN_STEPS, "(s)", profiled=PROFILED_STEPS,
                      opt_ops_step=OPT_OPS_STEP)
    base, peak, t_train = rec["base"], rec["peak"], rec["seconds"]
    ms = rec["metrics"]
    for i, (m, wall, shp) in enumerate(zip(ms, rec["wall"], rec["shape"])):
        ntok = float(m["effective_ntoken"])
        log(f"  (s) step {i + 1}: B={shp[0]} S={shp[1]}+{shp[2]}, "
            f"{ntok:.0f} targets, loss/token "
            f"{float(m['loss']) / ntok:.4f}, top10acc "
            f"{float(m['top10acc']) / ntok:.4f}, {wall:.3f} s, "
            f"optimizer {rec['opt_ms'][i]:.1f} ms")
    first = float(ms[0]["loss"]) / float(ms[0]["effective_ntoken"])
    if abs(first - uniform_ce) > STEP1_RTOL * uniform_ce:
        raise AssertionError(f"(s) step 1's loss per token {first} is not "
                             f"within {STEP1_RTOL} of {uniform_ce}")
    rate = [i - 1 for i in RATE_STEPS]
    ntoks = sum(float(ms[i]["effective_ntoken"]) for i in rate)
    positions = sum(b * (sx + sy) for b, sx, sy in
                    (rec["shape"][i] for i in rate))
    wall = sum(rec["wall"][i] for i in rate)
    opt_ms = [rec["opt_ms"][i] for i in rate]
    busy, window, n_ev = rec["profile"]
    hist = tr.progress["history"]
    log(f"  (s) step 1 loss/token {first:.4f} vs ln(card) x mean(w) "
        f"{uniform_ce:.4f} (tolerance {STEP1_RTOL:.0%}); steps "
        f"{RATE_STEPS[0]}-{RATE_STEPS[-1]}: {ntoks / wall:.0f} target "
        f"tokens/s, {positions / wall:.0f} positions/s, "
        f"{wall / len(rate):.3f} s a step, the optimizer update "
        f"{np.mean(opt_ms):.1f} ms of it; {rec['opt_ops']} device "
        f"operations an update (step {OPT_OPS_STEP}); peak allocated "
        f"{peak:.2f} GB ({base:.2f} GB before train(): the Trainer's "
        f"weights and optimizer and the earlier phases'); device busy {busy / window:.1%} of steps "
        f"{PROFILED_STEPS[0]}-{PROFILED_STEPS[-1]} ({busy:.1f} of "
        f"{window:.1f} ms, {n_ev / len(PROFILED_STEPS):.0f} device "
        f"operations a step, torch.profiler; derived: its "
        f"{busy / len(PROFILED_STEPS):.1f} device ms a step over steps "
        f"{RATE_STEPS[0]}-{RATE_STEPS[-1]}'s unprofiled "
        f"{wall / len(rate) * 1e3:.1f} ms a step = "
        f"{busy / len(PROFILED_STEPS) / (wall / len(rate) * 1e3):.1%}); "
        f"train() {t_train:.1f} s "
        f"with the validation (score {hist[-1][1]:.4f}) and the saves ("
        f"{', '.join(saves)})")
    ckpt = os.path.join(tr.tcfg.exp_dir, "ckpt_latest")
    if not (os.path.isfile(os.path.join(ckpt, "model.pt"))
            and np.isfinite(hist[-1][1])):
        raise AssertionError(f"(s) no checkpoint or validation: {hist}")
    fixed = collate_train(tr.train_ds, tr.batcher.epoch_batches(0)[0],
                          np.random.default_rng(SEED), device="cuda")
    del tr, rec, save
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (s) one fixed batch, no dropout ----
    quiet = dataclasses.replace(
        recipe, text_embedding_dropout=0.0,
        text_positional_embedding_dropout=0.0,
        audio_positional_embedding_dropout=0.0, trm_dropout=0.0)
    model = VoiceCraft(quiet, "cuda", trainable=True).init_weights(
        torch.Generator(device="cuda").manual_seed(SEED))
    t = TrainConfig()
    opt = ScaledAdam(stacked_leaves(model), lr=eden_schedule(
        t.lr, t.reduce_lr_start_step, t.reduce_lr_start_epoch,
        t.num_steps * t.warmup_fraction, t.pseudo_epoch_size),
        clipping_update_period=t.clipping_update_period)
    step = make_train_step(model, opt)
    losses = []
    for i in range(FIXED_STEPS):
        m = step(fixed, seed=None)
        losses.append(m["loss"].item() / m["effective_ntoken"].item())
    log(f"  (s) one fixed batch (B={fixed.x.shape[0]}, S={fixed.x.shape[1]}"
        f"+{fixed.y_tokens.shape[2]}), no dropout, loss/token by step: "
        + ", ".join(f"{v:.4f}" for v in losses))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(s) the fixed batch's loss did not fall: "
                             f"{losses}")
    parts = step_parts(model, opt, fixed)
    log("  (s) one step of the fixed batch by part (wall ms; device ms, "
        "device operations): " + "; ".join(
            f"{k} {w:.1f} ({d:.1f}, {n})" for k, (w, d, n) in parts.items()))
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    yard = attention_yardstick(fixed, recipe.nhead, recipe.d_model)

    # ---- (t) the recipe's budget ----
    tr = Trainer(recipe, tcfg("t", RECIPE_TOKENS), device="cuda")
    _, batch = next(tr._prefetch(0, tr.batcher.epoch_batches(0), 0))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = tr.step_fn(batch, tr.next_seed())
    torch.cuda.synchronize()
    log(f"  (t) one step at max_num_tokens {RECIPE_TOKENS}: B="
        f"{batch.x.shape[0]} S={batch.x.shape[1]}+{batch.y_tokens.shape[2]}"
        f" (the bucket cap, int(budget / boundary), is 8 rows at either "
        f"budget), {time.perf_counter() - t0:.3f} s (the first step), "
        f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"({base:.2f} before the step) of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.0f}, "
        f"loss/token {m['loss'].item() / m['effective_ntoken'].item():.4f}")
    if m["is_nan"]:
        raise AssertionError("(t): the step skipped a NaN loss")
    del tr, batch, m
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (u) the pipeline: the trained checkpoint serves TTS ----
    a = requests[0]
    t0 = time.time()
    cfg_u, model_u, phn2num = load_model(ckpt, device="cuda")
    x = np.asarray(phones_to_ids(a.phones, phn2num), np.int32)
    if model_u.dtype != torch.bfloat16 or len(x) != len(a.x):
        raise AssertionError(f"(u): dtype {model_u.dtype}, x {len(x)} of "
                             f"{len(a.x)} phones")
    t_load = time.time() - t0
    _native.reset_launch_counts()
    stats = {}
    t0 = time.time()
    full, gen = inference_tts(model_u, x, a.codes,
                              SamplingConfig(top_k=40, temperature=0.0),
                              seed=SEED, gen_max=U_GEN_MAX, stats=stats)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_native.LAUNCHES)
    log(f"  (u) ckpt_latest loaded in {t_load:.1f} s ({model_u.dtype}); "
        f"request (a)'s prompt, Sp {stats['prefill_len']}, greedy: "
        f"{gen.shape[1]} frames in {wall:.3f} s")
    check_launches("u", launches, {"flash_prefix_attention":
                                   cfg_u.num_decoder_layers,
                                   "fused_ffn": 0})
    if not (np.array_equal(full[:, :a.codes.shape[1]], a.codes)
            and stats["prefill_len"] >= 1024):
        raise AssertionError("(u): the prompt frames changed or the "
                             "prefill missed the kernel")
    check_wav("u", codec, codec.cfg, full)
    del model_u
    gc.collect()
    torch.cuda.empty_cache()
    return launches, yard


# ---- phase 11 ----------------------------------------------------------------

def closed_stream(rank, model, mesh, x, codes, lanes):
    """stream_tts of (x, codes) over ``mesh``, greedy, bursts of
    ENGINE_BURST: rank 0's consumer closes the generator after the first
    chunk (a client that hangs up), every other rank drains its own (as
    serve_torch_cli.py's followers do).  Returns this rank's numbers: the
    first chunk's frames, the frames handed over, the stats, whether a
    last chunk came, the wall s."""
    from voicecraft_tpu_torch.inference.streaming import stream_tts
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    greedy = SamplingConfig(top_k=40, top_p=1.0, temperature=0.0)
    stats = {}
    t0 = time.time()
    it = stream_tts(model, x, codes, greedy, seed=SEED, burst=ENGINE_BURST,
                    gen_max=GEN_MAX, mesh=mesh, lanes=lanes, stats=stats)
    chunks = [next(it)]
    if rank == 0:
        it.close()
    else:
        chunks += list(it)
    return dict(first=chunks[0]["frames"].shape[1],
                frames=sum(c["frames"].shape[1] for c in chunks),
                stats=dict(stats), last="gen" in chunks[-1],
                wall=time.time() - t0)


def check_closed(label, every):
    """Every rank's closed stream (closed_stream) stopped at the same burst,
    within one burst of the close: cancelled everywhere, the same frames
    handed over on every rank, at most the first chunk's plus a burst,
    and no last chunk on a rank that drained."""
    c0 = every[0]
    ok = all(c["stats"]["cancelled"] and c["first"] == c0["first"]
             and c["stats"]["frames"] == c0["stats"]["frames"]
             for c in every)
    ok = ok and all(c["frames"] == c["stats"]["frames"] and not c["last"]
                    for c in every[1:])
    ok = ok and c0["stats"]["frames"] <= c0["first"] + ENGINE_BURST
    log(f"  ({label}) a stream closed after its first chunk "
        f"({c0['first']} frames) on rank 0: frames handed over per rank "
        f"{[c['stats']['frames'] for c in every]}, cancelled "
        f"{[c['stats']['cancelled'] for c in every]}, the producer's "
        f"{c0['stats']['t_decode']:.3f} s on rank 0; within one burst "
        f"({ENGINE_BURST}) of the close on every rank: {ok}")
    if not ok:
        raise AssertionError(f"({label}) the closed stream: {every}")


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def mesh_phase(model, serve, work, a_req):
    """Phase 11: parallel/mesh.py on one card, a one-rank NCCL group and a
    1 x 1 mesh, against the same paths without a mesh: (j)'s 8-lane greedy
    wave through serve_tts_batch(mesh=) with the same tokens bit for bit
    (the attention kernel L times in its prefill, none a step); MESH_STEPS
    Trainer(mesh=) steps on phase 9's manifest with the same parameters bit
    for bit as Trainer()'s (ZeRO-1 is off at data 1, as in the JAX package;
    the end-of-run validation and checkpoint are left out: the --cards 4
    mode saves at 2 x 2); an engine run with the same results; (p)'s
    stream of request ``a_req``'s 17.28 s prompt over the mesh, closed
    after its first chunk: the engine stops within one burst.  ``model``
    (phase 6's) is sharded at 1 x 1 on the way: phase 11 runs last.
    Returns the launch counts of each mesh run."""
    import dataclasses
    import gc
    import torch
    import torch.distributed as dist
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.config import TrainConfig
    from voicecraft_tpu_torch.inference.engine import ContinuousBatcher
    from voicecraft_tpu_torch.inference.serving import serve_tts_batch
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    from voicecraft_tpu_torch.ops import _native
    from voicecraft_tpu_torch.parallel.mesh import (gather_params, make_mesh,
                                                    shard_params)
    from voicecraft_tpu_torch.training.trainer import Trainer
    L = model.cfg.num_decoder_layers
    greedy = SamplingConfig(top_k=40, top_p=1.0, temperature=0.0)
    reqs = [(r.x, r.codes) for r in serve]
    out = []
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, torch.device("cuda", torch.cuda.current_device()))
        log(f"[11 mesh] a one-rank NCCL group, a {mesh.n_data} x "
            f"{mesh.n_model} mesh on {mesh.device}")

        def engine(m):
            eng = ContinuousBatcher(m, lanes=MESH_ENGINE_LANES,
                                    x_pad=SERVE_PADS[0], y_pad=SERVE_PADS[1],
                                    gen_max=MESH_ENGINE_GEN, burst=ENGINE_BURST,
                                    scfg=greedy, seed=SEED, mesh=m.mesh)
            ids = [eng.submit(x, y) for x, y in reqs]
            res = eng.run()
            return [res[i] for i in ids], eng.stats

        # the references, without a mesh
        wave = lambda m: serve_tts_batch(m, reqs, greedy, pads=SERVE_PADS,
                                         seeds=SERVE_SEEDS, mesh=m.mesh)
        t0 = time.time()
        ref_wave, (ref_eng, ref_stats) = wave(model), engine(model)
        t_ref = time.time() - t0
        shard_params(model, mesh)
        _native.reset_launch_counts()
        t0 = time.time()
        got = wave(model)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_native.LAUNCHES)
        check_launches("11 wave at 1 x 1", launches,
                       {"flash_prefix_attention": L, "fused_ffn": 0})
        out.append(launches)
        same = all(np.array_equal(a[1], b[1]) for a, b in zip(got, ref_wave))
        log(f"  (j)'s {len(reqs)} lanes, greedy, through serve_tts_batch("
            f"mesh=) in {wall:.3f} s: frames {[g.shape[1] for _, g in got]}, "
            f"the no-mesh wave's tokens bit for bit: {same}")
        if not same:
            raise AssertionError("(11) the 1 x 1 wave differs from the "
                                 "no-mesh wave")
        _native.reset_launch_counts()
        t0 = time.time()
        got_eng, st = engine(model)
        wall = time.time() - t0
        launches = dict(_native.LAUNCHES)
        check_launches("11 engine at 1 x 1", launches, {
            "flash_prefix_attention": L * (st["waves"] + st["refills"]),
            "fused_ffn": 0})
        out.append(launches)
        same = (st == ref_stats and all(
            np.array_equal(a[1], b[1]) for a, b in zip(got_eng, ref_eng)))
        log(f"  the engine, {len(reqs)} requests over {MESH_ENGINE_LANES} "
            f"lanes at 1 x 1 in {wall:.3f} s ({st}): the no-mesh engine's "
            f"results bit for bit: {same} (both references {t_ref:.1f} s)")
        if not same:
            raise AssertionError("(11) the 1 x 1 engine differs from the "
                                 "no-mesh engine")
        _native.reset_launch_counts()
        closed = closed_stream(0, model, mesh, a_req.x, a_req.codes, 1)
        torch.cuda.synchronize()
        launches = dict(_native.LAUNCHES)
        check_launches("11 closed stream at 1 x 1", launches,
                       {"flash_prefix_attention": L, "fused_ffn": 0})
        out.append(launches)
        check_closed(f"11 (p) at 1 x 1 in {closed['wall']:.3f} s", [closed])

        # the Trainer on phase 9's manifest, MESH_STEPS steps each way
        recipe = dataclasses.replace(PRESETS["giga830M"](), **RECIPE)
        params = []
        for label, m in (("Trainer()", None), ("Trainer(mesh=1 x 1)", mesh)):
            tcfg = TrainConfig(
                dataset_dir=os.path.join(work, "data"),
                exp_dir=os.path.join(work, f"mesh11_{len(params)}"),
                max_num_tokens=TRAIN_TOKENS, lr=0.05,
                optimizer_name="ScaledAdam", seed=1,
                val_every_n_steps=10 ** 6, print_every_n_steps=1)
            t0 = time.time()
            tr = Trainer(recipe, tcfg, mesh=m, device="cuda")
            tr.validate_and_save = lambda: None
            tr.train(max_steps=MESH_STEPS)
            torch.cuda.synchronize()
            params.append({k: v.cpu() for k, v in gather_params(tr.model).items()})
            log(f"  {label}: {MESH_STEPS} steps in {time.time() - t0:.1f} s "
                f"(build included), step {tr.progress['step'] - 1}")
            del tr
            gc.collect()
            torch.cuda.empty_cache()
        same = all(torch.equal(params[0][k], params[1][k]) for k in params[0])
        log(f"  the parameters after {MESH_STEPS} steps, Trainer(mesh=1 x 1) "
            f"against Trainer(): bit for bit {same}")
        if not same:
            raise AssertionError("(11) Trainer(mesh=1 x 1) differs from "
                                 "Trainer()")
    finally:
        dist.destroy_process_group()
    return out


# ---- phase 13 ----------------------------------------------------------------

def recipe_phase():
    """Phase 13: recipes/spec_acceptance_torch.sh as a user runs it, with
    DEVICE=cuda, its default preset and RECIPE_ENV's overrides, WORK under
    build/, and ``python`` on the PATH (a script in build/ that execs this
    interpreter, as a symlink would not find a virtual environment's
    packages: the recipes call ``python``).  Its acceptance.json must parse,
    with tokens a pass and frames/s for every tau of RECIPE_TAUS in the
    single-stream, serving and engine sections.  Returns its wall s."""
    work = REPO / "build" / "recipe_spec"
    bindir = REPO / "build" / "recipe_bin"
    shutil.rmtree(work, ignore_errors=True)
    bindir.mkdir(parents=True, exist_ok=True)
    shim = bindir / "python"
    if shim.is_symlink() or shim.exists():
        shim.unlink()                 # never write through an old link
    shim.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    shim.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}",
               WORK=str(work), DEVICE="cuda", **RECIPE_ENV)
    t0 = time.time()
    res = subprocess.run(["bash", str(REPO / "recipes" /
                                      "spec_acceptance_torch.sh")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=RECIPE_TIMEOUT_S)
    wall = time.time() - t0
    if res.returncode != 0:
        log(res.stdout[-3000:] + res.stderr[-6000:])
        raise AssertionError(f"(13) the recipe exited {res.returncode}")
    acc = json.loads((work / "acceptance.json").read_text())
    single, serving, engine = acc["single"], acc["serving"], acc["engine"]
    rows = []
    for tau in RECIPE_TAUS:
        t = str(tau)
        row = (single[t]["tokens_per_pass"], single[t]["tokens_per_sec"],
               serving[t]["tokens_per_pass_per_lane"],
               serving[t]["frames_per_sec"], engine[t]["frames_per_pass"],
               engine[t]["frames_per_sec"])
        if not all(np.isfinite(v) and v > 0 for v in row):
            raise AssertionError(f"(13) tau {tau}: {row}")
        rows.append(f"tau {tau}: {row[0]:.2f} tokens a pass, {row[1]:.1f} "
                    f"tokens/s single; {row[2]:.2f} a pass a lane, "
                    f"{row[3]:.1f} frames/s serving; {row[4]:.2f} frames a "
                    f"pass, {row[5]:.1f} frames/s engine")
    log(f"[13 recipes] spec_acceptance_torch.sh (DEVICE=cuda, {RECIPE_ENV}, "
        f"n_mtp {acc['n_mtp']}) in {wall:.1f} s; plain "
        f"{single['plain_tokens_per_sec']:.1f} tokens/s single, "
        f"{serving['plain_frames_per_sec']:.1f} frames/s serving")
    for r in rows:
        log("  " + r)
    shutil.rmtree(work, ignore_errors=True)
    return wall


# ---- phase 14 ----------------------------------------------------------------

class BenchRun:
    """One bench_torch.main call in-process: its JSON lines, its stderr
    lines (logged under the label), its decoder forwards
    (counting_forwards) and its launch counts, set to 0 just before and
    read just after; ``profile`` = n also gives the device operations and
    device ms a decode step over n replayed steps of its first run
    (step_profile)."""

    def __init__(self, label, argv, profile=None):
        import bench_torch
        import torch
        from voicecraft_tpu_torch.ops import _native
        from voicecraft_tpu_torch.ops.graphs import StepGraph
        self.label, self.argv = label, list(argv)
        err = io.StringIO()
        _native.reset_launch_counts()
        t0 = time.time()
        try:
            with contextlib.redirect_stderr(err), counting_forwards() as count:
                self.costs = None
                if profile:
                    self.costs = step_profile(
                        lambda: setattr(self, "results",
                                        bench_torch.main(self.argv)),
                        profile, module=StepGraph, name="replay")
                else:
                    self.results = bench_torch.main(self.argv)
            torch.cuda.synchronize()
        finally:
            for line in err.getvalue().splitlines():
                log(f"  ({label}) {line}")
        self.wall = time.time() - t0
        self.forwards = count[0]
        self.launches = dict(_native.LAUNCHES)
        self.routes = dict(_native.ROUTE_LAUNCHES)
        self.err = err.getvalue()
        log(f"  ({label}) bench_torch.py {' '.join(self.argv)}: "
            f"{len(self.results)} lines in {self.wall:.1f} s, "
            f"{self.forwards} decode forwards; launches {self.launches}")

    def metrics(self):
        return [r["metric"] for r in self.results]

    def match(self, pattern):
        """The numbers of the first stderr line that ``pattern`` matches."""
        m = re.search(pattern, self.err)
        if m is None:
            raise AssertionError(f"({self.label}) no line matches {pattern!r}")
        return [float(g) for g in m.groups()]


def spliced_edit(model, x, codes, intervals, scfg, gen_max, stats, k):
    """inference_edit's decode run through run_decode(steps_per_iter=k),
    the generated spans spliced between the kept frames as inference_edit
    splices them; ``stats`` gets run_decode's counts and span_frames."""
    from voicecraft_tpu_torch.data.spans import compose_edit_prefix
    from voicecraft_tpu_torch.inference.tts import run_decode
    cfg = model.cfg
    shift = cfg.n_special if cfg.special_first else 0
    y = codes + shift
    intervals = sorted(intervals)
    prefix, queue_ids = compose_edit_prefix(y, intervals, cfg)
    gen = run_decode(model, is_tts=False, x_tokens=x, prefix=prefix,
                     queue_mask_ids=queue_ids, n_spans=len(intervals),
                     scfg=scfg, seed=SEED, gen_max=gen_max, stats=stats,
                     steps_per_iter=k)
    stats["span_frames"] = [g.shape[1] for g in gen]
    parts, lo = [], 0
    for (s, e), g in zip(intervals, gen):
        parts += [y[:, lo:s], g]
        lo = e
    parts.append(y[:, lo:])
    return np.concatenate(parts, axis=1) - shift


def bench_phase(requests, edits):
    """Phase 14: bench_torch.py, the twin of bench.py, called in-process
    at giga830M width with bench.py's geometry (BENCH_ARGS, --iters 1):
    every mode's JSON line, the fused FFN's launches on both routes,
    steps_per_iter 4 beside 1 (in the bench and outside it), each run's
    launch counts set to 0 just before it and read just after.  Returns
    the launch counts of each run.  The bench runs build the preset
    (16 layers); (D) runs on phase 6's model (PATH_DEPTH) made anew from
    its seed (phase 11 has sharded that one)."""
    import torch
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.inference.editing import inference_edit
    from voicecraft_tpu_torch.inference.loader import load_model
    from voicecraft_tpu_torch.inference.tts import inference_tts
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    _, model, _ = load_model("giga830M", random_init=True, seed=SEED,
                             device="cuda", overrides=PATH_DEPTH)
    cfg = PRESETS["giga830M"]()
    L, sr = cfg.num_decoder_layers, cfg.encodec_sr
    out = []
    log(f"[14 bench] bench_torch.main {' '.join(BENCH_ARGS)} (bench.py's "
        "geometry) and each mode's flags")

    def bench(label, flags, metrics, ffn=0, route=None, profile=None):
        r = BenchRun(label, BENCH_ARGS + flags, profile)
        if r.metrics() != metrics:
            raise AssertionError(f"({label}) metrics {r.metrics()}, want "
                                 f"{metrics}")
        for res in r.results:
            v = res.get("value", res.get("tokens_per_sec"))
            if not (np.isfinite(v) and v > 0):
                raise AssertionError(f"({label}) {res}")
        want = {"flash_prefix_attention": 0, "fused_ffn": ffn * L * r.forwards}
        check_launches(label, r.launches, want)
        if route is not None and r.routes.get(f"fused_ffn:{route}") != \
                r.launches["fused_ffn"]:
            raise AssertionError(f"({label}) FFN launches off {route}: "
                                 f"{r.routes}")
        out.append(r.launches)
        return r

    # (A) the default run: fp8 single stream, then 32 fp8-slab lanes
    a = bench("A", [], ["tts_rtf_830m", f"tts_serving_rtf_830m_b{BENCH_LANES}"])
    if a.match(r"generated (\d+) frames") != [BENCH_FRAMES]:
        raise AssertionError(f"(A) {a.err}")
    if a.results[1]["single_stream_rtf"] != a.results[0]["value"]:
        raise AssertionError(f"(A) {a.results}")

    # (B) the fused FFN on its two routes, 16 launches a forward; fp8 with
    # the fp8 slab (the default run's 32-lane line follows; serving runs no
    # FFN kernel)
    fused = {}
    for label, flags, metrics, route in (
            ("B fp8", ["--fused-ffn", "--kv-fp8"],
             ["tts_rtf_830m", f"tts_serving_rtf_830m_b{BENCH_LANES}"],
             "sm90/fp8"),
            ("B bf16", ["--bf16", "--fused-ffn"], ["tts_rtf_830m_bf16"],
             "sm90/bf16")):
        r = bench(label, flags + ["--frames", str(BENCH_FUSED_FRAMES)],
                  metrics, ffn=1, route=route)
        if r.forwards != 2 * BENCH_FUSED_FRAMES:
            raise AssertionError(f"({label}) {r.forwards} forwards, want "
                                 f"{2 * BENCH_FUSED_FRAMES} (warm-up + 1 run)")
        if r.results[-1].get("single_stream_rtf", r.results[0]["value"]) \
                != r.results[0]["value"]:
            raise AssertionError(f"({label}) {r.results}")
        fused[label] = r.results[0]["value"] * sr
        log(f"  ({label}) {r.launches['fused_ffn']} FFN launches = {L} x "
            f"{r.forwards} forwards, all on {route}")

    # (C) steps_per_iter 4 beside 1, bf16, unfused
    rates = {}
    for k in (1, BENCH_K):
        flags = ["--bf16", "--frames", str(BENCH_K_FRAMES)] + (
            ["--steps-per-iter", str(k)] if k > 1 else [])
        r = bench(f"C k={k}", flags, ["tts_rtf_830m_bf16"],
                  profile=PROFILE_STEPS)
        ops, ms = r.costs
        rates[k] = r.results[0]["value"] * sr
        if r.forwards != 2 * BENCH_K_FRAMES:
            raise AssertionError(f"(C k={k}) {r.forwards} forwards")
        log(f"  (C) steps_per_iter {k}: {rates[k]:.1f} forwards/s "
            f"(= frames/s: {BENCH_K_FRAMES} forwards a run), "
            f"{_fmt(ops)} device operations and {_fmt(ms, 4)} device ms a "
            f"step (torch.profiler over {PROFILE_STEPS} steps)")
    log(f"  (C) steps_per_iter {BENCH_K} / 1: {rates[BENCH_K] / rates[1]:.3f} "
        "x the forwards/s")

    # (D) outside the bench: inference_tts at request (b)'s greedy geometry,
    # and a three-span edit of (d), steps_per_iter k against 1
    b = requests[1]
    greedy = SamplingConfig(top_k=40, top_p=1.0, temperature=0.0)
    gens, draws = {}, {}
    for k in (1, BENCH_K):
        with DrawRecorder() as rec:
            st = {}
            t0 = time.time()
            _, gens[k] = inference_tts(model, b.x, b.codes, greedy, seed=SEED,
                                       gen_max=GEN_MAX, stats=st,
                                       steps_per_iter=k)
            torch.cuda.synchronize()
        draws[k] = rec.logits
        log(f"  (D) request (b) greedy, steps_per_iter {k}: "
            f"{gens[k].shape[1]} frames, {st['steps']} forwards in "
            f"{time.time() - t0:.3f} s")
    same_under_ties(f"(D) steps_per_iter {BENCH_K} vs 1",
                    delayed_rows(gens[BENCH_K]), delayed_rows(gens[1]),
                    draws[BENCH_K], draws[1])
    d = edits[0]
    res, sts = {}, {}
    with raised_eog_bias(model):
        for k in (1, BENCH_EDIT_K):
            sts[k] = {}
            if k == 1:
                res[k] = inference_edit(model, d.x, d.codes, d.intervals,
                                        greedy, seed=SEED,
                                        gen_max=EDIT_GEN_MAX, stats=sts[k])
            else:
                res[k] = spliced_edit(model, d.x, d.codes, d.intervals, greedy,
                                      EDIT_GEN_MAX, sts[k], k)
            st = sts[k]
            log(f"  (D) edit (d) greedy, eog bias raised by {EOG_BIAS}, "
                f"steps_per_iter {k}: {st['spans_done']} spans done, frames "
                f"{st['span_frames']}, {st['steps']} forwards ({st['feeds']} "
                "feeds)")
            if not (st["spans_done"] == len(d.intervals)
                    and min(st["span_frames"]) > 0
                    and kept_frames_verbatim(res[k], d.codes, d.intervals,
                                             st["span_frames"])):
                raise AssertionError(f"(D) edit at steps_per_iter {k}: {st}")
    if not np.array_equal(res[1], res[BENCH_EDIT_K]):
        raise AssertionError(f"(D) the edit at steps_per_iter {BENCH_EDIT_K} "
                             "differs from steps_per_iter 1")

    # (E) speculative, every draft accepted: tau tokens a pass
    r = bench("E", ["--spec", str(TAU), "--spec-accept"],
              [f"tts_spec_rtf_830m_tau{TAU}_ceiling"])
    tokens, passes = r.match(r"(\d+) tokens / (\d+) passes")
    if tokens != BENCH_FRAMES or tokens != TAU * passes:
        raise AssertionError(f"(E) {tokens} tokens in {passes} passes")

    # (F) batched editing, every lane to its budget
    r = bench("F", ["--edit-serve", str(BENCH_EDIT_LANES), "--frames",
                    str(BENCH_EDIT_FRAMES)],
              [f"edit_serving_rtf_830m_b{BENCH_EDIT_LANES}"])
    if r.match(r"for (\d+) frames across")[0] != \
            BENCH_EDIT_LANES * BENCH_EDIT_FRAMES:
        raise AssertionError(f"(F) {r.err}")

    # (G) the engine, and its steady variant at fewer frames a request
    bench("G", ["--engine", str(BENCH_ENGINE_LANES)],
          [f"tts_engine_rtf_830m_l{BENCH_ENGINE_LANES}"])
    bench("G steady", ["--engine", str(BENCH_ENGINE_LANES), "--steady",
                       "--frames", str(BENCH_STEADY_FRAMES)],
          [f"tts_engine_rtf_830m_l{BENCH_ENGINE_LANES}_steady"])

    # (H) streaming, pipeline on and off, at fewer phones (the length cap
    # of random weights: ~10 frames a phone)
    for flags, suffix in (([], ""), (["--stream-no-pipeline"], "_nopipe")):
        bench(f"H{suffix}", ["--stream", "--phones", str(BENCH_STREAM_PHONES)]
              + flags, [f"tts_stream_first_audio_ms_burst48{suffix}"])

    # (I) training: the step's rate, and the cost ladder with its GEMM probes
    bench("I", ["--train"], ["train_tokens_per_sec_giga830M"])
    r = bench("I profile", ["--train-profile"], ["train_profile_giga830M"])
    p = r.results[0]
    if not (0 < p["gemm_probe_tflops"] <= BF16_FLOP_PER_S / 1e12
            and p["gemm_probe_fp8_tflops"] is not None
            and p["gemm_probe_fp8_tflops"] > 0 and p["t_step_s"] > 0):
        raise AssertionError(f"(I) {p}")
    log(f"[14 bench] fused FFN forwards/s: fp8 {fused['B fp8']:.1f}, bf16 "
        f"{fused['B bf16']:.1f}")
    return out


def delayed_rows(gen):
    """The delayed-space rows [T + K - 1, K] of generated frames gen [K, T]
    (row t holds frame t - k of codebook k; -1 outside the frames)."""
    K, T = gen.shape
    rows = np.full((T + K - 1, K), -1, np.int64)
    for k in range(K):
        rows[k:k + T, k] = gen[k]
    return rows


def _fmt(v, digits=1):
    return "not measured" if v is None else f"{v:.{digits}f}"


# ---- phase 15 ----------------------------------------------------------------

# run as ``python -c`` in phase 15's subprocesses: the CLI script argv[1]
# (the installed console script, or the checkout's tts_torch_cli.py) with
# argv[2:], counting decode forwards (as chip_smoke.py's counting_forwards:
# transformer.decode_step_fast calls, less a CUDA graph capture's, plus the
# replays) and the wavs written; then one line "INSTALL {...}": the package
# and the kernel library it used, the launch counts and the forwards
INSTALL_DRIVER = r"""
import json, os, runpy, sys
import numpy as np
import voicecraft_tpu_torch
from voicecraft_tpu_torch.models import transformer as trm
from voicecraft_tpu_torch.ops import _native
from voicecraft_tpu_torch.ops.graphs import StepGraph
from voicecraft_tpu_torch.utils import audio as au
forwards, written = [0], {}
step, write_wav = trm.decode_step_fast, au.write_wav
capture, replay = StepGraph.__init__, StepGraph.replay

def counted_step(*a, **k):
    forwards[0] += 1
    return step(*a, **k)

def counted_capture(g, *a, **k):
    capture(g, *a, **k)
    forwards[0] -= 1

def counted_replay(g):
    forwards[0] += 1
    replay(g)

def recorded_write(path, wav, sr):
    written[str(path)] = [int(np.asarray(wav).shape[-1]),
                          bool(np.isfinite(wav).all())]
    write_wav(path, wav, sr)

trm.decode_step_fast, au.write_wav = counted_step, recorded_write
StepGraph.__init__, StepGraph.replay = counted_capture, counted_replay
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    if e.code not in (None, 0):
        raise
print("INSTALL " + json.dumps({
    "package": voicecraft_tpu_torch.__file__,
    "sys_path": [os.path.abspath(p) for p in sys.path],
    "csrc": str(_native.CSRC_DIR), "build_root": str(_native.BUILD_ROOT),
    "lib": _native._lib._name if _native._lib is not None else None,
    "launches": _native.LAUNCHES, "routes": dict(_native.ROUTE_LAUNCHES),
    "forwards": forwards[0], "written": written}))
"""


def copy_build_inputs(dst: Path) -> None:
    """What ``pip wheel`` needs of the checkout, without its build outputs
    (build/, __pycache__, *.so, *.egg-info)."""
    for name in ("pyproject.toml", "README.md",
                 *(p.name for p in REPO.glob("*.py"))):
        shutil.copy2(REPO / name, dst / name)
    skip = shutil.ignore_patterns("__pycache__", "build", "*.so",
                                  "*.egg-info")
    for pkg in ("voicecraft_tpu", "voicecraft_tpu_torch"):
        shutil.copytree(REPO / pkg, dst / pkg, ignore=skip)


def install_phase(long_wav, long_text, x_len):
    """Phase 15: the port as a user installs it.  The wheel is built from a
    copy of the checkout (pip wheel --no-deps --no-build-isolation, offline)
    and installed with --no-deps --target into a temporary directory; then
    the installed ``voicecraft-tts-torch`` (cwd outside the checkout,
    PYTHONPATH the target only) and the checkout's tts_torch_cli.py run
    side by side at giga830M width, 16 layers, random weights from SEED,
    greedy (--top-k 1), --fused-ffn, on demo.wav tiled to request (a)'s
    17.28 s prompt.  Checks: the installed run imported the target's
    package and built its kernel library from the target's csrc into the
    target's own build root (and wrote nothing else beside the package);
    both runs launched the attention kernel L times (one prefill, Sp >=
    1024) and the fused FFN L times a forward, all on sm90/bf16; every wav
    finite; the two runs' wavs equal byte for byte.  Returns its wall s."""
    import importlib.metadata as md
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.utils import audio as au
    t0 = time.time()
    L = PRESETS["giga830M"]().num_decoder_layers
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_install_"))
    procs = {}
    try:
        src, dist, target = tmp / "src", tmp / "dist", tmp / "target"
        src.mkdir()
        copy_build_inputs(src)

        def pip(*args):
            res = subprocess.run(
                [sys.executable, "-m", "pip", "--disable-pip-version-check",
                 "--no-input", "--no-cache-dir", *args, "--no-deps",
                 "--no-index"], cwd=tmp,
                capture_output=True, text=True, timeout=INSTALL_TIMEOUT_S)
            if res.returncode != 0:
                log(res.stdout[-3000:] + res.stderr[-3000:])
                raise AssertionError(f"(15) pip {args[0]} exited "
                                     f"{res.returncode}")

        pip("wheel", str(src), "--no-build-isolation", "-w", str(dist))
        (whl,) = dist.glob("*.whl")
        pip("install", "--target", str(target), str(whl))
        t_install = time.time() - t0
        script = target / "bin" / "voicecraft-tts-torch"
        if not script.is_file():
            raise AssertionError(f"(15) no console script {script}")
        prompt = tmp / "prompt.wav"
        au.write_wav(str(prompt), long_wav[0], 16000)
        args = ["--model", "giga830M", "--random-init", "--device", "cuda",
                "--fused-ffn", "--top-k", "1", "--seed", str(SEED),
                "--text-backend", "grapheme", "--prompt-wav", str(prompt),
                "--prompt-transcript", long_text, "--target-transcript",
                TARGET]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        runs = {"installed": (str(script), str(target)),
                "checkout": (str(REPO / "tts_torch_cli.py"), str(REPO))}
        t1 = time.time()
        for name, (cli, path) in runs.items():
            cwd = tmp / name
            cwd.mkdir()
            procs[name] = cwd, subprocess.Popen(
                [sys.executable, "-c", INSTALL_DRIVER, cli, *args, "--out",
                 str(cwd / "out.wav")], cwd=cwd, env=dict(env, PYTHONPATH=path),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        reports = {}
        for name, (cwd, proc) in procs.items():
            out, err = proc.communicate(timeout=INSTALL_RUN_TIMEOUT_S)
            if proc.returncode != 0:
                log(err[-6000:])
                raise AssertionError(f"(15) the {name} run exited "
                                     f"{proc.returncode}")
            (line,) = [ln for ln in out.splitlines()
                       if ln.startswith("INSTALL ")]
            reports[name] = rep = json.loads(line[len("INSTALL "):])
            fw = rep["forwards"]
            log(f"  {name}: {rep['package']}; kernel library {rep['lib']}; "
                f"launches {rep['launches']}, routes {rep['routes']}, "
                f"{fw} decode forwards; wavs {rep['written']}")
            want = {"flash_prefix_attention": L, "fused_ffn": L * fw,
                    "ring_decode_attention": 0, "kda_recurrent": 0}
            if (fw <= 0 or rep["launches"] != want
                    or rep["routes"] != {"fused_ffn:sm90/bf16": L * fw}):
                raise AssertionError(f"(15) {name}: launches {rep['launches']}"
                                     f" {rep['routes']}, want {want}, all "
                                     "fused_ffn:sm90/bf16")
            if (sorted(Path(p).name for p in rep["written"])
                    != ["out.wav", "out_gen_only.wav"]
                    or not all(f for _, f in rep["written"].values())):
                raise AssertionError(f"(15) {name}: wavs {rep['written']}")
        t_runs = time.time() - t1
        inst, pkg = reports["installed"], (target / "voicecraft_tpu_torch").resolve()
        lib = Path(inst["lib"]).resolve()
        checkout_lib = Path(reports["checkout"]["lib"]).resolve()
        if not (Path(inst["package"]).resolve().is_relative_to(pkg)
                and Path(inst["csrc"]).resolve() == pkg / "csrc"
                and Path(inst["build_root"]).resolve() == pkg / "build" / "kernels"
                and lib.parent.parent == pkg / "build" / "kernels"
                and lib.stat().st_mtime > whl.stat().st_mtime
                and lib.parent.name == checkout_lib.parent.name
                and checkout_lib.is_relative_to(REPO.resolve())
                and REPO.resolve() not in
                [Path(p).resolve() for p in inst["sys_path"]]):
            raise AssertionError(f"(15) the installed run used {inst}; target "
                                 f"{target}, the checkout's library "
                                 f"{checkout_lib}")
        beside = sorted(p.name for p in target.iterdir())
        if "build" in beside or not (pkg / "build").is_dir():
            raise AssertionError(f"(15) the target holds {beside}")
        for wav in ("out.wav", "out_gen_only.wav"):
            got = (tmp / "installed" / wav).read_bytes()
            want = (tmp / "checkout" / wav).read_bytes()
            if got != want:
                raise AssertionError(f"(15) {wav}: the installed run's "
                                     f"{len(got)} bytes differ from the "
                                     f"checkout's {len(want)}")
        n_out = {Path(p).name: n for p, (n, _) in inst["written"].items()}
        wall = time.time() - t0
        log(f"[15 install] {whl.name} built (pip {md.version('pip')}, "
            f"setuptools {md.version('setuptools')}) and installed into "
            f"{target} in {t_install:.1f} s; voicecraft-tts-torch from the target and "
            f"tts_torch_cli.py from the checkout, giga830M ({L} layers, "
            f"x_len {x_len}, --fused-ffn, --top-k 1, seed {SEED}), side by "
            f"side in {t_runs:.1f} s: the installed copy built {lib} from its "
            f"own csrc; {L} attention launches and {L} FFN launches a forward "
            f"each; the wavs {n_out} (samples) equal byte for byte; the phase in "
            f"{wall:.1f} s")
        return wall
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 10 ----------------------------------------------------------------

def scaling_check():
    """(v): each scaling Function's forward and backward on the card, in f32
    and bf16, against the CPU in f32 on the same bf16-valued inputs."""
    import math
    import torch
    from voicecraft_tpu_torch.models import scaling as S
    g = torch.Generator().manual_seed(SEED)
    B, T, C = SCALING_SHAPE
    # a dominant direction, so MaxEig's and Whiten's penalties are active
    d = torch.randn(C, generator=g)
    x0 = (1.5 * torch.randn(SCALING_SHAPE, generator=g) + 0.2
          + 4.0 * torch.randn(B, T, 1, generator=g) * d / d.norm())
    x0 = x0.bfloat16().float()
    g0 = torch.randn(SCALING_SHAPE, generator=g).bfloat16().float()
    le0 = torch.tensor(math.log(1e-5))
    d0 = S.max_eig_init(C)
    cases = {
        "softmax": lambda x, le: S.softmax(x),
        "double_swish": lambda x, le: S.double_swish(x),
        "activation_balancer": lambda x, le: S.activation_balancer(x),
        "balanced_double_swish": lambda x, le: S.balanced_double_swish(x),
        "basic_norm (eval)": lambda x, le: S.basic_norm(x, le),
        "basic_norm (train)": lambda x, le: S.basic_norm(x, le, train=True),
        "balanced_basic_norm (train)": lambda x, le: S.balanced_basic_norm(
            x, le, train=True),
        "penalize_abs_values_gt": lambda x, le: S.penalize_abs_values_gt(
            x, 3.0, 0.05),
        "with_loss": lambda x, le: S.with_loss(x, le * x.new_ones(4)),
        "whiten (8 groups)": lambda x, le: S.whiten(x, 8, 2.0, 0.02),
        "max_eig": lambda x, le: S.max_eig(x, d0.to(x.device))[0],
    }

    def run(fn, device, dtype):
        x = x0.to(device, dtype).clone().requires_grad_(True)
        le = le0.to(device).clone().requires_grad_(True)
        y = fn(x, le)
        y.backward(g0.to(device, dtype))
        return (y.detach().float().cpu(), x.grad.float().cpu(),
                None if le.grad is None else le.grad.item())

    t0 = time.time()
    worst = {}
    for name, fn in cases.items():
        ref = run(fn, "cpu", torch.float32)
        for dtype, rtol in ((torch.float32, SCALING_F32_RTOL),
                            (torch.bfloat16, SCALING_BF16_RTOL)):
            got = run(fn, "cuda", dtype)
            errs = [(a - b).abs().max().item() / b.abs().max().item()
                    for a, b in zip(got[:2], ref[:2])]
            if ref[2] is not None:
                errs.append(abs(got[2] - ref[2]) / abs(ref[2])
                            * rtol / SCALING_SCALAR_RTOL)
            key = str(dtype).split(".")[-1]
            worst[(name, key)] = max(errs)
            if not max(errs) <= rtol:
                raise AssertionError(f"(v) {name} {key}: errors {errs} (of "
                                     f"the reference's largest value) > {rtol}")
    torch.cuda.synchronize()
    log(f"  (v) {len(cases)} scaling functions on {list(SCALING_SHAPE)}, "
        f"forward and backward, card vs CPU f32 ({time.time() - t0:.1f} s): "
        + "; ".join(f"{n} {worst[(n, 'float32')]:.1e} / "
                    f"{worst[(n, 'bfloat16')]:.1e}" for n in cases)
        + f" (f32 / bf16 error over the largest |value|; tolerance "
        f"{SCALING_F32_RTOL:g} / {SCALING_BF16_RTOL:g}, log_eps gradient "
        f"{SCALING_SCALAR_RTOL:g})")


def toolbox_serving(base, codec, ccfg, requests, serve, out):
    """(w): giga830M with TOOLBOX in bf16 at PATH_DEPTH's layers, random
    weights from SEED, serving request (a)'s prompt greedy and 8 lanes, and
    against ``base`` (phase 6's layernorm + relu model) on the same
    request, unfused: forwards/s, and one decode step's device ms and
    operations; each run's launch
    counts set to 0 just before it and read just after, into ``out``."""
    import torch
    from voicecraft_tpu_torch.data.spans import compose_tts_prefix
    from voicecraft_tpu_torch.inference import serving as sv
    from voicecraft_tpu_torch.inference.loader import load_model
    from voicecraft_tpu_torch.inference.tts import (decode_geometry,
                                                    inference_tts, run_decode)
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    from voicecraft_tpu_torch.ops import _native
    greedy = SamplingConfig(top_k=40, top_p=1.0, temperature=0.0)
    t0 = time.time()
    cfg, model, _ = load_model("giga830M", random_init=True, seed=SEED,
                               device="cuda", overrides=dict(TOOLBOX,
                                                             **PATH_DEPTH))
    L = cfg.num_decoder_layers
    log(f"  (w) giga830M {model.dtype} at {L} layers, norm {cfg.norm}, "
        f"ffn_activation {cfg.ffn_activation}, built in "
        f"{time.time() - t0:.1f} s")

    def counted(label, fn, sp):
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

    a = requests[0]
    stats = {}
    (full, gen), wall = counted("w request (a)", lambda: inference_tts(
        model, a.x, a.codes, greedy, seed=SEED, gen_max=W_GEN_MAX,
        stats=stats), 1024)
    log(f"  (w) request (a)'s {a.wav.shape[1] / 16000:.2f} s prompt, Sp "
        f"{stats['prefill_len']}, greedy: {gen.shape[1]} frames, "
        f"{stats['steps']} forwards in {wall:.3f} s = "
        f"{stats['steps'] / wall:.1f} forwards/s "
        f"({gen.shape[1] / wall:.1f} frames/s)")
    if not (stats["prefill_len"] >= 1024
            and np.array_equal(full[:, :a.codes.shape[1]], a.codes)):
        raise AssertionError("(w): the prompt frames changed or the prefill "
                             "missed the kernel")
    check_wav("w", codec, ccfg, full)
    prefix = compose_tts_prefix(a.codes, cfg)
    base_stats = {}
    _, base_wall = counted("w layernorm + relu, unfused", lambda: inference_tts(
        base, a.x, a.codes, greedy, seed=SEED, gen_max=W_GEN_MAX,
        stats=base_stats), 1024)
    costs = [step_costs(m, a.x, prefix, fused_ffn=False) for m in (base, model)]
    log(f"  (w) the same request on phase 6's layernorm + relu model, "
        f"unfused: {base_stats['steps'] / base_wall:.1f} forwards/s against "
        f"{stats['steps'] / wall:.1f}; one decode step (graph replay / "
        f"torch.profiler): {costs[0][0]:.4f} device ms, {costs[0][1]} "
        f"operations against {costs[1][0]:.4f} ms, {costs[1][1]} operations")
    try:
        inference_tts(model, a.x, a.codes, greedy, gen_max=8, fused_ffn=True)
    except ValueError as e:
        log(f"  (w) fused_ffn=True refused: {e}")
    else:
        raise AssertionError("(w): fused_ffn=True ran a doubleswish model")
    steps = token_columns(model, 16)
    k_path = teacher_forced_logits(model, a.x, prefix, steps, plain=False,
                                   fused_ffn=False)
    p_path = teacher_forced_logits(model, a.x, prefix, steps, plain=True)
    errs = [(k - p).abs().max().item() for k, p in zip(k_path, p_path)]
    log(f"  (w) logits, kernel path vs plain path (max |logit| "
        f"{max(t.abs().max().item() for t in p_path):.3f}):")
    check("after prefill", errs[0], TOL_LOGITS)
    check("after 16 teacher-forced decode steps", max(errs[1:]), TOL_LOGITS)

    # 8 lanes through serve_tts_batch: the kernel at B=8
    reqs = [(r.x, r.codes) for r in serve]
    with DrawRecorder() as rec, serving_results("make_serving_tts_loop") as kept:
        outs, wall = counted("w 8 lanes", lambda: sv.serve_tts_batch(
            model, reqs, greedy, pads=W_PADS, seeds=SERVE_SEEDS),
            W_PADS[0] + W_PADS[1])
    (res,) = kept
    log(f"  (w) {len(reqs)} lanes, Sp {W_PADS[0] + W_PADS[1]}, greedy: "
        f"{res.steps} steps, rows {res.n_rows} in {wall:.3f} s = "
        f"{sum(res.n_rows) / wall:.1f} rows/s aggregate")
    for b, (full, _) in enumerate(outs):
        if not np.array_equal(full[:, :reqs[b][1].shape[1]], reqs[b][1]):
            raise AssertionError(f"(w) lane {b}: prompt not kept")
    for b in W_COMPARED:
        x, codes = reqs[b]
        prefix = compose_tts_prefix(codes, cfg)
        gx, gy, _ = decode_geometry(cfg, len(x), prefix.length,
                                    gen_max=W_PADS[2])
        with DrawRecorder() as rec1:
            (ref, _), _ = counted(f"w lane {b} single stream", lambda: run_decode(
                model, is_tts=True, x_tokens=x, prefix=prefix, n_spans=1,
                scfg=greedy, seed=SEED, gen_max=W_PADS[2], return_raw=True),
                gx + gy)
        same_under_ties(f"(w) lane {b} ({SERVE_SECONDS[b]} s) vs its own "
                        f"single-stream decode",
                        res.gen_buf[:res.n_rows[b], b].cpu().numpy(), ref,
                        rec.lane(b), rec1.by_index())


def toolbox_numerics(root, recipe):
    """(x): forward_train's loss and gradients at 2 layers with
    TOOLBOX_BALANCED, the card (bf16) against the CPU (f32), in the eval
    form (no seed) and the train form (a seed; dropout rates 0, so only the
    norms' form changes), within phase 9 (r)'s tolerances."""
    import dataclasses
    import torch
    from voicecraft_tpu_torch.config import TrainConfig
    from voicecraft_tpu_torch.data.manifest import ManifestDataset, collate_train
    from voicecraft_tpu_torch.models.voicecraft import VoiceCraft, forward_train
    cfg = dataclasses.replace(
        recipe, num_decoder_layers=NUMERICS_LAYERS, text_embedding_dropout=0.0,
        text_positional_embedding_dropout=0.0,
        audio_positional_embedding_dropout=0.0, trm_dropout=0.0,
        **TOOLBOX_BALANCED)
    ds = ManifestDataset(cfg, TrainConfig(dataset_dir=root), "train")
    idxs = [i for i, n in enumerate(ds.lengths)
            if n <= NUMERICS_FRAMES][:NUMERICS_UTTS]
    cpu = VoiceCraft(dataclasses.replace(cfg, compute_dtype="float32"), "cpu",
                     trainable=True).init_weights(
                         torch.Generator().manual_seed(SEED))
    card = VoiceCraft(cfg, "cuda", trainable=True)
    card.load_state_dict(cpu.state_dict())
    losses = {}
    for form, seed in (("eval", None), ("train", SEED)):
        res = []
        for model, dev in ((cpu, "cpu"), (card, "cuda")):
            model.zero_grad(set_to_none=True)
            batch = collate_train(ds, idxs, np.random.default_rng(SEED),
                                  device=dev)
            o = forward_train(model, batch, seed=seed, remat=True)
            o["loss"].backward()
            res.append((o["loss"].item(),
                        {n: p.grad for n, p in model.named_parameters()}))
        (want, want_g), (got, got_g) = res
        losses[form] = (want, got)
        rel = abs(got - want) / abs(want)
        err, worst, med = grad_errors(got_g, want_g)
        log(f"  (x) {cfg.norm} + {cfg.ffn_activation}, {NUMERICS_LAYERS} "
            f"layers, {form} form, card bf16 vs CPU f32: loss {got:.4f} vs "
            f"{want:.4f}, rel {rel:.2e} (tolerance {TRAIN_LOSS_RTOL:g}); "
            f"gradients' relative-norm error: worst {err:.2e} ({worst}; "
            f"tolerance {TRAIN_GRAD_RTOL:g}), median {med:.2e} (tolerance "
            f"{TRAIN_GRAD_MEDIAN:g})")
        if not (rel <= TRAIN_LOSS_RTOL and err <= TRAIN_GRAD_RTOL
                and med <= TRAIN_GRAD_MEDIAN):
            raise AssertionError(f"(x) {form}: loss rel {rel}, gradient error "
                                 f"{err} at {worst}, median {med}")
    gap = [abs(losses["train"][i] - losses["eval"][i]) / losses["eval"][i]
           for i in (0, 1)]
    log(f"  (x) train form vs eval form (log_eps = log(1e-5) < -3: the "
        f"expected ballast differs): loss rel gap {gap[0]:.2e} on the CPU, "
        f"{gap[1]:.2e} on the card")
    if not (gap[0] > 0 and gap[1] > 0):
        raise AssertionError(f"(x): the train and eval forms agree: {gap}")


def timed_train(tr, steps, label, profiled=(), opt_ops_step=None):
    """Trainer.train(max_steps=steps) with each step and each optimizer
    update synced and timed; every step's metrics must be finite with no
    NaN skip.  Returns a dict: per step "metrics", "wall" (s), "shape"
    (B, Sx, Sy) and "opt_ms"; "opt_ops", the device operations of update
    ``opt_ops_step``; "profile", (device busy ms, wall ms, device
    operations) over the steps ``profiled`` (torch.profiler); "base" and
    "peak", GB allocated before and during train(); "seconds" of train()."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rec = {"metrics": [], "wall": [], "shape": [], "opt_ms": [],
           "opt_ops": None, "profile": None}
    step_fn, opt_step = tr.step_fn, tr.optimizer.step

    def timed_opt_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        if len(rec["metrics"]) + 1 == opt_ops_step:
            _, rec["opt_ops"] = device_ops(opt_step)
        else:
            opt_step()
        torch.cuda.synchronize()
        rec["opt_ms"].append((time.perf_counter() - t) * 1e3)

    def timed_step(batch, seed):
        n = len(rec["metrics"]) + 1
        torch.cuda.synchronize()
        if profiled and n == profiled[0]:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            rec["profile"] = [prof, time.perf_counter()]
        t = time.perf_counter()
        m = step_fn(batch, seed)
        torch.cuda.synchronize()
        rec["wall"].append(time.perf_counter() - t)
        if profiled and n == profiled[-1]:
            prof, t_start = rec["profile"]
            prof.stop()
            wall = (time.perf_counter() - t_start) * 1e3
            ev = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
            rec["profile"] = (busy, wall, len(ev))
        rec["metrics"].append({k: (v.float().cpu().numpy()
                                   if isinstance(v, torch.Tensor) else v)
                               for k, v in m.items()})
        rec["shape"].append((batch.x.shape[0], batch.x.shape[1],
                             batch.y_tokens.shape[2]))
        return m

    tr.step_fn, tr.optimizer.step = timed_step, timed_opt_step
    torch.cuda.synchronize()
    rec["base"] = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tr.train(max_steps=steps)
    torch.cuda.synchronize()
    rec["seconds"] = time.time() - t0
    rec["peak"] = torch.cuda.max_memory_allocated() / 1e9
    tr.step_fn, tr.optimizer.step = step_fn, opt_step
    if len(rec["metrics"]) != steps:
        raise AssertionError(f"{label} ran {len(rec['metrics'])} steps, "
                             f"want {steps}")
    for i, m in enumerate(rec["metrics"]):
        if m["is_nan"] or not all(np.isfinite(np.asarray(v)).all()
                                  for v in m.values()):
            raise AssertionError(f"{label} step {i + 1}: metrics {m}")
    return rec


def check_log_eps_moved(model, label):
    """Every BasicNorm log_eps left its init log(1e-5)."""
    import math
    le = {n: p.item() for n, p in model.named_parameters() if "log_eps" in n}
    still = [n for n, v in le.items() if v == np.float32(math.log(1e-5))]
    log(f"  ({label}) {len(le)} log_eps parameters, all moved: "
        f"{min(le.values()):.6f} .. {max(le.values()):.6f} (init "
        f"{math.log(1e-5):.6f})")
    if still or len(le) != 2 * model.cfg.num_decoder_layers + 1:
        raise AssertionError(f"({label}): log_eps unmoved {still} of {len(le)}")


def cli_ties(model, codec, mode, item, tau):
    """A tooling CLI's item whose greedy output differed from its plain
    reference: both paths again, their recorded rows with the logits each
    was drawn from, under same_under_ties (a near-tie may differ)."""
    from voicecraft_tpu_torch.data.spans import (compose_edit_prefix,
                                                 compose_tts_prefix)
    from voicecraft_tpu_torch.inference import tts
    from voicecraft_tpu_torch.inference.streaming import stream_tts
    from voicecraft_tpu_torch.models.voicecraft import (SamplingConfig,
                                                        make_spec_decode_loop)
    greedy = SamplingConfig(top_k=0, top_p=1.0, temperature=0.0,
                            stop_repetition=3)
    cfg, x = model.cfg, item["x"]
    if mode in ("edit_spec",):
        prefix, qids = compose_edit_prefix(item["codes"], [item["span"]], cfg)
        paths = []
        for spec in (0, tau):
            with DrawRecorder() as rec:
                rows, _ = tts.run_decode(
                    model, is_tts=False, x_tokens=x, prefix=prefix,
                    queue_mask_ids=qids, n_spans=1, scfg=greedy, seed=1,
                    return_raw=True, spec=spec)
            paths.append((rows, rec.by_index()))
        (ref, ref_la), (got, got_la) = paths
    else:
        prefix = compose_tts_prefix(item["prompt"], cfg)
        with DrawRecorder() as rec:
            ref, _ = tts.run_decode(model, is_tts=True, x_tokens=x,
                                    prefix=prefix, n_spans=1, scfg=greedy,
                                    seed=1, return_raw=True)
        ref_la = rec.by_index()
        if mode == "spec":
            _, plen, x_pad, y_pad, gen_max, (xt, yt, mi) = tts._tts_prompt(
                model, x, item["prompt"], None)
            with DrawRecorder() as rec:
                loop = make_spec_decode_loop(cfg, x_pad=x_pad, y_pad=y_pad,
                                             gen_max=gen_max, scfg=greedy,
                                             n_draft=tau)
                res = loop(model, xt, len(x), yt, plen, mi, 1)
            got, got_la = res.gen_buf[:res.gen_cnt].cpu().numpy(), rec.by_index()
        else:
            with EngineRecorder() as rec:
                list(stream_tts(model, x, item["prompt"], greedy, seed=1,
                                codec=codec))
            got, got_la = rec.request(0)
    return same_under_ties(f"(z) {mode} vs its plain reference, {item['id']}",
                           got, ref, got_la, ref_la)


def tooling_clis(codec, ccfg, work, recipe):
    """(z): the procedural corpus, preprocess_torch_cli.py, the toolbox
    model with 3 MTP head groups trained on it, then quality_torch_cli.py
    and spec_acceptance_torch_cli.py on its checkpoint.  The two CLIs run in
    this process (their main() / run()), so their draws can be recorded
    again where a bit-exact field is false."""
    import contextlib as cl
    import dataclasses
    import gc
    import io as _io
    import torch
    import quality_torch_cli as qcli
    import spec_acceptance_torch_cli as scli
    from voicecraft_tpu_torch.config import TrainConfig
    from voicecraft_tpu_torch.inference.loader import load_model
    from voicecraft_tpu_torch.training.trainer import Trainer
    env = dict(os.environ, PYTHONPATH=str(REPO))
    corpus, data = os.path.join(work, "corpus"), os.path.join(work, "corpus_data")
    t0 = time.time()
    for cmd in ([str(REPO / "recipes" / "make_spec_corpus.py"), corpus,
                 *CORPUS_ARGS],
                [str(REPO / "preprocess_torch_cli.py"), "--audio-dir",
                 os.path.join(corpus, "train"), "--out-dir", data,
                 "--random-init", "--codec-bins", str(ccfg.codebook_size),
                 "--text-backend", "grapheme", "--device", "cuda"]):
        r = subprocess.run([sys.executable, *cmd], env=env, cwd=work,
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"(z) {Path(cmd[0]).name} exited "
                                 f"{r.returncode}: {r.stderr[-2000:]}")
    log(f"  (z) corpus (recipes/make_spec_corpus.py {' '.join(CORPUS_ARGS)}) "
        f"and preprocess_torch_cli.py (random {ccfg.codebook_size}-bin codec, "
        f"grapheme backend) in {time.time() - t0:.1f} s")

    zcfg = dataclasses.replace(recipe, n_mtp=N_MTP, **TOOLBOX, **PATH_DEPTH)
    t0 = time.time()
    tr = Trainer(zcfg, TrainConfig(
        dataset_dir=data, exp_dir=os.path.join(work, "z_exp"),
        max_num_tokens=TRAIN_TOKENS, lr=0.05, optimizer_name="ScaledAdam",
        seed=1, audio_min_length=0.5, text_min_length=2,
        val_every_n_steps=10 ** 6, print_every_n_steps=1), device="cuda")
    rec = timed_train(tr, Z_STEPS, "(z)")
    log(f"  (z) {zcfg.norm} + {zcfg.ffn_activation} giga830M at "
        f"{zcfg.num_decoder_layers} layers with {N_MTP} MTP "
        f"head groups trained {Z_STEPS} steps on the corpus (B, Sx, Sy "
        f"{rec['shape'][0]}), loss/token "
        + ", ".join(f"{float(m['loss']) / float(m['effective_ntoken']):.4f}"
                    for m in rec["metrics"])
        + f"; {time.time() - t0:.1f} s with the build and the save")
    ckpt = os.path.join(work, "z_exp", "ckpt_latest")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    common = ["--model", ckpt, "--eval-dir", os.path.join(corpus, "eval"),
              "--codec-bins", str(ccfg.codebook_size), "--prompt-sec",
              CLI_PROMPT_SEC, "--device", "cuda"]
    # quality_torch_cli.py: the run behind its main(), for the codes
    t0 = time.time()
    args = qcli.build_parser().parse_args(
        common + ["--n", CLI_N, "--modes", *QUALITY_MODES])
    with cl.redirect_stderr(_io.StringIO()):
        quality, codes = qcli.run(args)
    log(f"  (z) quality_torch_cli.py --n {CLI_N} --modes "
        f"{' '.join(QUALITY_MODES)} ({time.time() - t0:.1f} s): "
        + json.dumps(quality))
    if (set(quality["modes"]) != set(QUALITY_MODES)
            or quality["n"] != int(CLI_N)):
        raise AssertionError(f"(z) quality: modes {sorted(quality['modes'])}")
    false = [(m, f) for m, f in (("spec", "bit_exact_vs_plain"),
                                 ("stream", "bit_exact_vs_plain"),
                                 ("edit_spec", "bit_exact_vs_edit"))
             if quality["modes"][m][f] is not True]
    if false:
        _, model, phn2num = load_model(ckpt, device="cuda")
        from voicecraft_tpu_torch.data.phonemes import (make_text_tokenizer,
                                                        phones_to_ids)
        from voicecraft_tpu_torch.inference.editing import fractional_edit_span
        from voicecraft_tpu_torch.models import encodec as ec
        from voicecraft_tpu_torch.utils import audio as au
        tok = make_text_tokenizer("en-us", "grapheme")
        p_frames = int(float(CLI_PROMPT_SEC) * ccfg.frame_rate)
        for mode, field in false:
            base = "edit" if mode == "edit_spec" else "plain"
            for uid, got in codes[mode].items():
                if np.array_equal(got, codes[base][uid]):
                    continue
                path = os.path.join(corpus, "eval", uid)
                with open(path[:-4] + ".txt") as f:
                    x = np.asarray(phones_to_ids(tok.phonemize(
                        f.read().strip()), phn2num), np.int32)
                full = ec.encode_bucketed(codec, au.load_audio(
                    path, ccfg.sample_rate))[0].astype(np.int32)
                item = {"id": uid, "x": x, "prompt": full[:, :p_frames],
                        "codes": full, "span": fractional_edit_span(
                            full.shape[1], 0.4, 0.7)}
                cli_ties(model, codec, mode, item, quality["tau"])
        del model
        log(f"  (z) quality: {false} false, each item's first divergence a "
            f"near-tie")

    # spec_acceptance_torch_cli.py, TTS then --edit
    for extra in ([], ["--edit"]):
        t0 = time.time()
        argv = common + ["--taus", "2", "4", "--n", CLI_N, "--lanes", "2",
                         "--engine-requests", "1", "--engine-burst", "16",
                         *extra]
        with cl.redirect_stdout(_io.StringIO()), \
                cl.redirect_stderr(_io.StringIO()):
            acc = scli.main(argv)
        log(f"  (z) spec_acceptance_torch_cli.py --taus 2 4 --n {CLI_N} "
            f"--lanes 2 --engine-requests 1 --engine-burst 16 "
            f"{' '.join(extra)} "
            f"({time.time() - t0:.1f} s): {json.dumps(acc, default=float)}")
        if extra:
            if not all(2 in acc["edit"][k] and 4 in acc["edit"][k]
                       for k in ("edit_single", "edit_serving")):
                raise AssertionError(f"(z) spec acceptance --edit: {acc}")
        elif not all(tau in acc[k] for k in ("single", "serving", "engine")
                     for tau in (2, 4)):
            raise AssertionError(f"(z) spec acceptance: {acc}")
    gc.collect()
    torch.cuda.empty_cache()


def toolbox_phase(base, codec, ccfg, requests, serve, work):
    """Phase 10: the icefall toolbox (models/scaling.py) on every path:
    (v) the scaling Functions card vs CPU; (w) a toolbox giga830M serving,
    beside ``base``, phase 6's model;
    (x) toolbox training; (y) phase 9's checkpoint through
    export_torch_cli.py; (z) the tooling CLIs.  Returns the launch counts of
    each counted run (each set to 0 just before it and read just after)."""
    import dataclasses
    import gc
    import torch
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.config import TrainConfig
    from voicecraft_tpu_torch.data.spans import compose_tts_prefix
    from voicecraft_tpu_torch.inference.loader import load_model
    from voicecraft_tpu_torch.ops import _native
    from voicecraft_tpu_torch.training.trainer import Trainer
    import export_torch_cli
    out = []
    recipe = dataclasses.replace(PRESETS["giga830M"](), **RECIPE)
    root = os.path.join(work, "data")

    t0 = time.time()
    scaling_check()
    log(f"  (v) done in {time.time() - t0:.1f} s")

    t0 = time.time()
    toolbox_serving(base, codec, ccfg, requests, serve, out)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (w) done in {time.time() - t0:.1f} s")

    # ---- (x) toolbox training ----
    t0 = time.time()
    toolbox_numerics(root, recipe)
    gc.collect()
    torch.cuda.empty_cache()
    xcfg = dataclasses.replace(recipe, **TOOLBOX, **PATH_DEPTH)
    tr = Trainer(xcfg, TrainConfig(
        dataset_dir=root, exp_dir=os.path.join(work, "x_exp"),
        max_num_tokens=TRAIN_TOKENS, lr=0.05, optimizer_name="ScaledAdam",
        seed=1, val_every_n_steps=10 ** 6, print_every_n_steps=1),
        device="cuda")
    rec = timed_train(tr, X_STEPS, "(x)")
    walls = rec["wall"]
    log(f"  (x) {xcfg.norm} + {xcfg.ffn_activation} giga830M at "
        f"{xcfg.num_decoder_layers} layers, Trainer.train "
        f"{X_STEPS} steps of the e830M recipe at max_num_tokens "
        f"{TRAIN_TOKENS}: batches (B, Sx, Sy) {rec['shape']}, loss/token "
        + ", ".join(f"{float(m['loss']) / float(m['effective_ntoken']):.4f}"
                    for m in rec["metrics"])
        + f"; s a step {', '.join(f'{w:.3f}' for w in walls)} (steps 2-"
        f"{X_STEPS}: {np.mean(walls[1:]):.3f}); peak allocated "
        f"{rec['peak']:.2f} GB")
    check_log_eps_moved(tr.model, "x")
    del tr
    shutil.rmtree(os.path.join(work, "x_exp"), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (x) done in {time.time() - t0:.1f} s")

    # ---- (y) export of phase 9's checkpoint ----
    t0 = time.time()
    ckpt9 = os.path.join(work, "exp", "ckpt_latest")
    pth = os.path.join(work, "export.pth")
    export_torch_cli.main(["--ckpt", ckpt9, "--out", pth, "--format", "pth"])
    t_export = time.time() - t0
    _, m9, v9 = load_model(ckpt9, device="cuda")
    _, mx, vx = load_model(pth, device="cuda")
    s9, sx = m9.state_dict(), mx.state_dict()
    diff = [k for k in sx if not torch.equal(s9[k], sx[k])]
    if set(sx) != set(s9) or diff or vx != v9:
        raise AssertionError(f"(y): the reloaded export differs: {diff[:5]}, "
                             f"keys {set(s9) ^ set(sx)}")
    a = requests[0]
    prefix = compose_tts_prefix(a.codes, m9.cfg)
    logits = []
    for m in (m9, mx):
        _native.reset_launch_counts()
        logits.append(teacher_forced_logits(m, a.x, prefix, [], plain=False,
                                            fused_ffn=False)[0])
        launches = dict(_native.LAUNCHES)
        check_launches("y prefill", launches, {
            "flash_prefix_attention": m.cfg.num_decoder_layers,
            "fused_ffn": 0})
        out.append(launches)
    if not torch.equal(*logits):
        raise AssertionError("(y): the export's prefill logits differ")
    log(f"  (y) phase 9's ckpt_latest exported (export_torch_cli.py --format "
        f"pth, {os.path.getsize(pth) / 1e9:.2f} GB in {t_export:.1f} s), "
        f"reloaded through load_model: {len(sx)} tensors and one prefill's "
        f"logits (S {a.x.shape[0]}+{prefix.length}, the attention kernel) "
        f"equal bit for bit")
    del m9, mx, s9, sx
    os.remove(pth)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.time()
    tooling_clis(codec, ccfg, work, recipe)
    log(f"  (z) done in {time.time() - t0:.1f} s")
    return out


# ---- phase 12 (--cards 4) --------------------------------------------------------

def mesh_serving(rank, model, mesh, reqs, ref, label, spec=0):
    """(j)'s greedy wave over ``mesh`` (plain, or speculative at tau
    ``spec``) through serving's own loop on this rank's lanes, its draws
    recorded; this rank's lanes against the one-card wave ``ref`` (rows and
    draws of every lane) under the tie-aware rule.  Returns this rank's
    numbers (launches, wall s, rows, frames/s, peak GB)."""
    import torch
    from voicecraft_tpu_torch.inference import serving as sv
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    from voicecraft_tpu_torch.ops import _native
    from voicecraft_tpu_torch.parallel.mesh import data_slice
    cfg = model.cfg
    greedy = SamplingConfig(top_k=40, top_p=1.0, temperature=0.0)
    pads, args = sv.tts_wave_inputs(model, reqs, SERVE_PADS)
    x_pad, y_pad, gen_max = pads
    sl = data_slice(len(reqs), mesh)
    Bl = sl.stop - sl.start
    if spec:
        loop = sv.make_spec_serving_loop(cfg, batch_size=Bl, n_draft=spec,
                                         x_pad=x_pad, y_pad=y_pad,
                                         gen_max=gen_max, scfg=greedy)
    else:
        loop = sv.make_serving_tts_loop(cfg, batch_size=Bl, x_pad=x_pad,
                                        y_pad=y_pad, gen_max=gen_max,
                                        scfg=greedy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launch_counts()
    with DrawRecorder() as rec:
        t0 = time.time()
        res = sv._wave_on_mesh(loop, model, args + (SERVE_SEEDS,), mesh)
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = dict(_native.LAUNCHES)
    want = cfg.num_decoder_layers if x_pad + y_pad >= 1024 else 0
    if launches != {"flash_prefix_attention": want, "fused_ffn": 0}:
        raise AssertionError(f"({label}) rank {rank}: launches {launches}, "
                             f"want {want} attention launches")
    ref_rows, ref_la = ref
    for i in range(Bl):
        b = sl.start + i
        rows = res.gen_buf[:res.n_rows[b], b].cpu().numpy()
        same_under_ties(f"({label}) rank {rank} lane {b} vs the one-card "
                        f"wave", rows, ref_rows[b], rec.lane(i), ref_la[b])
    return dict(launches=launches["flash_prefix_attention"], wall=wall,
                rows=int(sum(res.n_rows)), steps=res.steps,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def report(rank, label, mine, note=""):
    """Gather every rank's numbers of one run and log them on rank 0."""
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank == 0:
        wall = max(m["wall"] for m in every)
        extra = (f"; {every[0]['rows']} rows in {wall:.3f} s = "
                 f"{every[0]['rows'] / wall:.1f} frames/s aggregate"
                 if "rows" in every[0] else "")
        log(f"  ({label}) per rank: attention launches "
            f"{[m.get('launches') for m in every]}, peak memory "
            f"{[round(m['peak_gb'], 2) for m in every]} GB{extra}{note}")
    return every


def mesh_tcfg(root, exp, zero1):
    from voicecraft_tpu_torch.config import TrainConfig
    return TrainConfig(dataset_dir=root, exp_dir=os.path.join(root, "..", exp),
                       max_num_tokens=TRAIN_TOKENS, lr=0.05,
                       optimizer_name="ScaledAdam", seed=1, zero1=zero1,
                       val_every_n_steps=10 ** 6, print_every_n_steps=1)


def train_run(rank, mesh, recipe, tcfg, save, moments):
    """MESH_TRAIN_STEPS Trainer(mesh=) steps on phase 9's manifest, each step
    timed, the NCCL kernels' device time of step MESH_PROFILED_STEP from
    torch.profiler, each step's batch kept (host copies).  Returns (numbers,
    the gathered parameters on the host, the batches, rank 0's gathered
    parameters before the first step, and with ``moments`` rank 0's
    gathered ScaledAdam moments on the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from voicecraft_tpu_torch.parallel.mesh import gather_params
    from voicecraft_tpu_torch.training.trainer import Trainer
    exp = os.path.basename(tcfg.exp_dir)
    t0 = time.time()
    tr = Trainer(recipe, tcfg, mesh=mesh, device="cuda")
    t_build = time.time() - t0
    if not save:
        tr.validate_and_save = lambda: None
    step_fn, walls, losses, ntoks, batches, nccl = tr.step_fn, [], [], [], [], []

    def timed(batch, seed):
        torch.cuda.synchronize()
        prof = None
        if len(walls) + 1 == MESH_PROFILED_STEP:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        t = time.perf_counter()
        m = step_fn(batch, seed)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if prof is not None:
            prof.stop()
            nccl.append(sum(e.self_device_time_total
                            for e in prof.key_averages()
                            if "nccl" in e.key.lower()) / 1e3)
        losses.append(float(m["loss"]))
        ntoks.append(float(m["effective_ntoken"]))
        batches.append(tuple(t.cpu() for t in batch))
        if m["is_nan"]:
            raise AssertionError(f"({exp}) step {len(walls)}: non-finite")
        return m

    tr.step_fn = timed
    start = gather_params(tr.model)          # collective: every rank
    start = ({k: v.float().cpu().clone() for k, v in start.items()}
             if rank == 0 else None)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    tr.train(max_steps=MESH_TRAIN_STEPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    params = {k: v.float().cpu().clone()
              for k, v in gather_params(tr.model).items()}
    state = None
    if moments:
        sd = tr.optimizer.state_dict()       # collective: every rank
        state = ([t.cpu() for leaf in sd["leaves"]
                  for key in ("delta", "exp_avg_sq") for t in leaf[key]]
                 if rank == 0 else None)
        del sd
    del tr
    torch.cuda.empty_cache()
    local_tokens = sum(int(b[5].sum()) for b in batches)
    return (dict(wall=sum(walls[1:]), steps=walls, losses=losses, ntok=ntoks,
                 nccl_ms=nccl[0] if nccl else None, base_gb=base,
                 peak_gb=peak, build_s=t_build, tokens=local_tokens),
            params, batches, start, state)


def one_card_losses(recipe, tcfg, every_batches, device):
    """The loss of each step on one card: the Trainer's model and
    ScaledAdam (as Trainer builds them from ``tcfg``), each step's gradient
    the sum over the data rows' batches of that step (what the mesh sums),
    no dropout (the phase's recipe has none)."""
    import torch
    from voicecraft_tpu_torch.models.voicecraft import (TrainBatch,
                                                        VoiceCraft,
                                                        forward_train)
    from voicecraft_tpu_torch.training.optim import (ScaledAdam,
                                                     eden_schedule,
                                                     stacked_leaves)
    model = VoiceCraft(recipe, device, trainable=True).init_weights(
        torch.Generator(device=device).manual_seed(tcfg.seed))
    total = tcfg.num_steps or 50000
    opt = ScaledAdam(stacked_leaves(model), lr=eden_schedule(
        tcfg.lr, tcfg.reduce_lr_start_step, tcfg.reduce_lr_start_epoch,
        total * tcfg.warmup_fraction, tcfg.pseudo_epoch_size),
        betas=(0.9, 0.95), clipping_scale=2.0,
        clipping_update_period=tcfg.clipping_update_period)
    out = []
    for step in range(len(every_batches[0])):
        opt.zero_grad()
        loss = 0.0
        for rank_batches in every_batches:
            batch = TrainBatch(*(t.to(device) for t in rank_batches[step]))
            res = forward_train(model, batch, seed=None)
            res["loss"].backward()
            loss += float(res["loss"])
        opt.step()
        out.append(loss)
    del model, opt
    torch.cuda.empty_cache()
    return out


def cards_worker(rank, world, port, inputs, root, failed):
    """One rank of phase 12: NCCL over 127.0.0.1 with a collective timeout,
    this rank's card; any failure is reported in ``failed`` and re-raised
    (the process exits non-zero)."""
    import datetime
    import torch
    import torch.distributed as dist
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    sys.path.insert(0, str(REPO))
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        cards_phase(rank, inputs, root)
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        failed.set()
        raise
    finally:
        dist.destroy_process_group()


def cards_phase(rank, inputs, root):
    """Phase 12 on one rank of four (see the module docstring)."""
    import dataclasses
    import gc
    import torch
    import torch.distributed as dist
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.data.spans import compose_tts_prefix
    from voicecraft_tpu_torch.inference import engine as em
    from voicecraft_tpu_torch.inference import serving as sv
    from voicecraft_tpu_torch.inference.engine import ContinuousBatcher
    from voicecraft_tpu_torch.inference.loader import load_model
    from voicecraft_tpu_torch.inference.streaming import stream_tts
    from voicecraft_tpu_torch.inference.tts import decode_geometry, run_decode
    from voicecraft_tpu_torch.models.voicecraft import (SamplingConfig,
                                                        init_mtp_heads)
    from voicecraft_tpu_torch.ops import _native
    from voicecraft_tpu_torch.parallel.mesh import (gather_objects, make_mesh,
                                                    shard_params)
    dev = torch.device("cuda", rank)
    _native.lib()
    greedy = SamplingConfig(top_k=40, top_p=1.0, temperature=0.0)
    reqs, texts2 = inputs["reqs"], inputs["texts2"]

    def build():
        cfg, model, _ = load_model("giga830M", random_init=True, seed=SEED,
                                   device=dev)
        model.mtp_heads = init_mtp_heads(
            dataclasses.replace(cfg, n_mtp=N_MTP),
            torch.Generator(device=dev).manual_seed(SEED + 4), dev)
        return model

    # ---- (A) lockstep serving: the one-card wave, then 4 x 1 and 2 x 2 ----
    model = build()
    cfg = model.cfg
    L = cfg.num_decoder_layers
    pads, args = sv.tts_wave_inputs(model, reqs, SERVE_PADS)
    loop = sv.make_serving_tts_loop(cfg, batch_size=len(reqs),
                                    x_pad=pads[0], y_pad=pads[1],
                                    gen_max=pads[2], scfg=greedy)
    with DrawRecorder() as rec:
        t0 = time.time()
        res = loop(model, *args, SERVE_SEEDS)
        torch.cuda.synchronize()
        one_wall = time.time() - t0
    ref = ([res.gen_buf[:n, b].cpu().numpy() for b, n in enumerate(res.n_rows)],
           [rec.lane(b) for b in range(len(reqs))])
    del rec
    if rank == 0:
        log(f"[12 cards] (A) the one-card wave of (j)'s {len(reqs)} lanes, "
            f"greedy, on each card: {sum(res.n_rows)} rows in {one_wall:.3f} "
            f"s = {sum(res.n_rows) / one_wall:.1f} frames/s")
    m41 = make_mesh(4, 1, dev)
    shard_params(model, m41)
    for label, spec in (("A 4x1 plain", 0), ("A 4x1 speculative", TAU)):
        report(rank, label, mesh_serving(rank, model, m41, reqs, ref, label,
                                         spec))

    # ---- (B) the engine and a stream at 4 x 1 ----
    reqs16 = reqs + [(x2, y) for (_, y), x2 in zip(reqs, texts2)]
    eng = ContinuousBatcher(model, lanes=len(reqs), x_pad=SERVE_PADS[0],
                            y_pad=SERVE_PADS[1], gen_max=GEN_MAX,
                            burst=ENGINE_BURST, scfg=greedy, seed=SEED,
                            mesh=m41)
    ids = [eng.submit(x, y) for x, y in reqs16]
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launch_counts()
    with EngineRecorder() as erec:
        t0 = time.time()
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = _native.LAUNCHES["flash_prefix_attention"]
    prefills = eng.stats["waves"] + eng.stats["refills"]
    if launches % L or not launches or _native.LAUNCHES["fused_ffn"]:
        raise AssertionError(f"(B) rank {rank}: launches {_native.LAUNCHES}")
    mine = sorted({rid for _, _, lane_map in erec.bursts for rid in lane_map
                   if rid is not None})
    frames = sum(out[i][1].shape[1] for i in ids)
    for rid in mine:
        rows, la = erec.request(rid)
        x, codes = reqs16[rid]
        prefix = compose_tts_prefix(codes, cfg)
        gx, gy, _ = decode_geometry(cfg, len(x), prefix.length,
                                    gen_max=GEN_MAX)
        with DrawRecorder() as rec1:
            ref1, _ = run_decode(model, is_tts=True, x_tokens=x, prefix=prefix,
                                 n_spans=1, scfg=greedy, seed=SEED,
                                 gen_max=GEN_MAX, return_raw=True)
        r_la = rec1.by_index()
        if len(rows) == GEN_MAX - 1 and len(ref1) == GEN_MAX:
            ref1, r_la = ref1[:-1], r_la[:-1]
        same_under_ties(f"(B) rank {rank} request {rid} vs its single "
                        f"stream", rows, ref1, la, r_la)
    report(rank, "B engine 4x1", dict(
        launches=launches, wall=wall, rows=frames,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9),
        note=f"; {len(reqs16)} requests over {len(reqs)} lanes, "
             f"{eng.stats}, {L} attention launches a prefill on the ranks "
             f"whose lanes it fills ({prefills} prefills)")
    del erec, eng
    x, codes = reqs[-1]
    chunks = list(stream_tts(model, x, codes, greedy, seed=SEED,
                             gen_max=GEN_MAX, mesh=m41, lanes=4))
    got = np.concatenate([c["frames"] for c in chunks], axis=1)
    gens = gather_objects(chunks[-1]["gen"], m41)
    if not (np.array_equal(got, chunks[-1]["gen"]) and got.shape[1] > 0
            and all(np.array_equal(g, gens[0]) for g in gens)):
        raise AssertionError(f"(B) rank {rank}: the stream's frames")
    if rank == 0:
        log(f"  (B) stream_tts at 4 x 1 with lanes 4: {len(chunks)} chunks, "
            f"{got.shape[1]} frames, the same on every rank")
    every = gather_objects(closed_stream(rank, model, m41, x, codes, 4), m41)
    if rank == 0:
        check_closed("B closed stream 4x1", every)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    m22 = make_mesh(2, 2, dev)
    model = shard_params(build(), m22)
    # the flag of rank 0's consumer reaches its model peer too
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, closed_stream(rank, model, m22, x, codes, 2))
    if rank == 0:
        check_closed("B closed stream 2x2", every)
    for label, spec in (("A 2x2 plain", 0), ("A 2x2 speculative", TAU)):
        report(rank, label, mesh_serving(rank, model, m22, reqs, ref, label,
                                         spec))
    del model, ref
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (D) training, and (E) a 2 x 2 checkpoint on one card ----
    recipe = dataclasses.replace(PRESETS["giga830M"](), **RECIPE,
                                 **MESH_NO_DROPOUT)
    runs, losses, moments = {}, {}, {}
    for label, mesh, zero1, save in (("4x1 ZeRO-1", m41, True, False),
                                     ("4x1 replicated", m41, False, False),
                                     ("4x1 replicated again", m41, False,
                                      False),
                                     ("2x2 ZeRO-1", m22, True, True)):
        tcfg = mesh_tcfg(root, "exp_" + label.replace(" ", "_"), zero1)
        nums, params, batches, start, moments[label] = train_run(
            rank, mesh, recipe, tcfg, save, moments=mesh is m41)
        if label == "4x1 ZeRO-1":
            runs["start"] = start
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (nums, batches))
        runs[label], losses[label] = params, nums["losses"]
        one = None
        if rank == 0 and "replicated" not in label:
            rows = [b for r, (_, b) in enumerate(every)
                    if r % mesh.n_model == 0]
            one = one_card_losses(recipe, tcfg, rows, dev)
        dist.barrier()
        if rank == 0:
            tok = sum(n["tokens"] for n, _ in every[::mesh.n_model])
            steps = len(nums["steps"])
            wall = max(n["wall"] for n, _ in every)
            log(f"  (D) {label}: {steps} steps, loss/token "
                f"{[round(l / t, 5) for l, t in zip(nums['losses'], nums['ntok'])]}"
                f", one card on the same global batches "
                f"{'not run' if one is None else [round(l / t, 5) for l, t in zip(one, nums['ntok'])]}"
                f"; s a step {[round(s, 3) for s in nums['steps']]}; "
                f"{tok} targets over the cards in {steps} steps, "
                f"{tok * (steps - 1) / steps / wall:.0f} target tokens/s "
                f"summed over the cards (steps 2-{steps}); peak memory "
                f"{[round(n['peak_gb'], 2) for n, _ in every]} GB, model + "
                f"optimizer {[round(n['base_gb'], 2) for n, _ in every]} GB "
                f"before the first step; NCCL kernels "
                f"{[None if n['nccl_ms'] is None else round(n['nccl_ms'], 2) for n, _ in every]}"
                f" ms in step {MESH_PROFILED_STEP} (torch.profiler)")
            if one is not None:
                err = max(abs(a - b) / abs(b) for a, b in zip(nums["losses"], one))
                if not err <= TRAIN_LOSS_RTOL:
                    raise AssertionError(f"(D) {label}: losses {nums['losses']}"
                                         f" against one card's {one}")
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        z, r, r2, p0 = (runs["4x1 ZeRO-1"], runs["4x1 replicated"],
                        runs["4x1 replicated again"], runs["start"])
        dist2 = lambda a, b: sum(float((a[k] - b[k]).double().square().sum())
                                 for k in a) ** 0.5
        same = lambda a, b: (a.keys() == b.keys()
                             and all(torch.equal(a[k], b[k]) for k in a))
        same_list = lambda a, b: (len(a) == len(b) and all(
            torch.equal(x, y) for x, y in zip(a, b)))
        mz, mr, mr2 = (moments["4x1 ZeRO-1"], moments["4x1 replicated"],
                       moments["4x1 replicated again"])
        bits = dict(
            losses=losses["4x1 ZeRO-1"] == losses["4x1 replicated"],
            parameters=same(z, r), moments=same_list(mz, mr))
        again = dict(losses=losses["4x1 replicated again"]
                     == losses["4x1 replicated"], parameters=same(r2, r),
                     moments=same_list(mr2, mr))
        log(f"  (D) 4 x 1 after {MESH_TRAIN_STEPS} steps, ZeRO-1 against "
            f"replicated moments, bit for bit: {bits} (the parameters "
            f"{dist2(z, r):.4e} apart, L2, of the {dist2(r, p0):.4e} the "
            f"steps moved them; {sum(t.numel() for t in mz)} moment "
            f"elements); a second replicated run: {again}")
        if not all(bits.values()):
            raise AssertionError(f"(D) ZeRO-1 and replicated differ: {bits}")
        del mz, mr, mr2, moments
        ckpt = os.path.join(root, "..", "exp_2x2_ZeRO-1", "ckpt_latest")
        state = torch.load(os.path.join(ckpt, "model.pt"), map_location="cpu",
                           weights_only=True)
        same = all(torch.equal(state[k].float(), v)
                   for k, v in runs["2x2 ZeRO-1"].items())
        _, one_model, _ = load_model(ckpt, device=dev)
        _native.reset_launch_counts()
        x, codes = reqs[-1]
        prefix = compose_tts_prefix(codes, cfg)
        rows, _ = run_decode(one_model, is_tts=True, x_tokens=x,
                             prefix=prefix, n_spans=1, scfg=greedy,
                             seed=SEED, gen_max=U_GEN_MAX, return_raw=True)
        log(f"  (E) the 2 x 2 run's ckpt_latest on one card: the gathered "
            f"parameters bit for bit {same}; load_model serves (j)'s lane "
            f"{len(reqs) - 1} greedy, {len(rows)} rows, attention launches "
            f"{_native.LAUNCHES['flash_prefix_attention']}")
        if not same or _native.LAUNCHES["flash_prefix_attention"] != L:
            raise AssertionError("(E) the 2 x 2 checkpoint on one card")
    dist.barrier()


def server_phase(port):
    """(C) serve_torch_cli.py --mesh 2x2 under torchrun on the four cards:
    two concurrent /tts in one wave and an /edit; every process is stopped
    after."""
    import json as js
    import signal
    import threading
    import urllib.request
    logf = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_")) / "serve.log"
    http = free_port()
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", "4", "--master-addr", "127.0.0.1",
           "--master-port", str(port), str(REPO / "serve_torch_cli.py"),
           "--mesh", "2x2", "--model", "giga830M", "--random-init",
           "--seed", str(SEED), "--text-backend", "grapheme",
           "--batch-window-ms", "2000", "--port", str(http)]
    t0 = time.time()
    with open(logf, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=REPO, start_new_session=True)
    base = f"http://127.0.0.1:{http}"
    demo_b64 = base64.b64encode((REPO / "demo" / "demo.wav").read_bytes()
                                ).decode()

    def post(path, payload):
        req = urllib.request.Request(base + path,
                                     data=js.dumps(payload).encode(),
                                     method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            return js.loads(r.read()), time.perf_counter() - t

    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"(C) the server exited: "
                                     f"{logf.read_text()[-4000:]}")
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                    info = js.loads(r.read())
                break
            except OSError:
                if time.time() - t0 > SERVER_START_S:
                    raise AssertionError("(C) no /healthz in time")
                time.sleep(2)
        log(f"  (C) serve_torch_cli.py --mesh 2x2 under torchrun up in "
            f"{time.time() - t0:.1f} s: {info}")
        results = [None, None]
        gate = threading.Barrier(2)

        def tts(i, text):
            payload = {"prompt_wav_b64": demo_b64, "prompt_end_sec": 2.0,
                       "prompt_transcript": "the sound of birds",
                       "target_transcript": text, "seed": SEED}
            gate.wait()
            results[i] = post("/tts", payload)

        ths = [threading.Thread(target=tts, args=(i, t))
               for i, t in enumerate(["the river runs", "the old mill"])]
        [t.start() for t in ths]
        [t.join() for t in ths]
        for i, r in enumerate(results):
            if r is None or not r[0]["gen_sec"] > 0:
                raise AssertionError(f"(C) /tts {i}: {r}")
            log(f"  (C) /tts {i} (concurrent): HTTP 200 in {r[1]:.3f} s, "
                f"{r[0]['gen_sec']:.2f} s generated")
        with open(REPO / "demo" / "demo_alignment.csv") as f:
            rows = [{k: (float(v) if k in ("Begin", "End") else v)
                     for k, v in r.items()} for r in csv.DictReader(f)]
        ed, lat = post("/edit", {
            "wav_b64": demo_b64, "orig_transcript": PROMPT,
            "target_transcript": EDIT_TARGET, "edit_type": "substitution",
            "alignment": rows, "seed": SEED})
        s, e = ed["edit_interval_frames"]
        log(f"  (C) /edit: HTTP 200 in {lat:.3f} s, frames [{s}, {e}) "
            f"regenerated")
        waves = [ln for ln in logf.read_text().splitlines()
                 if "micro-batch wave" in ln]
        log(f"  (C) micro-batch waves: {waves}")
        if not any("2 slot(s) [tts,tts]" in w for w in waves):
            raise AssertionError("(C) the two /tts did not share a wave")
    finally:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def cards_main(n_cards: int) -> None:
    """``--cards 4``: the build, the inputs and phase 12 alone, over four
    cards; the last line as the one-card run's, with the card count."""
    import multiprocessing as mp
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs CUDA cards")
    if n_cards != 4 or torch.cuda.device_count() < 4:
        raise SystemExit(f"chip_smoke --cards {n_cards}: the mesh mode runs "
                         f"on 4 cards; this machine has "
                         f"{torch.cuda.device_count()}")
    sys.path.insert(0, str(REPO))
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.data.phonemes import (build_vocab,
                                                    make_text_tokenizer,
                                                    phones_to_ids)
    from voicecraft_tpu_torch.inference.loader import load_codec
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.ops import _native
    from voicecraft_tpu_torch.utils import audio as au
    card = card_line()
    log(f"[1 device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    t0 = time.time()
    lib_path, _ = _native.build()
    log(f"[2 build] {lib_path.relative_to(REPO)} in {time.time() - t0:.1f} s")
    # (j)'s lanes and the engine's second texts, as the one-card run makes
    # them; the codes from the seeded codec on card 0
    tok = make_text_tokenizer("en-us", "grapheme")
    demo = au.load_audio(str(REPO / "demo" / "demo.wav"), 16000)
    long_wav = np.tile(demo, (1, LONG_TILES))
    texts = serving_texts() + serving_texts(ENGINE_TEXT_START)
    phones = [tok.phonemize(t) for t in texts]
    vocab = build_vocab(phones)
    ids = [np.asarray(phones_to_ids(p, vocab), np.int32) for p in phones]
    cfg = PRESETS["giga830M"]()
    _, codec = load_codec(None, random_init=True, seed=SEED, device="cuda:0",
                          codebook_size=cfg.audio_vocab_size)
    codes = [ec.encode_bucketed(codec, long_wav[:, :round(sec * 16000)])[0]
             for sec in SERVE_SECONDS]
    del codec
    torch.cuda.empty_cache()
    inputs = {"reqs": list(zip(ids[:len(codes)], codes)),
              "texts2": ids[len(codes):]}
    work = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    try:
        root = os.path.join(work, "data")
        write_training_manifest(root, tok, texts)
        t0 = time.time()
        ctx = mp.get_context("spawn")
        failed = ctx.Event()
        port = free_port()
        procs = [ctx.Process(target=cards_worker,
                             args=(r, 4, port, inputs, root, failed))
                 for r in range(4)]
        for p in procs:
            p.start()
        deadline = time.time() + CARDS_PHASE_S
        while any(p.is_alive() for p in procs):
            if failed.is_set() or time.time() > deadline or any(
                    p.exitcode not in (None, 0) for p in procs):
                time.sleep(5)         # the failing rank's traceback first
                for p in procs:
                    p.terminate()
                break
            time.sleep(1)
        for p in procs:
            p.join(30)
        codes_ = [p.exitcode for p in procs]
        if codes_ != [0, 0, 0, 0]:
            raise AssertionError(f"[12 cards] rank exit codes {codes_}")
        log(f"[12 cards] (A), (B), (D), (E) done in {time.time() - t0:.1f} s")
        t0 = time.time()
        server_phase(free_port())
        log(f"[12 cards] (C) done in {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def slice_requests():
    """Phase 4's requests (a), (b), (c) with their phone ids, as
    tts_torch_cli.py makes them: (tokenizer, demo wav, the demo tiled
    LONG_TILES times, requests, phone vocabulary)."""
    from voicecraft_tpu_torch.data.phonemes import (build_vocab,
                                                    make_text_tokenizer,
                                                    phones_to_ids)
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    from voicecraft_tpu_torch.utils import audio as au
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
    return tok, demo, long_wav, requests, vocab


def loop_ops(model, r, fused_ffn):
    """(device operations, device ms) a decode step of inference_tts's loop
    (the draw, the bookkeeping, the forward, the heads and the host sync)
    at request r's geometry, over PROFILE_STEPS steps (step_profile)."""
    from voicecraft_tpu_torch.inference.tts import inference_tts
    from voicecraft_tpu_torch.ops.graphs import StepGraph
    # the loop replays its captured step from the second step on: the
    # window runs from the second replay to the (n + 2)-th
    return step_profile(
        lambda: inference_tts(model, r.x, r.codes, r.scfg, seed=SEED,
                              gen_max=PROFILE_STEPS + 3, fused_ffn=fused_ffn),
        PROFILE_STEPS, module=StepGraph, name="replay")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from voicecraft_tpu_torch import PRESETS
    from voicecraft_tpu_torch.data.phonemes import phones_to_ids
    from voicecraft_tpu_torch.data.spans import compose_tts_prefix
    from voicecraft_tpu_torch.inference.loader import load_codec, load_model
    from voicecraft_tpu_torch.inference.tts import decode_geometry, inference_tts
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.ops import _native

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
    tok, demo, long_wav, requests, vocab = slice_requests()
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
    ring = ring_phase()
    kda = kda_phase()
    kda.update(kda_launch_phase())

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
    for name in DECODE_LOOP_KERNELS:
        if launches[name] == 0:
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
    for fused in (True, False):
        ops, ms = loop_ops(model, requests[0], fused)
        log(f"  request (a)'s decode loop, fused_ffn {fused}: {_fmt(ops)} "
            f"device operations and {_fmt(ms, 4)} device ms a step "
            f"(torch.profiler over {PROFILE_STEPS} steps)")

    # ---- 5. editing ----
    edits = edit_requests(model, codec)
    with raised_eog_bias(model):
        edit_launches = edit_phase(model, codec, edits)
    launches = {name: n + edit_launches[name] for name, n in launches.items()}

    # ---- phases 6-11: the same model at PATH_DEPTH's layers ----
    del model
    torch.cuda.empty_cache()
    cfg, model, _ = load_model("giga830M", random_init=True, seed=SEED,
                               device="cuda", overrides=PATH_DEPTH)
    log(f"[6 paths] giga830M at {cfg.num_decoder_layers} of its "
        f"{PRESETS['giga830M']().num_decoder_layers} layers, full width, "
        "from the same seed, for phases 6-11")

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

    # ---- 8. continuous batching, streaming, the HTTP server ----
    t0 = time.time()
    texts2 = [np.asarray(phones_to_ids(tok.phonemize(t), vocab), np.int32)
              for t in serving_texts(ENGINE_TEXT_START)]
    for run_launches in engine_phase(model, codec, ccfg, serve, texts2,
                                     requests[0], long_wav):
        launches = {name: n + run_launches[name]
                    for name, n in launches.items()}
    log(f"[8 engine] done in {time.time() - t0:.1f} s")

    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # ---- 9. training, and the trained checkpoint's TTS ----
        t0 = time.time()
        train_launches, _ = training_phase(requests, codec, tok, work)
        launches = {name: n + train_launches[name]
                    for name, n in launches.items()}
        log(f"[9 training] done in {time.time() - t0:.1f} s")

        # ---- 10. the icefall toolbox, export, the tooling CLIs ----
        t0 = time.time()
        log("[10 toolbox]")
        for run_launches in toolbox_phase(model, codec, ccfg, requests, serve,
                                          work):
            launches = {name: n + run_launches[name]
                        for name, n in launches.items()}
        log(f"[10 toolbox] done in {time.time() - t0:.1f} s")

        # ---- 11. the mesh on one card ----
        t0 = time.time()
        for run_launches in mesh_phase(model, serve, work, requests[0]):
            launches = {name: n + run_launches[name]
                        for name, n in launches.items()}
        log(f"[11 mesh] done in {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 13. the recipe twins on the card ----
    recipe_phase()

    # ---- 14. bench_torch.py, the twin of bench.py ----
    t0 = time.time()
    for run_launches in bench_phase(requests, edits):
        launches = {name: n + run_launches[name]
                    for name, n in launches.items()}
    log(f"[14 bench] done in {time.time() - t0:.1f} s")

    # ---- 15. an installed copy of the port, against the checkout ----
    torch.cuda.empty_cache()
    install_phase(long_wav, requests[0].transcript, len(requests[0].x))

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
        dict(name="ring_decode_attention", route="cuda",
             source="voicecraft_tpu_torch/csrc/ring_decode_attention.cu",
             replaces=None,
             variant={"bf16": "simt, fp8 slab read in place, two passes "
                              "over the allowed keys"},
             launches=launches["ring_decode_attention"], **ring),
        dict(name="kda_recurrent", route="cuda",
             source="voicecraft_tpu_torch/csrc/kda_recurrent.cu",
             replaces=None,
             variant={"bf16": "simt, a thread a value column with its "
                              "state in registers across tokens"},
             launches=launches["kda_recurrent"], **kda),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cards"] and len(sys.argv) == 3:
        cards_main(int(sys.argv[2]))
    elif len(sys.argv) > 1:
        raise SystemExit("usage: python3 chip_smoke.py [--cards 4]")
    else:
        main()
