"""Kimi Linear's decoder on one CUDA card at its published widths and
depth (64 of 256 experts held), through the port's normal paths, against
the benchmark's plain reference: one JSON line per check.

    python3 recipes/kimi_card_check.py [--seed N] [--out results.jsonl]

0. the KDA recurrence's kernel against its plain version and its time
   (chip_smoke.py's phase-3 check, ``kda_phase``);
1. the card, and the model built from the benchmark's seeded weights
   (``benchmark/architectures/kimi_linear.py``), loaded strictly, bf16;
2. one greedy ``inference_tts`` request: whether its decode step was
   captured in a CUDA graph, its rows against an eager decode's, and the
   served codes against the reference (``benchmark/reference/
   kimi_linear.py``, the state upcast a layer at a time) by the
   benchmark's gap;
3. the engine at the cell's geometry (32 lanes, bursts of 48), warmed up
   by one request (its step captured): one burst under
   ``torch.cuda.set_sync_debug_mode("error")``, then the rest of its
   requests, a burst's device operations by name under torch.profiler
   (and the KDA kernel's launches, one a KDA layer and step), a refill's
   prefill time, and the served codes of two requests against the
   reference.

Needs a CUDA card; exits 3 without one."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "benchmark")]

from harness import common  # noqa: E402
from harness.check import served_gap  # noqa: E402

OUT = []


def emit(**kw):
    line = json.dumps(kw)
    print(line, flush=True)
    OUT.append(line)


def served(ref, x, prompt, rows, V):
    """(widest gap, mean gap, cells) of served rows against the reference."""
    dev = ref.device
    x_t = torch.as_tensor(np.asarray(x), device=dev)
    p_t = torch.as_tensor(np.asarray(prompt), device=dev)
    r_t = torch.as_tensor(np.asarray(rows), device=dev).long()
    cols = ref.tts_columns(p_t, r_t[:-1])
    logits = ref.logits(x_t, cols, out_from=p_t.shape[1])
    gap, total, cells = served_gap(logits, r_t, V)
    return gap, total / max(cells, 1), cells


def rows_of(cfg, gen):
    K, Tg = gen.shape
    rows = np.full((Tg, K), cfg.empty_token, np.int64)
    for q in range(K):
        rows[q:, q] = gen[q, :Tg - q]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2718281828459)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    from voicecraft_tpu_torch.config import ModelConfig
    from voicecraft_tpu_torch.inference import engine as eng_mod
    from voicecraft_tpu_torch.inference import tts
    from voicecraft_tpu_torch.models import voicecraft as vc
    from voicecraft_tpu_torch.ops import _native, graphs
    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit(phase="card", torch=torch.__version__, cuda=torch.version.cuda,
         card=smi)
    chip_smoke.log = lambda msg: print(msg, file=sys.stderr, flush=True)
    t0 = time.time()
    emit(phase="kda_kernel", seconds=time.time() - t0,
         **chip_smoke.kda_phase())
    dev = torch.device("cuda")
    cfg_d = common.load_json(REPO / "benchmark" / "configs"
                             / "kimi_linear_48b_a3b.json")
    arch = common.architecture(cfg_d)
    refmod = common.load_file(REPO / "benchmark" / "reference"
                              / "kimi_linear.py", "card_ref_kimi")
    cfg = ModelConfig.from_dict(cfg_d)
    t0 = time.time()
    model = vc.VoiceCraft(cfg, dev)
    state = arch.make_state(cfg_d, args.seed, dev, torch.bfloat16)
    state["heads.b2"][0, cfg.eos] += -10.0
    model.load_state_dict(state, strict=True)
    del state
    model.eval()
    torch.cuda.synchronize()
    emit(phase="build", seconds=time.time() - t0,
         params=sum(p.numel() for p in model.parameters()),
         memory_gb=torch.cuda.memory_allocated() / 1e9)
    # the reference reads the model's own bf16 tensors (read-only)
    refmod.exact_f32()
    ref = refmod.Reference(cfg_d, model.state_dict(), dev)
    V = cfg.audio_vocab_size
    rng = np.random.default_rng(5)

    def request(prompt_frames, gen_frames):
        phones = (prompt_frames + gen_frames) // 10 + 1
        return (rng.integers(0, cfg.text_vocab_size, phones),
                rng.integers(0, V, (cfg.n_codebooks, prompt_frames)))

    # ---- 2. inference_tts, graphed and eager --------------------------------
    x, prompt = request(300, 200)
    captured = []
    graph_cls = graphs.StepGraph

    class Counting(graph_cls):
        def __init__(self, *a, **kw):
            captured.append(1)
            super().__init__(*a, **kw)
    graphs.StepGraph = Counting
    scfg = vc.SamplingConfig(top_k=1, silence_tokens=())
    torch.cuda.synchronize()
    t0 = time.time()
    stats = {}
    _, gen = tts.inference_tts(model, x, prompt, scfg, stats=stats)
    torch.cuda.synchronize()
    t_graph = time.time() - t0
    graphs.StepGraph = graph_cls
    engages = graphs.step_graph_engages
    graphs.step_graph_engages = lambda m: False
    t0 = time.time()
    _, gen_eager = tts.inference_tts(model, x, prompt, scfg)
    torch.cuda.synchronize()
    t_eager = time.time() - t0
    graphs.step_graph_engages = engages
    rows = rows_of(cfg, gen)
    gap, mean, cells = served(ref, x, prompt, rows, V)
    emit(phase="inference_tts", step_graph_engages=engages(model),
         graphs_captured=len(captured), steps=stats.get("steps"),
         frames=int(gen.shape[1]), seconds_graphed=t_graph,
         seconds_eager=t_eager,
         graphed_equals_eager=bool(np.array_equal(gen, gen_eager)),
         logit_gap=gap, logit_gap_mean=mean, cells=cells)

    # ---- 3. the engine at the cell's geometry ----------------------------------
    eng = eng_mod.ContinuousBatcher(model, lanes=32, x_pad=96, y_pad=448,
                                    gen_max=448, burst=48, scfg=scfg, seed=1)
    reqs = [request(int(p), int(g)) for p, g in
            zip(rng.choice([150, 200, 250, 300, 350, 400], 40),
                rng.choice([100, 160, 220, 280, 340, 400], 40))]
    # set-up: one request through its bursts (the first step runs
    # eagerly, the second captures the stack's parts, the rest replay)
    t0 = time.time()
    eng.submit(*request(150, 100))
    eng.run()
    torch.cuda.synchronize()
    emit(phase="engine_warm", seconds=time.time() - t0)
    # a refill's prefill (one lane, the cell's pads), timed alone
    lane = eng._lanes
    x1, y1 = request(400, 400)
    xt = np.full((1, 96), cfg.text_pad_token, np.int64)
    xt[0, :len(x1)] = x1
    from voicecraft_tpu_torch.data.spans import compose_tts_prefix
    pre = compose_tts_prefix(y1, cfg)
    yt = np.full((1, cfg.n_codebooks, 448), cfg.empty_token, np.int64)
    yt[0, :, :pre.length] = pre.tokens
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        eng._prefill_lane(model, eng._cache, lane, 0, xt, len(x1), yt,
                          pre.length, 0)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    lane.active[0] = False
    emit(phase="refill_prefill", tokens=len(x1) + pre.length,
         seconds=times)
    ids = [eng.submit(x, y) for x, y in reqs]
    t0 = time.time()
    eng._admit()
    torch.cuda.synchronize()
    t_admit = time.time() - t0
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.time()
        snap = eng._dispatch_burst()
        t_enq = time.time() - t0
        sync_free = True
    except RuntimeError as e:
        sync_free = repr(e)[:300]
        t_enq = None
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit(phase="engine_burst_sync_debug", sync_free=sync_free,
         wave_prefill_s=t_admit, burst_enqueue_s=t_enq)
    eng._process_burst(snap)
    # one burst traced: device operations by name
    from torch.profiler import ProfilerActivity, profile
    eng._admit()
    torch.cuda.synchronize()
    kda0 = _native.LAUNCHES["kda_recurrent"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        snap = eng._dispatch_burst()
        torch.cuda.synchronize()
        t_burst = time.time() - t0
    kda_launches = _native.LAUNCHES["kda_recurrent"] - kda0
    eng._process_burst(snap)
    dev_us = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[e.key] = t
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:15]
    emit(phase="engine_burst_profile", wall_ms_per_step=t_burst * 1e3 / 48,
         kda_launches_per_step=kda_launches / 48,
         device_ms_per_step=sum(dev_us.values()) / 1e3 / 48,
         top_ops_ms_per_step=[[k, v / 1e3 / 48] for k, v in top])
    t0 = time.time()
    steps0 = eng.stats["steps"]
    res = eng.run()
    wall = time.time() - t0
    emit(phase="engine_drain", seconds=wall,
         ms_per_step=wall * 1e3 / max(eng.stats["steps"] - steps0, 1),
         requests=len(res), stats=eng.stats,
         memory_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    worst = []
    for i in (0, 17):
        x, y = reqs[i]
        gap, mean, cells = served(ref, x, y, rows_of(cfg, res[ids[i]][1]), V)
        worst.append({"request": i, "logit_gap": gap, "logit_gap_mean": mean,
                      "cells": cells})
    emit(phase="engine_check", requests=worst)
    emit(phase="done", ok=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(OUT) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
