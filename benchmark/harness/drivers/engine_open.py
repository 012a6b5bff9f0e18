"""Independent users of a streaming TTS service, in an open loop, through
``inference/engine.py:ContinuousBatcher`` (``submit(..., on_rows=)`` and
``run()``).

Requests come due on a schedule whatever the engine is doing.  The engine
admits only between bursts and runs its loop inside ``run()``, so the
generator submits every due request from the streaming callbacks, which the
engine calls on its own thread after each burst, right before it admits;
while the engine is idle the generator sleeps until the next request is
due and calls ``run()`` again.  Each request is timed from when it was due:
its first streamed frame, and its last.  The engine drains every request
due in the window, however long past the close that takes."""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from .. import counts, traffic as tr
from ..common import RunResult, percentile
from ..trace import Slice
from .common_serving import bias_stop_code, check_served, pick_checked
from .tts_closed import _scfg


def _engine(ctx, model, t, scfg, seed):
    from voicecraft_tpu_torch.inference.engine import ContinuousBatcher
    return ContinuousBatcher(
        model, lanes=t["lanes"], x_pad=t["x_pad"], y_pad=t["y_pad"],
        gen_max=t["gen_max"], burst=t["burst"], scfg=scfg, seed=seed,
        kv_dtype=t.get("kv_dtype"))


def run(ctx) -> RunResult:
    t, cfg = ctx.traffic, ctx.cfg
    K, sr = cfg["n_codebooks"], cfg["encodec_sr"]
    if "eos_bias" in t:
        bias_stop_code(ctx, cfg["eos"], t["eos_bias"])
    model = ctx.build_model()
    if t.get("fp8_weights"):
        from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
        served = quantize_decoder_fp8(model, pack_qkv=bool(t.get("pack_qkv")))
        del model
        ctx.free()
        model = served
    scfg = _scfg(t["sampling"])
    eng = _engine(ctx, model, t, scfg, ctx.seed)

    # set-up: one request through a refill and its bursts (the engine's
    # shapes are fixed by its lanes and pads)
    sizes = tr.size_set(t)
    warm = tr.make_request(t, cfg, ctx.seed, 10 ** 6,
                           max(sizes, key=lambda s: s["prompt_frames"]))
    eng.submit(warm.x, warm.prompt, on_rows=lambda rows: None)
    eng.run()
    ctx.setup_done()

    reqs = tr.open_loop(t, cfg, ctx.seed, ctx.seconds, ctx.rate)
    pending = deque(reqs)
    rec = {}                      # request index -> its times and rows
    state = {"slice": None, "traced": None, "t0": 0.0, "steps0": 0}
    trace_at = ctx.seconds / 2

    def on_rows_of(r):
        def on_rows(rows):
            now = time.perf_counter() - t0
            e = rec[r.index]
            if e["first"] is None and len(rows) >= K:
                e["first"] = now
            e["last"], e["rows"] = now, rows
            pump(now)
        return on_rows

    def pump(now):
        if ctx.trace:
            toggle_trace(now)
        while pending and pending[0].due_s <= now:
            r = pending.popleft()
            rec[r.index] = {"req": r, "submit": now, "first": None,
                            "last": None, "rows": None}
            rec[r.index]["rid"] = eng.submit(r.x, r.prompt,
                                             on_rows=on_rows_of(r))

    def toggle_trace(now):
        if state["traced"] is not None:
            return
        if state["slice"] is None and now >= trace_at:
            state["slice"] = Slice(ctx.device).__enter__()
            state["steps0"] = eng.stats["steps"]
            state["bursts0"] = eng.stats["bursts"]
        elif (state["slice"] is not None
              and eng.stats["bursts"] >= state["bursts0"] + t["trace_bursts"]):
            sl = state["slice"]
            sl.__exit__(None, None, None)
            state["traced"] = sl.summary or False
            if sl.summary is not None:
                sl.summary.steps = eng.stats["steps"] - state["steps0"]

    steps0 = eng.stats["steps"]
    t0 = ctx.now()
    results = {}
    while pending:
        wait = pending[0].due_s - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        pump(time.perf_counter() - t0)
        results.update(eng.run())
    t_end = time.perf_counter() - t0
    if state["slice"] is not None and state["traced"] is None:
        state["slice"].__exit__(None, None, None)
        state["traced"] = state["slice"].summary or False
        if state["traced"]:
            state["traced"].steps = eng.stats["steps"] - state["steps0"]
    steps = eng.stats["steps"] - steps0
    peak = ctx.memory_peak()

    rtf, first, late, finished_audio, failed = [], [], [], 0.0, 0
    gen_rows, flops = 0, 0.0
    by_rid = {e["rid"]: e for e in rec.values()}
    for rid, (_, gen) in results.items():
        by_rid[rid]["frames"] = gen.shape[1]
    for e in rec.values():
        r, frames = e["req"], e.get("frames", 0)
        if not frames or e["first"] is None:
            failed += 1
            rtf.append(float("inf"))
            first.append(float("inf"))
            continue
        audio = frames / sr
        rtf.append((e["last"] - r.due_s) / audio)
        first.append((e["first"] - r.due_s) * 1e3)
        late.append((e["submit"] - r.due_s) * 1e3)
        if e["last"] <= ctx.seconds:
            finished_audio += audio
        n = len(e["rows"])
        gen_rows += n
        prefix = r.phones + r.prompt_frames + 1
        flops += (counts.prefill_flops(cfg, prefix)
                  + counts.decode_span_flops(cfg, prefix + 1, n))

    del eng, model
    ctx.free()
    done = [e for e in rec.values() if e.get("frames")]
    picked = pick_checked(done, t["check_requests"], ctx.seed,
                          lambda e: len(e["rows"]))
    items = [(e["req"].x, e["req"].prompt, e["rows"]) for e in picked]
    checks, details = check_served(ctx, items, kv=t.get("reference_kv",
                                                        "exact"))
    traced = state["traced"] or None
    res = RunResult(attempted=len(rec), failed=failed, checks=checks,
                    memory_peak_bytes=peak, trace=traced)
    res.end_to_end["rtf_p90"] = percentile(rtf, 90)
    res.end_to_end["first_frames_p90_ms"] = percentile(first, 90)
    # the wait for the first frame by thirds of the window: a backlog that
    # grows makes the last third's far longer than the first's
    by_due = [f for _, f in sorted(zip([e["req"].due_s for e in rec.values()],
                                       first))]
    n3 = max(1, len(by_due) // 3)
    thirds = [float(np.median(by_due[i * n3:(i + 1) * n3 or None]))
              for i in range(3)] if len(by_due) >= 3 else None
    res.readings.update(
        details, cfg=cfg, flops=flops, flops_wall_s=t_end,
        first_wait_by_third=thirds,
        served_audio_s_per_s=finished_audio / ctx.seconds,
        generator_late_p90_ms=percentile(late, 90) if late else None,
        lane_occupancy=100.0 * gen_rows / (steps * t["lanes"]) if steps else None,
        requests=len(rec), drained_s=t_end)
    ctx.log(f"{len(rec)} requests due in {ctx.seconds} s, drained at "
            f"{t_end:.2f} s; rtf p50 {np.median(rtf):.3f} p90 "
            f"{res.end_to_end['rtf_p90']:.3f}; first frames p50 "
            f"{np.median(first):.1f} ms; {steps} engine steps")
    return res
