"""One client in a closed loop through ``inference/tts.py:inference_tts``:
each request is sent when the previous one has returned.

The window runs requests back to back until ``--seconds`` have passed and
the request then in flight has returned, so the rate is all the work of
whole requests over all their time.  With ``--trace 1`` the first request
that starts after half the window is traced whole."""

from __future__ import annotations

import time

import torch

from .. import counts, traffic as tr
from ..common import RunResult
from ..trace import Slice
from .common_serving import bias_stop_code, check_served, pick_checked


def _scfg(spec: dict):
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    kw = dict(spec)
    if "silence_tokens" in kw:
        kw["silence_tokens"] = tuple(kw["silence_tokens"])
    return SamplingConfig(**kw)


def run(ctx) -> RunResult:
    from voicecraft_tpu_torch.inference.tts import inference_tts
    t, cfg = ctx.traffic, ctx.cfg
    if "eos_bias" in t:
        bias_stop_code(ctx, cfg["eos"], t["eos_bias"])
    model = ctx.build_model()
    sampled = _scfg(t["sampling"])
    greedy = _scfg({**t["sampling"], **t["greedy_sampling"]})
    fused = bool(t.get("fused_ffn", False))

    def serve(r, seed):
        st = {}
        full, gen = inference_tts(model, r.x, r.prompt,
                                  greedy if r.greedy else sampled, seed=seed,
                                  gen_max=r.gen, fused_ffn=fused, stats=st)
        return gen, st

    # set-up: the cell's smallest and largest prompt geometry, one short
    # budget each (every shape of a decode loop is its geometry's)
    sizes = tr.size_set(t)
    for s in (min(sizes, key=lambda s: (s["prompt_frames"], s["gen"])),
              max(sizes, key=lambda s: (s["prompt_frames"], s["gen"]))):
        warm = tr.make_request(t, cfg, ctx.seed, 10 ** 6, {**s, "gen": t["warm_gen"]})
        serve(warm, 0)
    ctx.setup_done()

    done, traced = [], None
    reqs = tr.closed_loop(t, cfg, ctx.seed)
    t0 = ctx.now()
    while True:
        r = next(reqs)
        ts = time.perf_counter()
        trace_this = (ctx.trace and traced is None
                      and ts - t0 >= ctx.seconds / 2)
        seed = ctx.seed * 7919 + r.index
        if trace_this:
            with Slice(ctx.device) as sl:
                gen, st = serve(r, seed)
            traced = sl.summary
            if traced is not None:
                traced.steps = st["steps"]
        else:
            gen, st = serve(r, seed)
        te = time.perf_counter()      # inference_tts returns host arrays
        done.append((r, gen, st, ts, te, trace_this))
        if te - t0 >= ctx.seconds:
            break
    window = done[-1][4] - t0
    audio = sum(g.shape[1] for _, g, *_ in done) / cfg["encodec_sr"]
    peak = ctx.memory_peak()

    # the whole step's share of the peak, over the untraced requests
    flops, wall = 0.0, 0.0
    for r, g, st, ts, te, was_traced in done:
        if was_traced:
            continue
        prefix = r.phones + r.prompt_frames + 1
        flops += (counts.prefill_flops(cfg, prefix)
                  + counts.decode_span_flops(cfg, prefix + 1, st["steps"]))
        wall += te - ts

    del model
    ctx.free()
    greedy_done = [d for d in done if d[0].greedy and d[1].shape[1] > 0]
    picked = pick_checked(greedy_done, t["check_requests"], ctx.seed,
                          lambda d: d[1].shape[1])
    from ..check import tts_rows_from_codes
    items = []
    for r, g, *_ in picked:
        rows = tts_rows_from_codes(torch.as_tensor(g), cfg["n_codebooks"],
                                   cfg["audio_vocab_size"])
        items.append((r.x, r.prompt, rows))
    checks, details = check_served(ctx, items)
    res = RunResult(attempted=len(done), failed=0, checks=checks,
                    memory_peak_bytes=peak, trace=traced)
    res.end_to_end["audio_s_per_s"] = audio / window
    res.readings.update(details, cfg=cfg, flops=flops, flops_wall_s=wall,
                        window_s=window, requests=len(done))
    ctx.log(f"window {window:.3f} s, {len(done)} requests, "
            f"{audio:.2f} s of audio")
    return res
