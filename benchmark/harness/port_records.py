"""The per-layer metrics read from the port's own spans and counters
(``voicecraft_tpu_torch.utils.tracing``), laid over the traced slice.

The port stamps spans on the clock of the profiler's host events (Unix ns;
``TraceSummary`` keeps microseconds), so a span lies over the slice's
device operations, and counters on Unix ns advanced by a monotonic clock,
so a counted request or burst can be told to have ended before the slice
began.  Each reader returns None where it finds
nothing: no trace (the CPU), a program without the tracing module, or no
record of the work it reads.

What each reads:

- the decode loop's spans (``tts830e.single``): those of the traced
  request, the spans that overlap the slice's host events (a span records
  only while a profiler runs);
- the engine's counters (``tts830e.stream32``): the requests and bursts
  of the engine that counted last which ended before the slice began (the
  slice's profiler stalls the engine: its exit walks the raw events inside
  a streaming callback) and after the window's first admission (request 0
  is the set-up's);
- the training step's update span (``train830.recipe``), in the traced
  step.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from .common import percentile

# host calls that put one operation on the device's stream each
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                "cudaMemset", "cuMemset")


def _tracing():
    try:
        from voicecraft_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def _slice_bounds(res) -> Optional[Tuple[float, float]]:
    """(first start, last end) of the traced slice's host events, us."""
    tr = res.trace
    if tr is None or not tr.host_ops:
        return None
    return (min(s for _, s, _ in tr.host_ops),
            max(e for _, _, e in tr.host_ops))


def slice_spans(res, name: str) -> List[Tuple[float, float]]:
    """(start us, end us) of each span ``name`` in the traced slice, in
    the order they closed."""
    tracing, bounds = _tracing(), _slice_bounds(res)
    if tracing is None or bounds is None:
        return []
    lo, hi = bounds
    return [(s.start_ns / 1e3, s.end_ns / 1e3) for s in tracing.spans()
            if s.name == name and s.end_ns / 1e3 >= lo
            and s.start_ns / 1e3 <= hi]


def _walls(res, name: str) -> List[float]:
    return [e - s for s, e in slice_spans(res, name)]


# ---- tts830e.single: the decode loop's spans ----------------------------------

def prefill_ms(res) -> Optional[float]:
    """From the prefill span's start to the end of the prefill's last
    device operation.  Operations run in launch order on the one stream,
    so the k-th call that launches one (LAUNCH_CALLS, among the slice's
    host events) put the k-th device operation there: the prefill's last
    is the one that the last launch inside the span put.  Read only where
    the slice has as many launch calls as device operations."""
    tr = res.trace
    spans = slice_spans(res, "decode.prefill")
    if tr is None or not spans:
        return None
    start, end = spans[0]
    launches = sorted(s for n, s, _ in tr.host_ops
                      if n.startswith(LAUNCH_CALLS))
    ops = sorted(tr.device_ops, key=lambda o: (o[1], o[2]))
    if not launches or len(launches) != len(ops):
        return None
    k = bisect.bisect_right(launches, end)
    if k == 0 or launches[k - 1] < start:
        return None
    return (ops[k - 1][2] - start) / 1e3


def step_host_ms(res) -> Optional[float]:
    """Mean wall of ``decode.step``: the host issuing one decode step."""
    walls = _walls(res, "decode.step")
    return sum(walls) / len(walls) / 1e3 if walls else None


def sampling_share(res) -> Optional[float]:
    """``decode.sample``'s share of the ``decode.step`` wall, %."""
    steps, samples = _walls(res, "decode.step"), _walls(res, "decode.sample")
    if not steps or not samples:
        return None
    return 100.0 * sum(samples) / sum(steps)


def sync_wait_ms_per_step(res) -> Optional[float]:
    """``decode.sync`` wall (the host waiting for the step group's counts)
    over the decode steps."""
    steps, syncs = _walls(res, "decode.step"), _walls(res, "decode.sync")
    if not steps or not syncs:
        return None
    return sum(syncs) / len(steps) / 1e3


# ---- train830.recipe: the update span -----------------------------------------

def optimizer_ms(res) -> Optional[float]:
    """From the ``train.update`` span's start to the end of the traced
    step's last device operation: the step syncs on the loss before the
    update, so every device operation after the span's start is the
    update's."""
    tr = res.trace
    spans = slice_spans(res, "train.update")
    if tr is None or not spans or not tr.device_ops:
        return None
    start = spans[-1][0]
    last = max(e for _, _, e in tr.device_ops)
    return (last - start) / 1e3 if last > start else None


# ---- tts830e.stream32: the engine's counters ----------------------------------

def _engine_records(res):
    """(requests: {rid: {event: t_ns}}, bursts) of the engine that counted
    last, ended after the window's first admission and before the traced
    slice began; None where there is nothing to read."""
    tracing, bounds = _tracing(), _slice_bounds(res)
    if tracing is None or bounds is None:
        return None
    marks = tracing.request_marks()
    if not marks:
        return None
    source, began = marks[-1].source, bounds[0] * 1e3
    by_rid = {}
    for m in marks:
        if m.source == source and m.rid != 0:
            by_rid.setdefault(m.rid, {})[m.event] = m.t_ns
    admits = [ev["admit"] for ev in by_rid.values() if "admit" in ev]
    if not admits:
        return None
    opened = min(admits)
    done = {rid: ev for rid, ev in by_rid.items()
            if ev.get("retire", began) < began}
    bursts = [b for b in tracing.bursts() if b.source == source
              and opened <= b.end_ns < began]
    return done, bursts


def first_rows_p90_ms(res) -> Optional[float]:
    """90th percentile, over the requests retired before the slice, of
    the wall from admission to the first streamed rows that complete a
    frame.  At the cell's 2.4/s that is some 50 requests, so only about
    five lie beyond the percentile."""
    rec = _engine_records(res)
    if rec is None:
        return None
    waits = [(ev["first_rows"] - ev["admit"]) / 1e6 for ev in rec[0].values()
             if "admit" in ev and "first_rows" in ev]
    return percentile(waits, 90) if waits else None


def admit_ms_per_refill(res) -> Optional[float]:
    """Host ms in admission over the lanes refilled, in the bursts before
    the slice."""
    rec = _engine_records(res)
    if rec is None:
        return None
    refills = sum(b.refills for b in rec[1])
    return sum(b.admit_ns for b in rec[1]) / refills / 1e6 if refills else None


def device_wait_share(res) -> Optional[float]:
    """The wait for the bursts' snapshots (the host blocked on the
    device) over the engine loop's host wall, %, in the bursts before the
    slice."""
    rec = _engine_records(res)
    if rec is None:
        return None
    wall = sum(b.end_ns - b.start_ns for b in rec[1])
    return 100.0 * sum(b.wait_ns for b in rec[1]) / wall if wall else None
