"""Spans and counters of the port's own phases, on the clock of the torch
profiler's host events.

Spans.  ``with span("decode.step"):`` records the phase's name, start and
end and the span it ran inside (its parent, on the same thread), in a
bounded buffer in memory.  A span records
only while a torch profiler is recording in the process (a benchmark's
traced slice, the trainer's ``--profile-dir`` window,
``utils/profiling.py``): otherwise it costs one read of the profiler's
state and nothing else, no clock read, no allocation and nothing on the
device.  While it records, it also opens a profiler range of its name, so
the profiler's host events and the Chrome trace that ``utils/profiling.py``
writes carry the span.  That range is a function-scope RecordFunction
(``torch._C._profiler._RecordFunctionFast``), not a user annotation
(``torch.profiler.record_function``): kineto mirrors a user annotation onto
the GPU timeline as a device-side event, which a reader of the trace would
count among the device's operations.

Counters.  Always on: host integers and host clock reads at boundaries the
program crosses once a request or once a burst, never once a step, and
never a device read.  The continuous-batching engine marks each request's
admission, its first streamed rows that complete a frame and its
retirement (:func:`mark_request`), and records each pass of its loop with
the host time in admission and in the wait for a burst's snapshot
(:func:`record_burst`).

Expert rows.  While a profiler records, each decode forward of a block
with routed experts (models/deepseek_v2.py) keeps the rows it routed to
each expert of each expert layer, [layers, experts], in a ring of device
rows (:func:`record_expert_rows`: one device copy a forward, no host
read), stamped on the host; :func:`expert_rows` reads those of a span of
time back after the profiler has stopped.

Spans are stamped in Unix nanoseconds (``time.time_ns``), the clock of the
profiler's host events (``KinetoEvent.start_ns``), so a reader can lay a
span over a trace's device operations.  Counters are stamped with
:func:`counter_ns`: Unix nanoseconds at import advanced by the monotonic
``time.perf_counter_ns``, so a counted duration never steps with the wall
clock, while a stamp still tells which counted work ended before a traced
slice began.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

_UNIX_AT_ZERO = time.time_ns() - time.perf_counter_ns()

MAX_RECORDS = 1 << 16        # of each kind; the oldest are dropped


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]     # the enclosing span's id on the same thread


class RequestMark(NamedTuple):
    source: int               # the engine (new_source) that marked it
    rid: int
    event: str                # "admit", "first_rows" or "retire"
    t_ns: int


class Burst(NamedTuple):
    """One pass of the engine's loop: its wall, the host ns in admission
    and in the wait for a burst's snapshot (the device); ``refills`` lanes
    were refilled in its admission."""
    source: int
    start_ns: int
    end_ns: int
    admit_ns: int
    wait_ns: int
    refills: int


_spans: deque = deque(maxlen=MAX_RECORDS)
_marks: deque = deque(maxlen=MAX_RECORDS)
_bursts: deque = deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_sources = itertools.count(1)
_local = threading.local()
_range = torch._C._profiler._RecordFunctionFast


class _Recording:
    """A span while the profiler records."""

    __slots__ = ("name", "id", "parent", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.time_ns()
        self.rf = _range(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        end = time.time_ns()
        _local.stack.pop()
        _spans.append(Span(self.name, self.start, end, self.id, self.parent))
        return False


_OFF = contextlib.nullcontext()     # a span while no profiler records


def span(name: str):
    """``with span(name):`` records the enclosed phase while a torch
    profiler is recording, and is a shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name)


def spans() -> List[Span]:
    """The recorded spans in the order they closed (the last
    ``MAX_RECORDS``)."""
    return list(_spans)


def counter_ns() -> int:
    """The counters' clock (see the module's docstring)."""
    return _UNIX_AT_ZERO + time.perf_counter_ns()


def new_source() -> int:
    """A fresh id for an object that records counters (an engine)."""
    return next(_sources)


def mark_request(source: int, rid: int, event: str,
                 t_ns: Optional[int] = None) -> None:
    _marks.append(RequestMark(source, rid, event,
                              counter_ns() if t_ns is None else t_ns))


def request_marks() -> List[RequestMark]:
    return list(_marks)


def record_burst(burst: Burst) -> None:
    _bursts.append(burst)


def bursts() -> List[Burst]:
    return list(_bursts)


# the expert-rows ring: device rows, and (stamp, slot) of each in use
EXPERT_RING = 4096
_expert = {"ring": None, "next": 0}
_expert_stamps: deque = deque(maxlen=EXPERT_RING)


def recording() -> bool:
    """Whether a torch profiler is recording (spans and expert rows are
    kept)."""
    return _profiler._is_profiler_enabled


def record_expert_rows(counts: torch.Tensor) -> None:
    """Keep one forward's rows routed to each expert, ``counts``
    [layers, experts] (integers on the device), in the device ring while a
    profiler records; nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return
    ring = _expert["ring"]
    if (ring is None or ring.shape[1:] != counts.shape
            or ring.device != counts.device):
        ring = _expert["ring"] = torch.zeros(
            (EXPERT_RING, *counts.shape), dtype=torch.int32,
            device=counts.device)
        _expert_stamps.clear()
    slot = _expert["next"] % EXPERT_RING
    _expert["next"] += 1
    ring[slot].copy_(counts)
    _expert_stamps.append((time.time_ns(), slot))


def expert_rows(lo_ns: int = 0, hi_ns: Optional[int] = None
                ) -> Optional[torch.Tensor]:
    """The kept forwards' expert rows stamped in [lo_ns, hi_ns], as a host
    tensor [forwards, layers, experts] in the order they ran (a device
    read); None where none was kept."""
    ring = _expert["ring"]
    slots = [slot for t, slot in _expert_stamps
             if t >= lo_ns and (hi_ns is None or t <= hi_ns)]
    if ring is None or not slots:
        return None
    return ring[torch.tensor(slots, device=ring.device)].cpu().long()


def clear() -> None:
    """Forget every span and counter (tests)."""
    _spans.clear()
    _marks.clear()
    _bursts.clear()
    _expert_stamps.clear()
