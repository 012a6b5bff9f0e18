"""A traced slice of the window: torch.profiler over CPU and CUDA activity,
reduced to device operations, busy time, idle gaps and what the host was
doing in them.  The profiler runs only inside a slice, since it slows a
host-bound loop."""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch


@dataclass
class TraceSummary:
    """Device operations of one slice: (name, start us, end us) each, the
    host's operations likewise, and the slice's wall seconds.

    ``correlation`` holds kineto's correlation id of each event, by side
    (``"device"``, ``"host"``), in the order of ``device_ops`` and
    ``host_ops``: a device operation carries the id of the runtime call
    that put it on the stream (every kernel of a replayed CUDA graph that
    of its graph launch).  Empty where the slice did not record them."""
    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    window_s: float
    steps: int = 0                # decode or training steps in the slice
    extra: Dict[str, float] = field(default_factory=dict)
    correlation: Dict[str, List[int]] = field(default_factory=dict)

    @property
    def n_ops(self) -> int:
        return len(self.device_ops)

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union)."""
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if e > end:
                total += e - max(s, end)
                end = e
        return total / 1e6

    def op_seconds(self) -> float:
        return sum(e - s for _, s, e in self.device_ops) / 1e6

    def times_of(self, part: str) -> List[float]:
        """Seconds of each device operation whose name holds ``part``."""
        return [(e - s) / 1e6 for n, s, e in self.device_ops if part in n]

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device_ops:
            out[n] += (e - s) / 1e6
        return out

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """(start us, end us) of each stretch between the slice's first and
        last device operation in which none ran."""
        gaps, end = [], None
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        host = sorted(self.host_ops, key=lambda o: o[1])
        starts = [s for _, s, _ in host]
        by_host: Dict[str, float] = defaultdict(float)
        import bisect
        for g0, g1 in self.idle_gaps():
            mid = (g0 + g1) / 2
            # the innermost host operation running at the gap's middle
            i = bisect.bisect_right(starts, mid)
            name, best = "host between operations", None
            for n, s, e in host[max(0, i - 64):i]:
                if s <= mid <= e and (best is None or e - s < best):
                    name, best = n, e - s
            by_host[name] += (g1 - g0) / 1e6
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps]}


class Slice:
    """``with Slice(device) as sl: ...`` traces the enclosed work; the
    slice starts and ends in a device sync, so its device time fits in its
    wall time.  ``sl.summary`` is None on the CPU."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.summary: Optional[TraceSummary] = None
        self._prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._sync()
        self._prof.start()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        t1 = time.perf_counter()
        self._prof.stop()
        if exc[0] is not None or self.device.type != "cuda":
            return False
        # the profiler's raw events: building its FunctionEvent tree takes
        # minutes for a host-bound slice of ~10^5 operations
        dev, host = [], []
        corr = {"device": [], "host": []}
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e3
            rec = (e.name(), s, s + e.duration_ns() / 1e3)
            side = "device" if e.device_type() == cuda else "host"
            (dev if side == "device" else host).append(rec)
            corr[side].append(e.correlation_id())
        self.summary = TraceSummary(dev, host, t1 - self._t0,
                                    correlation=corr)
        return False
