"""The arithmetic of the per-layer metrics; each ``metrics/<name>.py`` binds
one of these to its name.  A reader returns None when the run gave it
nothing to read (no trace, no such kernel), never a 0 in its place."""

from __future__ import annotations

from typing import Optional

from . import counts
from .common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def _traced(res):
    tr = res.trace
    return tr if tr is not None and tr.n_ops and tr.steps else None


def ops_per_step(res) -> Optional[float]:
    tr = _traced(res)
    return None if tr is None else tr.n_ops / tr.steps


def device_ms_per_step(res) -> Optional[float]:
    tr = _traced(res)
    return None if tr is None else tr.op_seconds() * 1e3 / tr.steps


def idle_share(res) -> Optional[float]:
    tr = res.trace
    if tr is None or not tr.n_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu(res) -> Optional[float]:
    r = res.readings
    if not r.get("flops") or not r.get("flops_wall_s"):
        return None
    return 100.0 * r["flops"] / r["flops_wall_s"] / PEAK_BF16_FLOPS


def _roofline(res, part: str, bound_s) -> Optional[float]:
    tr = res.trace
    if tr is None:
        return None
    times = tr.times_of(part)
    if not times:
        return None
    return 100.0 * bound_s / (sum(times) / len(times))


def fused_ffn_roofline_bf16(res) -> Optional[float]:
    """One decode row, bf16 weights: each input and output once at the HBM
    peak, over the kernel's mean time."""
    cfg = res.readings.get("cfg")
    if cfg is None:
        return None
    return _roofline(res, "ffn_sm90_kernel",
                     counts.fused_ffn_bytes(cfg, rows=1) / PEAK_HBM_BYTES)

