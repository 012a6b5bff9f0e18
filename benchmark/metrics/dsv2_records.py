"""What the ``*.dsv2`` readers share: the port's latent-attention and
expert spans laid over the traced slice's device operations, and its
record of the rows routed to each expert (``voicecraft_tpu_torch.utils.
tracing``: spans ``mla.attend``, ``moe.layer``, ``moe.experts`` and
``expert_rows``).  Not a metric itself.

A device operation belongs to a span when the runtime call that put it on
the stream (its kineto correlation id, as ``prefill_ms.single`` ties
them) started inside one of the span's intervals on the host: a kernel
launch, a copy, or the launch of a CUDA graph, whose kernels all carry
the launch's id (the engine replays each part of the stack from a graph
of its own, inside the part's span).  Each
reader returns None where it finds nothing: no trace (the CPU), a program
without the spans or the record (one without the block), or no such span
in the slice."""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from harness import port_records
from harness.common import PEAK_HBM_BYTES, architecture

LAUNCHES = port_records.LAUNCH_CALLS + ("cudaGraphLaunch", "cuGraphLaunch")


def _intervals(res, name: str) -> List[Tuple[float, float]]:
    """The slice's spans ``name`` as sorted, merged (start us, end us)."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(port_records.slice_spans(res, name)):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def span_device_s(res, name: str) -> Optional[float]:
    """Seconds of the device operations launched inside spans ``name``."""
    tr = res.trace
    spans = _intervals(res, name)
    if tr is None or not spans or not tr.device_ops:
        return None
    corr = tr.correlation
    if len(corr.get("host", ())) != len(tr.host_ops) or \
            len(corr.get("device", ())) != len(tr.device_ops):
        return None
    starts = [s for s, _ in spans]
    ids = set()
    for (n, s, _), c in zip(tr.host_ops, corr["host"]):
        if not n.startswith(LAUNCHES):
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i][1]:
            ids.add(c)
    if not ids:
        return None
    return sum(e - s for (_, s, e), c in zip(tr.device_ops, corr["device"])
               if c in ids) / 1e6


def span_share(res, name: str) -> Optional[float]:
    """Device time inside spans ``name`` over the slice's device time, %."""
    t = span_device_s(res, name)
    total = res.trace.op_seconds() if res.trace is not None else 0.0
    return None if t is None or not total else 100.0 * t / total


def slice_expert_rows(res):
    """The rows routed to each expert of each expert layer by each decode
    forward kept in the slice, [forwards, layers, experts] (host), or
    None."""
    tracing = port_records._tracing()
    bounds = port_records._slice_bounds(res)
    if tracing is None or bounds is None or \
            not hasattr(tracing, "expert_rows"):
        return None
    return tracing.expert_rows(int(bounds[0] * 1e3), int(bounds[1] * 1e3))


def experts_touched(res) -> Optional[float]:
    """Mean over the slice's decode forwards and expert layers of the
    experts that saw at least one row."""
    rows = slice_expert_rows(res)
    if rows is None:
        return None
    return float((rows > 0).sum()) / (rows.shape[0] * rows.shape[1])


def expert_roofline(res) -> Optional[float]:
    """The routed experts' grouped products: the bytes they need (each
    touched expert's matrices once, its rows in and out; the architecture
    module's ``expert_product_bytes``) at the HBM peak, over the device
    time of the operations inside ``moe.experts``, %."""
    rows = slice_expert_rows(res)
    cfg = res.readings.get("cfg")
    t = span_device_s(res, "moe.experts")
    if rows is None or cfg is None or not t:
        return None
    count = architecture(cfg).expert_product_bytes
    need = sum(count(cfg, layer.tolist()) for step in rows for layer in step)
    return 100.0 * need / PEAK_HBM_BYTES / t
