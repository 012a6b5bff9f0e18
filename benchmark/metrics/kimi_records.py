"""What the ``*.kimi`` readers add to dsv2_records.py's: the KDA
recurrence's roofline, from the port's ``kda.recur`` spans (a decode
step's recurrence of one KDA layer: its kernel only) and its record of
the lanes each of them advanced (``voicecraft_tpu_torch.utils.tracing``:
``kda_calls``).  Not a metric itself.  A reader returns None where it
finds nothing: no trace, a program without the span or the record (one
without the block), or no such span in the slice."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from harness import port_records
from harness.common import PEAK_HBM_BYTES, architecture, load_file

_h = load_file(Path(__file__).with_name("dsv2_records.py"),
               "bench_dsv2_records")


def slice_kda_calls(res):
    """The lanes of each decode recurrence kept in the slice, or None."""
    tracing = port_records._tracing()
    bounds = port_records._slice_bounds(res)
    if tracing is None or bounds is None or \
            not hasattr(tracing, "kda_calls"):
        return None
    return tracing.kda_calls(int(bounds[0] * 1e3), int(bounds[1] * 1e3))


def kda_roofline(res) -> Optional[float]:
    """The decode recurrences' bytes (each call's state read and written
    once, its inputs and outputs once: the architecture module's
    ``kda_step_bytes``) at the HBM peak, over the device time of the
    operations inside ``kda.recur``, %."""
    calls = slice_kda_calls(res)
    cfg = res.readings.get("cfg")
    t = _h.span_device_s(res, "kda.recur")
    if not calls or cfg is None or not t:
        return None
    count = architecture(cfg).kda_step_bytes
    return 100.0 * sum(count(cfg, n) for n in calls) / PEAK_HBM_BYTES / t
