"""Device time of the operations launched inside the port's ``moe.layer``
spans (router to combine, the shared expert included) over the traced
burst's device time, %."""
from harness.common import load_file
from pathlib import Path

_h = load_file(Path(__file__).with_name("dsv2_records.py"), "bench_dsv2_records")


def read(res):
    return _h.span_share(res, "moe.layer")
