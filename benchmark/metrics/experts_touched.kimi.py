"""Mean held experts with at least one row, a layer a decode step, in the
traced burst (the port's expert-rows record)."""
from harness.common import load_file
from pathlib import Path

_h = load_file(Path(__file__).with_name("dsv2_records.py"), "bench_dsv2_records")
read = _h.experts_touched
