"""The held routed experts' grouped products (``moe.experts``): the bytes
the traced burst's routed rows need at the HBM peak over the products'
device time, % (dsv2_records.expert_roofline)."""
from harness.common import load_file
from pathlib import Path

_h = load_file(Path(__file__).with_name("dsv2_records.py"), "bench_dsv2_records")
read = _h.expert_roofline
