"""The KDA recurrence's kernel in decode steps (``kda.recur``): the bytes
the traced burst's calls need at the HBM peak over their device time, %
(kimi_records.kda_roofline)."""
from harness.common import load_file
from pathlib import Path

_h = load_file(Path(__file__).with_name("kimi_records.py"), "bench_kimi_records")
read = _h.kda_roofline
