"""What every cell shares: the import guard, the cell's files and its
architecture module, device facts, the percentile and the result line."""

from __future__ import annotations

import functools
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO_DIR = BENCH_DIR.parent

# top-level module names that no process of the benchmark may hold: the JAX
# stack and the JAX package the port was made from (compared whole: the
# port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "voicecraft_tpu")

# published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def forbidden_modules() -> List[str]:
    """The forbidden top-level names present in ``sys.modules``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def guard_imports(where: str) -> None:
    """Raise naming what was found when a forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        raise ImportError(f"{where}: forbidden modules loaded: "
                          f"{', '.join(found)}")


def process_start_time() -> float:
    """This process's start on the ``time.time()`` clock (Linux's
    /proc/self/stat; the import time of this module elsewhere)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / ticks
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


_IMPORTED_AT = time.time()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the key under which ``load_cell`` records, in a configuration's dict, the
# directory of the architecture modules of the benchmark it was read from
ARCH_DIR = "architectures_dir"


@functools.lru_cache(maxsize=None)
def _architecture_at(path: Path):
    if not path.is_file():
        raise FileNotFoundError(f"no architecture module {path}")
    return load_file(path, "bench_arch_" + path.stem)


def architecture(cfg: dict):
    """The architecture module of configuration ``cfg``, with its weights
    (``make_state``) and FLOP and byte counts:
    ``architectures/<cfg["architecture"]>.py`` ("voicecraft" where the
    configuration names none) of the benchmark ``cfg`` was read from."""
    arch_dir = Path(cfg.get(ARCH_DIR, BENCH_DIR / "architectures"))
    return _architecture_at(
        arch_dir / f"{cfg.get('architecture', 'voicecraft')}.py")


@dataclass
class Cell:
    """One entry of BENCHMARK.json's ``workloads`` with its files read."""
    name: str
    config_name: str
    config: dict          # the configuration's file
    traffic_name: str
    traffic: dict         # the traffic mix's file
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_path: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of BENCHMARK.json (``bench_path``, by default
    the one at the checkout's root) with its configuration and traffic."""
    spec = load_json(bench_path or REPO_DIR / "BENCHMARK.json")
    root = (bench_path or REPO_DIR / "BENCHMARK.json").parent
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    traffic = load_json(root / BENCH_DIR.name / "traffic"
                        / f"{w['traffic']}.json")
    config = {**load_json(root / cfg_entry["file"]),
              ARCH_DIR: str(root / BENCH_DIR.name / "architectures")}
    architecture(config)
    return Cell(name=workload, config_name=w["config"],
                config=config,
                traffic_name=w["traffic"], traffic=traffic,
                chips=int(w["chips"]),
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, workload)])


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), over every value given."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclass
class Check:
    """One number that decides ``correct``, with its limit: the value must
    not exceed ``limit`` (``at_least``: must not fall below it)."""
    name: str
    value: float
    limit: float
    at_least: bool = False

    @property
    def ok(self) -> bool:
        if self.value is None or not math.isfinite(self.value):
            return False
        return self.value >= self.limit if self.at_least else \
            self.value <= self.limit


@dataclass
class RunResult:
    """What a driver hands back: end-to-end numbers, what the per-layer
    readers read from, the checks and the counts."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float] = field(default_factory=dict)
    readings: dict = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    memory_peak_bytes: int = 0
    trace: object = None          # trace.TraceSummary of the traced slice


def device_facts(count: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def print_checks(checks: List[Check]) -> None:
    """Each compared number beside its limit, last on standard error."""
    for c in checks:
        rel = ">=" if c.at_least else "<="
        print(f"check {c.name}: {c.value!r} (limit {rel} {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)


def within_limits(checks: dict) -> bool:
    """Whether every number of a ``checks_json`` dict meets its limit."""
    return all(Check(n, c["value"], c["limit"], c["rule"] == "at_least").ok
               for n, c in checks.items())


def checks_json(checks: List[Check]) -> dict:
    return {c.name: {"value": c.value, "limit": c.limit,
                     "rule": "at_least" if c.at_least else "at_most"}
            for c in checks}
