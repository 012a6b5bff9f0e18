"""One run of one cell: ``python benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

The run refuses to start without the cards the cell asks for, builds the
cell's program and traffic from the seed (set-up), measures for
``--seconds`` seconds, reads the per-layer metrics (``--trace 1``) or the
end-to-end ones (``--trace 0``), checks what the timed path produced
against the plain reference, and prints one JSON line last on standard
output, the numbers compared last on standard error."""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Optional

from . import common
from .common import BENCH_DIR, Cell, load_file


class Context:
    """What a driver gets: the cell, the run's settings, and the means to
    build the program and the reference from the seed.

    Not on the command line: ``rate`` replaces an open-loop cell's offered
    rate (the knee sweep, ``tools/sweep_rate.py``); ``control`` puts the
    cell's control in the program's place in the checks that decide
    ``correct``, and keeps the program's own compared numbers in the
    result's readings under ``program`` (``tools/readings.py``, the
    tests)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: Optional[float] = None,
                 rate: Optional[float] = None, control: bool = False,
                 config_overrides: Optional[dict] = None,
                 traffic_overrides: Optional[dict] = None):
        import torch
        self.cell = cell
        if config_overrides:
            cell.config = {**cell.config, **config_overrides}
        if traffic_overrides:
            cell.traffic = {**cell.traffic, **traffic_overrides}
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.t_start = time.time() if t_start is None else t_start
        self.rate, self.control = rate, control
        self.setup_s: Optional[float] = None
        # changes a driver makes to the seed's weights, for the program and
        # the reference alike
        self.state_edits = []
        self.log = lambda msg: print(msg, file=sys.stderr, flush=True)

    # ---- the program ------------------------------------------------------

    def port_config(self):
        """The port's ModelConfig from the configuration file's numbers (f32
        compute on the CPU, where the port runs in f32)."""
        import dataclasses
        from voicecraft_tpu_torch.config import ModelConfig
        mc = ModelConfig.from_dict(self.cfg)
        if self.device.type == "cpu":
            mc = dataclasses.replace(mc, compute_dtype="float32")
        return mc

    def matrix_dtype(self):
        import torch
        return torch.float32 if self.device.type == "cpu" else {
            "bfloat16": torch.bfloat16,
            "float32": torch.float32}[self.cfg["compute_dtype"]]

    def state(self):
        from .weights import make_state
        st = make_state(self.cfg, self.seed, self.device, self.matrix_dtype())
        for edit in self.state_edits:
            edit(st)
        return st

    def build_model(self):
        """The port's inference model with the seed's weights, loaded through
        its public ``load_state_dict``."""
        from voicecraft_tpu_torch.models.voicecraft import VoiceCraft
        model = VoiceCraft(self.port_config(), self.device)
        state = self.state()
        model.load_state_dict(state, strict=True)
        del state
        return model.eval()

    # ---- the reference ----------------------------------------------------

    def reference_module(self):
        """The configuration's plain reference, ``reference/<name>.py``."""
        return load_file(BENCH_DIR / "reference"
                          / f"{self.cfg['reference']}.py", "bench_reference")

    def reference(self, weights: str = "exact", acts: str = "exact"):
        """The plain f32 reference of this configuration, with the seed's
        weights made again (nothing is taken from the program)."""
        mod = self.reference_module()
        mod.exact_f32()
        state = self.state()
        ref = mod.Reference(self.cfg, state, self.device, weights, acts)
        del state
        return ref, mod

    # ---- clocks and memory ------------------------------------------------

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self) -> float:
        self.sync()
        return time.perf_counter()

    def setup_done(self):
        self.sync()
        self.setup_s = time.time() - self.t_start
        self.log(f"set-up done: {self.setup_s:.3f} s")

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self):
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def driver_for(cell: Cell):
    return importlib.import_module(
        f"harness.drivers.{cell.traffic['driver']}")


def read_metric(name: str, result, root: Path = BENCH_DIR
                ) -> Optional[float]:
    """The per-layer metric ``name`` through its reader,
    ``<root>/metrics/<name>.py``; None when it finds nothing to read."""
    mod = load_file(root / "metrics" / f"{name}.py",
                     "bench_metric_" + name.replace(".", "_"))
    return mod.read(result)


def run_cell(ctx: Context):
    """Drive the cell; returns (result line dict, RunResult)."""
    res = driver_for(ctx.cell).run(ctx)
    common.guard_imports("after the window")
    ok = all(c.ok for c in res.checks)
    metrics = {}
    if ctx.trace:
        for m in ctx.cell.per_layer:
            v = read_metric(m["name"], res)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        res.end_to_end["setup_s"] = ctx.setup_s
        for m in ctx.cell.end_to_end:
            v = res.end_to_end.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": ok, "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": {"count": ctx.cell.chips,
                                           "memory_peak_bytes":
                                               res.memory_peak_bytes}}
    if ctx.device.type == "cuda":
        line["device"].update(common.device_facts(ctx.cell.chips))
    if ctx.trace and res.trace is not None:
        line["device"]["busy_s"] = res.trace.busy_s()
        line["device"]["window_s"] = res.trace.window_s
        line["breakdown"] = res.trace.breakdown()
    line["checks"] = common.checks_json(res.checks)
    return line, res


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = parse(argv)
    common.guard_imports("at start")
    import torch
    cell = common.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace),
                  t_start=t_start)
    line, res = run_cell(ctx)
    found = common.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    print(json.dumps(line), flush=True)
    common.print_checks(res.checks)
    return 0
