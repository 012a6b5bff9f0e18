"""The readings that a cell's correctness limits are set from: the program's
compared numbers and its control's, over many seeds in one process, at the
cell's own sizes and load (a short window).  Each run puts the control in
the program's place in the checks (its ``correct`` then reads false) and
keeps the program's own numbers beside them.  Not part of a benchmark run.

    python benchmark/tools/readings.py --workload tts830e.single \
        --seeds 11 12 13 --seconds 10 [--no-control] [--out FILE]
"""

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(1, os.path.dirname(os.path.dirname(_HERE)))

from harness import common, runner  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", default=None)
    # a fault planted underneath the timed path (harness/faults.py)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    if args.fault:
        from harness.faults import FAULTS
        cfg = common.load_cell(args.workload).config
        obj, name, value = FAULTS[args.fault](cfg["audio_vocab_size"])
        setattr(obj, name, value)
    rows, control = [], not args.no_control
    for seed in args.seeds:
        cell = common.load_cell(args.workload)
        ctx = runner.Context(cell, seed, args.seconds, False, control=control)
        t0 = time.time()
        line, res = runner.run_cell(ctx)
        # under the control, the line's checks are the control's and the
        # program's own are in the readings
        program = res.readings["program"] if control else line["checks"]
        row = {"seed": seed, "fault": args.fault, "correct": line["correct"],
               "program": program,
               "control": line["checks"] if control else None,
               "program_within_limits": common.within_limits(program),
               "requests": res.readings.get("requests"),
               "metrics": line["metrics"], "seconds": time.time() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del ctx, res
        runner.gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    values = lambda side: {n: [r[side][n]["value"] for r in rows]
                           for n in rows[0][side]} if rows[0][side] else None
    summary = {"workload": args.workload, "program": values("program"),
               "control": values("control")}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
