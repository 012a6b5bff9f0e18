"""The knee of an open-loop cell: the cell at each offered rate, one run
each, in one process, and whether the backlog grew.  Not part of a
benchmark run; its readings set the rate in the cell's traffic file.

    python benchmark/tools/sweep_rate.py --workload tts830e.stream32 \
        --rates 2 2.5 3 3.5 4 --seconds 40 --seed 7
"""

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(1, os.path.dirname(os.path.dirname(_HERE)))

from harness import common, runner  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    for rate in args.rates:
        cell = common.load_cell(args.workload)
        ctx = runner.Context(cell, args.seed, args.seconds, False, rate=rate)
        line, res = runner.run_cell(ctx)
        r = res.readings
        # a growing backlog drains long after the window and its last
        # requests wait far longer than its first
        print(json.dumps({
            "rate": rate, "correct": line["correct"],
            "requests": r["requests"], "drained_s": r["drained_s"],
            "drain_over_window": r["drained_s"] / args.seconds,
            "served_audio_s_per_s": r["served_audio_s_per_s"],
            "lane_occupancy": r["lane_occupancy"],
            "first_wait_s_by_third": r.get("first_wait_by_third"),
            "metrics": line["metrics"]}), flush=True)
        del ctx, res
        runner.gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
