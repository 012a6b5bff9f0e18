"""On the card, at each cell's own size and load (a 10 s window): on three
seeds the control in the program's place makes ``correct`` false, while
the program's own numbers of the same runs meet their limits.  Run on a
card with ``python -m pytest benchmark/tests/test_bench_card.py -q``; it
skips elsewhere."""

import pytest

from harness import common, runner

SPEC = common.load_json(common.REPO_DIR / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size")
    for seed in (3141592653, 2718281828, 1414213562):
        cell = common.load_cell(workload)
        line, res = runner.run_cell(runner.Context(cell, seed, 10.0, False,
                                                   control=True))
        assert line["correct"] is False, line["checks"]
        assert common.within_limits(res.readings["program"]), \
            res.readings["program"]
        del res
        runner.gc.collect()
        torch.cuda.empty_cache()
