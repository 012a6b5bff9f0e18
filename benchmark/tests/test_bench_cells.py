"""Each cell end to end at tiny_test size on the CPU: the run's own code,
its result line, its check; and that the check fails when the timed path
is broken underneath or replaced by its control."""

import json

import pytest

from bench_helpers import TINY_LIMITS, tiny_config, tiny_run
from harness import common
from harness.faults import FAULTS

SPEC = common.load_json(common.REPO_DIR / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
DRIVER = {w["name"]: common.load_cell(w["name"]).traffic["driver"]
          for w in SPEC["workloads"]}
SERVING = [c for c in CELLS if DRIVER[c] != "train_steps"]
TRAINING = [c for c in CELLS if DRIVER[c] == "train_steps"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(workload, trace):
    line, res = tiny_run(workload, trace=trace)
    json.dumps(line)
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 2 and line["failed"] == 0
    cell = common.load_cell(workload)
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        for m in line["metrics"].values():
            assert m["value"] > 0
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"] if c["rule"] == "at_most" \
            else c["value"] >= c["limit"], name


def _plant(monkeypatch, fault, workload):
    vocab = tiny_config(common.load_cell(workload).config)["audio_vocab_size"]
    monkeypatch.setattr(*FAULTS[fault](vocab))


@pytest.mark.parametrize("workload", SERVING)
def test_altered_token_is_not_correct(workload, monkeypatch):
    _plant(monkeypatch, "altered_token", workload)
    line, _ = tiny_run(workload)
    assert line["correct"] is False
    assert line["checks"]["logit_gap"]["value"] > TINY_LIMITS["logit_gap"]


@pytest.mark.parametrize("workload", SERVING)
def test_control_reads_above_the_limit(workload):
    """The reference in the next precision down, in the program's place,
    fails the limit that the program meets: ``correct`` comes out false."""
    line, res = tiny_run(workload, control=True)
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["logit_gap"]["value"] > TINY_LIMITS["logit_gap"]
    assert common.within_limits(res.readings["program"]), res.readings


@pytest.mark.parametrize("workload", TRAINING)
def test_training_control_fails_a_number(workload):
    line, res = tiny_run(workload, control=True)
    assert line["correct"] is False, line["checks"]
    assert common.within_limits(res.readings["program"]), res.readings


@pytest.mark.parametrize("workload", TRAINING)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_training_faults_are_not_correct(workload, fault, monkeypatch):
    _plant(monkeypatch, fault, workload)
    line, _ = tiny_run(workload)
    assert line["correct"] is False, line["checks"]
