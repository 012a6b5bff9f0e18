"""The traffic generator, the seed, and a cell or metric found from added
files alone."""

import json
import shutil

import numpy as np
import pytest

from bench_helpers import tiny_config, tiny_run
from harness import common, runner, traffic as tr
from harness.weights import make_state

CFG = common.load_json(common.BENCH_DIR / "configs"
                       / "giga830M_TTSEnhanced.json")
TRAFFIC = sorted(p.stem for p in (common.BENCH_DIR / "traffic").glob("*.json")
                 if "prompt_frames" in common.load_json(p))


def _closed(t, seed, n):
    gen = tr.closed_loop(t, CFG, seed)
    return [next(gen) for _ in range(n)]


@pytest.mark.parametrize("name", TRAFFIC)
def test_same_seed_same_requests(name):
    t = common.load_json(common.BENCH_DIR / "traffic" / f"{name}.json")
    if "rate_per_s" in t:
        a, b = (tr.open_loop(t, CFG, 5, 20.0) for _ in range(2))
    else:
        a, b = _closed(t, 5, 30), _closed(t, 5, 30)
    for r, s in zip(a, b):
        assert (r.due_s, r.prompt_frames, r.gen, r.phones, r.greedy) == \
            (s.due_s, s.prompt_frames, s.gen, s.phones, s.greedy)
        np.testing.assert_array_equal(r.x, s.x)
        np.testing.assert_array_equal(r.prompt, s.prompt)


@pytest.mark.parametrize("name", TRAFFIC)
def test_seeds_share_the_sizes_not_the_tokens(name):
    """Every seed offers the same work: the same multiset of sizes (and of
    arrival gaps), in another order, with other tokens."""
    t = common.load_json(common.BENCH_DIR / "traffic" / f"{name}.json")
    key = lambda r: (r.prompt_frames, r.gen, r.phones, r.greedy)
    if "rate_per_s" in t:
        a, b = tr.open_loop(t, CFG, 5, 30.0), tr.open_loop(t, CFG, 6, 30.0)
        gaps = lambda rs: sorted(np.round(np.diff([r.due_s for r in rs]), 9))
        assert len(a) == len(b) == round(t["rate_per_s"] * 30.0)
        assert a[-1].due_s < 30.0 and b[-1].due_s < 30.0
        allowed = set(np.round(tr.exp_gaps(t["rate_per_s"], 30.0), 9))
        assert set(gaps(a)) <= allowed and set(gaps(b)) <= allowed
    else:
        n = len(tr.size_set(t))
        a, b = _closed(t, 5, n), _closed(t, 6, n)
    assert sorted(map(key, a)) == sorted(map(key, b))
    assert [key(r) for r in a] != [key(r) for r in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)


def test_training_dataset_repeats_and_keeps_its_sizes():
    from harness.drivers.train_steps import utterances
    t = common.load_json(common.BENCH_DIR / "traffic" / "train_recipe.json")
    t = {**t, "utterances": 40}
    a, b, c = (utterances(t, CFG, s) for s in (5, 5, 6))
    assert a == b
    size = lambda items: sorted((len(i["codes"][0]), len(i["phones"]))
                                for i in items)
    assert size(a) == size(c)
    assert a[0]["codes"] != c[0]["codes"]
    assert min(size(a))[0] == t["frames"][0] and max(size(a))[0] == t["frames"][1]


def test_large_seed_weights_repeat():
    cfg = tiny_config(CFG)
    big = 2 ** 31 + 12345
    s1, s2 = (make_state(cfg, big, "cpu", __import__("torch").float32)
              for _ in range(2))
    s3 = make_state(cfg, big + 1, "cpu", __import__("torch").float32)
    assert s1.keys() == s2.keys()
    for k in s1:
        assert bool((s1[k] == s2[k]).all()), k
    assert not bool((s1["decoder.layers.0.wq"] == s3["decoder.layers.0.wq"]).all())


def test_new_cell_from_added_files(tmp_path):
    """A cell added as data only (a BENCHMARK.json entry and a traffic
    file) is found by name and runs with the existing driver."""
    spec = common.load_json(common.REPO_DIR / "BENCHMARK.json")
    for d in ("configs", "architectures"):
        shutil.copytree(common.BENCH_DIR / d, tmp_path / "benchmark" / d)
    (tmp_path / "benchmark" / "traffic").mkdir()
    t = common.load_json(common.BENCH_DIR / "traffic" / "tts_closed.json")
    t["prompt_frames"] = [25]
    (tmp_path / "benchmark" / "traffic" / "tts_closed_short.json").write_text(
        json.dumps(t))
    spec["workloads"].append({"name": "tts830e.short", "config":
                              "giga830M_TTSEnhanced", "traffic":
                              "tts_closed_short", "chips": 1, "why": "x"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tts830e.single" in m.get("workloads", []):
            m["workloads"].append("tts830e.short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = common.load_cell("tts830e.short", tmp_path / "BENCHMARK.json")
    assert cell.traffic["prompt_frames"] == [25]
    assert {m["name"] for m in cell.end_to_end} >= {"audio_s_per_s", "setup_s"}
    line, _ = tiny_run("tts830e.short", bench_path=tmp_path / "BENCHMARK.json")
    assert line["correct"] is True
    assert line["metrics"]["audio_s_per_s"]["value"] > 0


def test_new_metric_from_an_added_file(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "requests.single.py").write_text(
        "def read(res):\n    return res.readings.get('requests')\n")
    res = common.RunResult(attempted=3, failed=0, readings={"requests": 3})
    assert runner.read_metric("requests.single", res, tmp_path) == 3
    assert runner.read_metric("mfu.single", res) is None
