"""recipes/spec_acceptance_torch.sh on the CPU at PRESET=tiny_test with
tiny overrides, its joint branch: one training run with three MTP head
groups (the TWO_STAGE branch: test_torch_recipe_spec_two_stage.py).  It
ends with an acceptance.json whose single, serving and engine sections
give tokens a pass and frames/s for every tau the heads allow."""

import json
import os
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TINY = dict(DEVICE="cpu", PRESET="tiny_test", BINS="128", STEPS="2",
            N_TRAIN="4", N_EVAL="1", N_SINGLE="1", LANES="1", TOKENS="2000",
            MTP_STEPS="2", OMP_NUM_THREADS="1")


def run_recipe(work, **env):
    res = subprocess.run(
        ["bash", str(REPO / "recipes" / "spec_acceptance_torch.sh")],
        cwd=REPO, env=dict(os.environ, WORK=str(work), **TINY, **env),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return json.loads((work / "acceptance.json").read_text())


def check_acceptance(acc, taus):
    """The sections of spec_acceptance_torch_cli.py's JSON, for ``taus``."""
    assert acc["n_mtp"] == taus[-1] - 1
    single, serving, engine = acc["single"], acc["serving"], acc["engine"]
    assert single["plain_tokens_per_sec"] > 0
    assert serving["plain_frames_per_sec"] > 0
    for tau in taus:
        t = str(tau)
        assert 1.0 <= single[t]["tokens_per_pass"] <= tau
        assert 0 < serving[t]["tokens_per_pass_per_lane"] <= tau
        assert 0 < engine[t]["frames_per_pass"] <= tau
        for rate in (single[t]["tokens_per_sec"],
                     serving[t]["frames_per_sec"],
                     engine[t]["frames_per_sec"]):
            assert rate > 0
    assert str(taus[-1] * 2) not in single         # beyond the heads


def test_joint_branch(tmp_path):
    check_acceptance(run_recipe(tmp_path, MTP="3"), [2, 4])
