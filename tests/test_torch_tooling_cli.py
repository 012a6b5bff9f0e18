"""The port's tooling CLIs (quality_torch_cli.py, spec_acceptance_torch_cli.py)
on the CPU, fed by one tiny pipeline: recipes/make_spec_corpus.py ->
preprocess_torch_cli.py (random 128-bin codec, grapheme backend) ->
train_torch_cli.py (tiny_test_mtp, 3 MTP head groups), on utterances of 3-5
words (0.6 s prompts).  Each CLI runs every mode at --n 1 and reports the
JSON of its JAX counterpart (tests/test_quality_cli.py, tests/
test_spec_acceptance_cli.py): the keys, and the bit-exact fields true (greedy speculative and streaming output equal the
plain decode exactly in f32)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import quality_torch_cli  # noqa: E402
import spec_acceptance_torch_cli  # noqa: E402
from tests.test_torch_spec import one_torch_thread  # noqa: E402,F401


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tooling")
    _run([str(REPO / "recipes" / "make_spec_corpus.py"), "corpus", "--train",
          "4", "--eval", "2", "--min-words", "3", "--max-words", "5"], tmp)
    _run([str(REPO / "preprocess_torch_cli.py"), "--audio-dir",
          "corpus/train", "--out-dir", "data", "--random-init",
          "--codec-bins", "128", "--text-backend", "grapheme", "--device",
          "cpu"], tmp)
    _run([str(REPO / "train_torch_cli.py"), "--preset", "tiny_test_mtp",
          "--exp-dir", "exp", "--dataset-dir", "data", "--device", "cpu",
          "--num-steps", "3", "--max-num-tokens", "2000", "--num-buckets",
          "2", "--val-every-n-steps", "1000"], tmp)
    return tmp


def test_quality_cli_every_mode(pipeline, capsys):
    out = quality_torch_cli.main([
        "--model", str(pipeline / "exp" / "ckpt_latest"),
        "--eval-dir", str(pipeline / "corpus" / "eval"),
        "--codec-bins", "128", "--n", "1", "--prompt-sec", "0.6",
        "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(out))
    assert out["ref"] == "resynth" and out["n"] == 1 and out["tau"] == 4
    modes = out["modes"]
    assert set(modes) == set(quality_torch_cli.ALL_MODES)
    assert modes["spec"]["bit_exact_vs_plain"] is True
    assert modes["stream"]["bit_exact_vs_plain"] is True
    assert modes["edit_spec"]["bit_exact_vs_edit"] is True
    for m in ("resynth", "plain", "spec", "stream", "fp8", "sampled",
              "stochastic"):
        assert set(modes[m]) >= {"log_mel_dist_mean", "mcd_mean",
                                 "duration_ratio_mean", "seconds"}, m
        assert modes[m]["duration_ratio_mean"] > 0, m
    for m in quality_torch_cli.EDIT_MODES:
        assert modes[m]["span_duration_ratio_mean"] > 0, m
    assert out["edit_span"] == [0.4, 0.7]


def test_spec_acceptance_cli_tts(pipeline):
    out = spec_acceptance_torch_cli.main([
        "--model", str(pipeline / "exp" / "ckpt_latest"),
        "--eval-dir", str(pipeline / "corpus" / "eval"),
        "--codec-bins", "128", "--taus", "2", "4", "--n", "1", "--lanes",
        "2", "--engine-requests", "2", "--prompt-sec", "0.6", "--device",
        "cpu"])
    assert out["n_mtp"] == 3 and out["spec_sampling"] == "exact"
    assert out["single"]["plain_tokens_per_sec"] > 0
    assert out["serving"]["plain_frames_per_sec"] > 0
    for tau in (2, 4):
        assert 1.0 <= out["single"][tau]["tokens_per_pass"] <= tau + 1e-6
        assert 0.0 < (out["serving"][tau]["tokens_per_pass_per_lane"]
                      <= tau + 1e-6)
        assert out["engine"][tau]["burst"] == 4 * tau
        assert out["engine"][f"plain_frames_per_sec_burst{4 * tau}"] > 0
        for row in ("single", "serving", "engine"):
            assert out[row][tau]["speedup_vs_plain"] > 0, row


def test_spec_acceptance_cli_edit(pipeline):
    out = spec_acceptance_torch_cli.main([
        "--model", str(pipeline / "exp" / "ckpt_latest"),
        "--eval-dir", str(pipeline / "corpus" / "eval"),
        "--codec-bins", "128", "--taus", "2", "--n", "2", "--lanes", "2",
        "--edit", "--device", "cpu"])
    edit = out["edit"]
    assert edit["span"] == [0.4, 0.7] and edit["n_items"] == 2
    for name, lanes in (("edit_single", 1), ("edit_serving", 2)):
        assert edit[name]["lanes"] == lanes
        assert edit[name]["plain_frames_per_sec"] > 0
        row = edit[name][2]
        # a lane that finishes early lowers the wave's mean below 1
        assert 0.0 < row["tokens_per_pass_per_lane"] <= 2 + 1e-6
        assert row["frames_per_sec"] > 0 and row["speedup_vs_plain"] > 0


def test_spec_acceptance_cli_needs_mtp_heads(pipeline, tmp_path):
    """The pipeline's checkpoint exported to a .pth bundle (which drops the
    MTP heads, keeping the vocabulary) is refused, as the JAX CLI asserts."""
    import export_torch_cli
    out = str(tmp_path / "no_mtp.pth")
    export_torch_cli.main(["--ckpt", str(pipeline / "exp" / "ckpt_latest"),
                           "--out", out, "--device", "cpu"])
    with pytest.raises(SystemExit, match="no MTP heads"):
        spec_acceptance_torch_cli.main([
            "--model", out, "--eval-dir", str(pipeline / "corpus" / "eval"),
            "--codec-bins", "128", "--device", "cpu"])
