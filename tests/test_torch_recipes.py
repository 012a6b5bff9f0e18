"""The port's recipe twins (recipes/*_torch.sh) on the CPU:
quickstart_cpu_torch.sh (toy corpus -> preprocess -> 20 training steps ->
TTS from the checkpoint) and edit_demo_torch.sh (three edits of the demo)
run end to end with finite wavs, and every flag that e830M_torch.sh,
e830M_ft_torch.sh and e830M_mtp_torch.sh pass is accepted by
train_torch_cli.build_parser(), as are the flags of the JAX scripts they
twin."""

import os
import re
import shlex
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from voicecraft_tpu_torch.utils.audio import read_wav

REPO = Path(__file__).resolve().parents[1]


def _bash(script, *args, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(["bash", str(REPO / "recipes" / script), *args],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return res.stdout


def _finite_wav(path, min_sec):
    wav, sr = read_wav(str(path))
    assert sr == 16000 and wav.shape[1] >= min_sec * sr
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0


def test_quickstart_runs_end_to_end(tmp_path):
    out = _bash("quickstart_cpu_torch.sh", str(tmp_path / "work"))
    assert "quickstart OK" in out
    work = tmp_path / "work"
    assert (work / "exp" / "ckpt_latest" / "model.pt").exists()
    assert (work / "data" / "manifest" / "train.txt").exists()
    _finite_wav(work / "out.wav", 2.0)       # the 2 s prompt and more


def test_edit_demo_runs_end_to_end(tmp_path):
    out = _bash("edit_demo_torch.sh", str(tmp_path / "edits"))
    assert "edit demo OK" in out
    for name in ("substitution", "insertion", "deletion"):
        _finite_wav(tmp_path / "edits" / f"{name}.wav", 1.0)


def _train_argv(script):
    """The train CLI's arguments in ``script`` (its variables given)."""
    text = (REPO / "recipes" / script).read_text()
    cmd = text[text.index("python train"):].split("\n#")[0]
    cmd = cmd.replace("\\\n", " ")
    argv = shlex.split(cmd.replace('"$EXP"', "exp").replace(
        '"$DATA"', "data").replace('"$BASE"', "base"))
    return argv[1], argv[2:]


@pytest.mark.parametrize("script", ["e830M_torch.sh", "e830M_ft_torch.sh",
                                    "e830M_mtp_torch.sh"])
def test_e830m_flags_exist_in_train_torch_cli(script):
    sys.path.insert(0, str(REPO))
    import train_torch_cli
    cli, argv = _train_argv(script)
    jcli, jargv = _train_argv(script.replace("_torch", ""))
    assert (cli, jcli) == ("train_torch_cli.py", "train_cli.py")
    assert argv == jargv            # the same overrides as the JAX script
    args = train_torch_cli.build_parser().parse_args(argv)
    assert args.preset == "giga830M" and args.tb
    flags = {a for a in argv if a.startswith("--")}
    assert len(flags) >= 12 and all(
        re.fullmatch(r"--[a-z0-9-]+", f) for f in flags)
