"""The port's recipe twins (recipes/*_torch.sh) on the CPU:
quickstart_cpu_torch.sh (toy corpus -> preprocess -> 20 training steps ->
TTS from the checkpoint) and edit_demo_torch.sh (three edits of the demo)
run end to end with finite wavs, and every flag that e830M_torch.sh,
e830M_ft_torch.sh and e830M_mtp_torch.sh pass is accepted by
train_torch_cli.build_parser(), as are the flags of the JAX scripts they
twin; the measure twins (measure_{all,r5b,r5c}_torch.sh) run the JAX
scripts' commands through the torch CLIs and bench_torch.py."""

import json
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


def _measure_commands(script, tmp_path):
    """The commands that ``script`` (a measure recipe) runs, each as
    [program, args...]: the script runs with a recording ``python`` first
    on the PATH, which logs every command and prints a JSON line (the
    stages' validity check still runs the real interpreter)."""
    bin_dir, log = tmp_path / f"bin_{script}", tmp_path / f"{script}.log"
    bin_dir.mkdir()
    stub = bin_dir / "python"
    stub.write_text(
        "#!/bin/bash\n"
        f'if [ "$1" = "-" ]; then exec {shlex.quote(sys.executable)} "$@"; fi\n'
        f"{shlex.quote(sys.executable)} -c 'import json, sys; "
        "print(json.dumps(sys.argv[1:]))' \"$@\" >> \"$CMD_LOG\"\n"
        "echo '{\"ok\": true}'\n")
    stub.chmod(0o755)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir(exist_ok=True)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
               CMD_LOG=str(log), WORK=str(tmp_path), CKPT=str(ckpt),
               EVAL="eval", MEAS=str(tmp_path / f"meas_{script}"))
    env.pop("DEVICE", None)
    res = subprocess.run(["bash", str(REPO / "recipes" / script)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return [json.loads(ln) for ln in log.read_text().splitlines()]


TWINS = {"bench_torch.py": "bench.py", "quality_torch_cli.py": "quality_cli.py",
         "spec_acceptance_torch_cli.py": "spec_acceptance_cli.py"}


@pytest.mark.parametrize("script", ["measure_all_torch.sh",
                                    "measure_r5b_torch.sh",
                                    "measure_r5c_torch.sh"])
def test_measure_twin_runs_the_jax_scripts_commands(script, tmp_path):
    """Each stage of a measure twin runs the torch twin of the JAX
    script's command with the same arguments, and every command parses
    with its program's parser."""
    sys.path.insert(0, str(REPO))
    import bench_torch
    import quality_torch_cli
    import spec_acceptance_torch_cli
    parsers = {"bench_torch.py": bench_torch.build_parser(),
               "quality_torch_cli.py": quality_torch_cli.build_parser(),
               "spec_acceptance_torch_cli.py":
                   spec_acceptance_torch_cli.build_parser()}
    got = _measure_commands(script, tmp_path)
    want = _measure_commands(script.replace("_torch", ""), tmp_path)
    assert len(got) == len(want) >= 3
    for cmd, jcmd in zip(got, want):
        assert TWINS[cmd[0]] == jcmd[0] and cmd[1:] == jcmd[1:], (cmd, jcmd)
        args = parsers[cmd[0]].parse_args(cmd[1:])
        if cmd[0] != "bench_torch.py":
            assert args.model == str(tmp_path / "ckpt")
    assert "spec_acceptance_torch_cli.py" in {c[0] for c in got}
