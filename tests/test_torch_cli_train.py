"""The port's training CLIs (train_torch_cli.py, eval_torch_cli.py,
preprocess_torch_cli.py) on the CPU: the pipeline from preprocessing to TTS
from the trained checkpoint, and the flags they refuse."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from voicecraft_tpu_torch.inference.loader import load_model

REPO = Path(__file__).resolve().parent.parent


def _run(args, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_cpu_pipeline_preprocess_train_eval_tts(tmp_path):
    """preprocess_torch_cli.py over demo.wav and its transcript (random
    codec), train_torch_cli.py, eval_torch_cli.py, then tts_torch_cli.py
    from the trained checkpoint, every step with --device cpu."""
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    (wavs / "demo.wav").write_bytes((REPO / "demo" / "demo.wav").read_bytes())
    (wavs / "demo.txt").write_text("the sound of birds over the river at dawn")
    _run([str(REPO / "preprocess_torch_cli.py"), "--audio-dir", "wavs",
          "--out-dir", "data", "--random-init", "--codec-bins", "128",
          "--text-backend", "grapheme", "--device", "cpu"], tmp_path)
    assert (tmp_path / "data" / "manifest" / "train.txt").read_text() \
        == "0\tdemo\t216\n"
    out = _run([str(REPO / "train_torch_cli.py"), "--preset", "tiny_test",
                "--exp-dir", "exp", "--dataset-dir", "data", "--device", "cpu",
                "--num-steps", "3", "--codebook-weight", "5", "1", "0.5",
                "0.1", "--train-attn", "chunked", "--train-remat", "attn"],
               tmp_path)
    assert "validate: step 4" in out.stderr
    meta = json.loads((tmp_path / "exp" / "meta_latest.json").read_text())
    assert meta["progress"]["step"] == 4
    assert meta["model_config"]["codebook_weight"] == [5.0, 1.0, 0.5, 0.1]
    out = _run([str(REPO / "eval_torch_cli.py"), "--ckpt", "exp/ckpt_latest",
                "--dataset-dir", "data", "--split", "train", "--device",
                "cpu"], tmp_path)
    assert "train: 1 utts" in out.stderr and "loss/token" in out.stderr
    _run([str(REPO / "tts_torch_cli.py"), "--model", "exp/ckpt_latest",
          "--random-init", "--device", "cpu", "--text-backend", "grapheme",
          "--prompt-wav", "wavs/demo.wav", "--prompt-transcript",
          "the sound of birds over the river at dawn", "--target-transcript",
          "the river runs past the mill", "--out", "out.wav"], tmp_path)
    assert (tmp_path / "out.wav").stat().st_size > 44
    # the checkpoint loads for inference in the compute dtype
    cfg, model, phn2num = load_model(str(tmp_path / "exp" / "ckpt_latest"),
                                     device="cpu")
    assert phn2num and not any(p.requires_grad for p in model.parameters())


# what each refusal says: the mesh flags are refused outside a torchrun
# world that fits them (their runs: tests/test_torch_mesh_train.py)
REFUSALS = {"--distributed": "run it under torchrun",
            "--n-model": "need --distributed",
            "--no-zero1": "need --distributed"}


@pytest.mark.parametrize("cli,flag", [
    ("train_torch_cli.py", ["--distributed"]),
    ("train_torch_cli.py", ["--n-model", "2"]),
    ("train_torch_cli.py", ["--no-zero1"])])
def test_cli_refuses_unported_flags(tmp_path, cli, flag):
    base = {"train_torch_cli.py": ["--exp-dir", "e", "--dataset-dir", "d"]}
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, str(REPO / cli), *base[cli], *flag],
                         cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2 and REFUSALS[flag[0]] in out.stderr


def test_tb_without_tensorboard_raises(monkeypatch):
    sys.path.insert(0, str(REPO))
    import train_torch_cli
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(SystemExit, match="tensorboard"):
        train_torch_cli.tensorboard_writer("unused")
