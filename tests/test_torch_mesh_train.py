"""Training and serving over a mesh of processes from the port's entry
points, on the CPU at tiny_test in f32: a 2-rank Trainer(mesh=2 x 1)
(tests/torch_mesh_helpers.py, spawned once; modelled on
tests/test_distributed.py): equal losses on both ranks, disjoint data, one
checkpoint, which one process reloads (and resumes from) equal to the
gathered parameters; then train_torch_cli.py --distributed --n-model 1 and
serve_torch_cli.py --mesh 2x1, each under torch.distributed.run with 2
gloo processes, one /tts through the server."""

import base64
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from voicecraft_tpu_torch.config import TrainConfig
from voicecraft_tpu_torch.inference.loader import CKPT_MODEL, load_model
from voicecraft_tpu_torch.training.trainer import Trainer
from torch_mesh_helpers import Spawned, tiny, trainer_worker
from torch_train_helpers import make_dataset

REPO = Path(__file__).resolve().parent.parent
STEPS = 3
TIMEOUT = 180


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_dataset(root, tiny())
    return root


@pytest.fixture(scope="module")
def trained(data_root, tmp_path_factory):
    exp = str(tmp_path_factory.mktemp("exp"))
    return exp, Spawned(2, trainer_worker, data_root, exp, STEPS).results()


def test_ranks_agree_on_the_global_loss(trained):
    _, ((l0, _, p0), (l1, _, p1)) = trained
    assert len(l0) == STEPS and l0 == l1 and np.isfinite(l0).all()
    assert all(np.array_equal(p0[k], p1[k]) for k in p0)


def test_data_rows_read_disjoint_batches(trained):
    _, ((_, ids0, _), (_, ids1, _)) = trained
    assert ids0 and ids1 and not set(ids0) & set(ids1)


def test_one_checkpoint_reloads_in_one_process(trained, data_root, tmp_path):
    """Rank 0 wrote one checkpoint of the gathered state; one process loads
    it for inference and resumes a Trainer from it."""
    exp, ((_, _, params), _) = trained
    # one writer: no temporary or leftover directory, no per-rank copy
    names = sorted(os.listdir(exp))
    assert names == ["ckpt_best", "ckpt_latest", "meta_best.json",
                     "meta_latest.json", "vocab.txt"], names
    state = torch.load(os.path.join(exp, "ckpt_latest", CKPT_MODEL),
                       weights_only=True)
    assert all(np.array_equal(state[k].numpy(), v) for k, v in params.items())
    _, model, _ = load_model(os.path.join(exp, "ckpt_latest"), device="cpu")
    assert model.decoder.nhead == tiny().nhead
    resumed = Path(tmp_path) / "resume"
    resumed.mkdir()
    os.symlink(os.path.join(exp, "ckpt_latest"), resumed / "ckpt_latest")
    tcfg = TrainConfig(dataset_dir=data_root, exp_dir=str(resumed),
                       max_num_tokens=1200, num_buckets=3, num_steps=STEPS,
                       audio_min_length=2.0, audio_max_length=8.0,
                       text_min_length=2, lr=0.02, seed=1)
    tr = Trainer(tiny(), tcfg, device="cpu")
    assert tr.progress["step"] == STEPS + 1
    got = tr.model.state_dict()
    assert all(np.array_equal(got[k].numpy(), v) for k, v in params.items())


def _torchrun(args, cwd, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", *args], dict(cwd=cwd, env=env, **kw)


def test_train_cli_distributed(data_root, tmp_path):
    cmd, kw = _torchrun([str(REPO / "train_torch_cli.py"), "--distributed",
                         "--n-model", "1", "--device", "cpu", "--preset",
                         "tiny_test", "--exp-dir", "exp", "--dataset-dir",
                         data_root, "--num-steps", "2",
                         "--max-num-tokens", "1200"], tmp_path)
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=TIMEOUT, **kw)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh: data=2 model=1" in out.stderr
    meta = json.loads((tmp_path / "exp" / "meta_latest.json").read_text())
    assert meta["progress"]["step"] == 3 and meta["train_config"]["zero1"]
    assert (tmp_path / "exp" / "ckpt_latest" / CKPT_MODEL).is_file()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_mesh_answers_tts(tmp_path):
    port = _free_port()
    cmd, kw = _torchrun([str(REPO / "serve_torch_cli.py"), "--mesh", "2x1",
                         "--device", "cpu", "--model", "tiny_test",
                         "--random-init", "--text-backend", "grapheme",
                         "--port", str(port)], REPO)
    logf = tmp_path / "server.log"
    with open(logf, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True, **kw)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + TIMEOUT
        while True:
            assert proc.poll() is None, logf.read_text()[-3000:]
            try:
                urllib.request.urlopen(base + "/healthz", timeout=2)
                break
            except OSError:
                assert time.time() < deadline, "the server did not come up"
                time.sleep(0.5)
        payload = {"prompt_wav_b64": base64.b64encode(
                       (REPO / "demo" / "demo.wav").read_bytes()).decode(),
                   "prompt_transcript": "the sound of birds",
                   "prompt_end_sec": 2.0, "target_transcript": "the mill",
                   "top_k": 15, "silence_tokens": [5, 7], "seed": 1}
        req = urllib.request.Request(base + "/tts",
                                     data=json.dumps(payload).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            res = json.loads(r.read())
        assert res["gen_sec"] > 0 and res["wav_b64"]
        assert "serving over a (2 data x 1 model) mesh" in logf.read_text()
    finally:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
