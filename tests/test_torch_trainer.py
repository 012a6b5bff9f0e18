"""The port's Trainer (voicecraft_tpu_torch/training/trainer.py) against
the JAX package, in f32 on the CPU at tiny_test width: the loss trajectory
(rel 1e-5) and validation score (rel 1e-5) of JAX's step and forward_train
over the same collated batches, bit-identical resume, early stop, the
tensorboard tags and MTP-only training.  The CLIs are in
test_torch_cli_train.py."""

import dataclasses
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import TrainConfig as JaxTrainConfig
from voicecraft_tpu.data import manifest as jman
from voicecraft_tpu.models.voicecraft import forward_train as jax_forward_train
from voicecraft_tpu.training.optim import eden_schedule, scaled_adam
from voicecraft_tpu.training.step import make_train_step as jax_make_step
from voicecraft_tpu.training.trainer import _pad_batch_full
from voicecraft_tpu_torch.config import TrainConfig
from voicecraft_tpu_torch.inference.loader import CKPT_MODEL
from voicecraft_tpu_torch.training.trainer import Trainer
from voicecraft_tpu_torch.utils.convert import from_jax_params
from tests.test_torch_spec import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_train_helpers import configs, jax_params, make_dataset


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_dataset(root, configs()[1])
    return root


def _tcfg(root, exp, **kw):
    kw = {**dict(dataset_dir=root, exp_dir=str(exp), max_num_tokens=1200,
                 num_buckets=3, num_steps=14, audio_min_length=2.0,
                 audio_max_length=8.0, text_min_length=2,
                 val_every_n_steps=100, print_every_n_steps=5,
                 tb_write_every_n_steps=1000, lr=0.02, seed=1), **kw}
    return JaxTrainConfig(**kw), TrainConfig(**kw)


def _write_checkpoint(exp: Path, tag: str, state: dict, mcfg) -> str:
    """A checkpoint directory of the port's trainer holding ``state``."""
    ckpt = exp / f"ckpt_{tag}"
    ckpt.mkdir(parents=True)
    torch.save(state, ckpt / CKPT_MODEL)
    (exp / f"meta_{tag}.json").write_text(json.dumps(
        {"model_config": dataclasses.asdict(mcfg)}))
    return str(ckpt)


def _recording(trainer: Trainer) -> list:
    losses = []
    step_fn = trainer.step_fn

    def step(batch, seed):
        m = step_fn(batch, seed)
        losses.append(m["loss"].item())
        return m
    trainer.step_fn = step
    return losses


def _params(trainer: Trainer) -> dict:
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


def test_resume_is_bit_identical(data_root, tmp_path):
    """2 steps, a save, a new Trainer that resumes for 2 more: the
    parameters of 4 straight steps, bit for bit."""
    _, mcfg = configs()
    mcfg = dataclasses.replace(mcfg, trm_dropout=0.1, train_attn="chunked",
                               train_remat="attn")
    _, t1 = _tcfg(data_root, tmp_path / "split")
    Trainer(mcfg, t1, device="cpu").train(max_steps=2)
    # the first validation is the best: ckpt_best links ckpt_latest's files
    exp = tmp_path / "split"
    assert os.path.samefile(exp / "ckpt_best" / CKPT_MODEL,
                            exp / "ckpt_latest" / CKPT_MODEL)
    resumed = Trainer(mcfg, t1, device="cpu")
    assert resumed.progress["step"] == 3 and resumed.optimizer.count == 2
    resumed.train(max_steps=4)
    _, t2 = _tcfg(data_root, tmp_path / "straight")
    straight = Trainer(mcfg, t2, device="cpu")
    straight.train(max_steps=4)
    a, b = _params(resumed), _params(straight)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert resumed.progress["step"] == straight.progress["step"] == 5


@pytest.mark.parametrize("cut", ["writing-tmp", "between-renames",
                                 "before-delete"])
def test_resume_after_a_cut_save(data_root, tmp_path, cut):
    """A save cut at any point leaves a whole checkpoint that a new Trainer
    resumes from: cut while the new .tmp is written (ckpt_latest stands),
    between the renames (only the whole .tmp and the .old), or before the
    .old is deleted."""
    _, tt = _tcfg(data_root, tmp_path / "exp")
    tr = Trainer(configs()[1], tt, device="cpu")
    tr.train(max_steps=2)
    want = _params(tr)
    latest = tmp_path / "exp" / "ckpt_latest"
    tmp, old = Path(str(latest) + ".tmp"), Path(str(latest) + ".old")
    if cut == "writing-tmp":
        tmp.mkdir()
        (tmp / CKPT_MODEL).write_bytes(b"partial")
    elif cut == "between-renames":
        os.rename(latest, tmp)
        (old / "stale").mkdir(parents=True)
    else:
        shutil.copytree(latest, old)
    resumed = Trainer(configs()[1], tt, device="cpu")
    assert resumed.progress["step"] == 3 and resumed.optimizer.count == 2
    got = _params(resumed)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    resumed.save("latest")
    assert latest.is_dir() and not tmp.exists() and not old.exists()


def test_early_stop_fires(data_root, tmp_path):
    """With a threshold no validation can beat, the run stops after
    early_stop_step steps of validations without improvement."""
    _, tt = _tcfg(data_root, tmp_path / "exp", early_stop_threshold=1e9,
                  early_stop_step=2, val_every_n_steps=1, num_steps=20)
    tr = Trainer(configs()[1], tt, device="cpu")
    tr.train()
    assert tr.progress["step"] == 4           # validations at steps 1, 2, 3
    assert len(tr.progress["history"]) == 4   # the last one after the loop


def test_train_mtp_only_freezes_the_base(data_root, tmp_path):
    _, mcfg = configs(3)
    _, tt = _tcfg(data_root, tmp_path / "exp")
    tr = Trainer(mcfg, tt, train_mtp_only=True, device="cpu")
    before = _params(tr)
    tr.train(max_steps=2)
    after = _params(tr)
    for name in before:
        same = torch.equal(before[name], after[name])
        assert same != name.startswith("mtp_heads."), name
    with pytest.raises(ValueError, match="n_mtp"):
        Trainer(configs()[1], tt, train_mtp_only=True, device="cpu")


def test_mesh_and_multi_process_are_refused(data_root, tmp_path,
                                            monkeypatch):
    """A mesh must be a parallel.mesh.Mesh, and a multi-process run trains
    over one (the mesh runs themselves: tests/test_torch_mesh_train.py)."""
    _, tt = _tcfg(data_root, tmp_path / "exp")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        Trainer(configs()[1], tt, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="trains over a mesh"):
        Trainer(configs()[1], tt, device="cpu")


def test_init_from_fresh_initialises_missing_mtp_heads(data_root, tmp_path):
    """A checkpoint without MTP heads into a model with them: the base
    weights are the checkpoint's, the heads freshly initialised; a
    checkpoint that does not fit is refused."""
    jcfg, base_cfg = configs()
    state = from_jax_params(jax.tree.map(np.asarray, jax_params(jcfg)), base_cfg)
    init = _write_checkpoint(tmp_path / "init", "base", state, base_cfg)
    _, tt = _tcfg(data_root, tmp_path / "exp")
    tr = Trainer(configs(3)[1], tt, init_from=init, device="cpu")
    got = tr.model.state_dict()
    for name, want in state.items():
        assert torch.equal(got[name], want), name
    assert any(n.startswith("mtp_heads.") for n in got)
    wide = dataclasses.replace(base_cfg, d_model=128, audio_embedding_dim=128)
    _, t2 = _tcfg(data_root, tmp_path / "exp2")
    with pytest.raises((ValueError, RuntimeError)):
        Trainer(wide, t2, init_from=init, device="cpu")


def test_adamw_trainer_steps(data_root, tmp_path):
    """optimizer_name other than ScaledAdam trains with AdamW on the
    normalised loss, its state saved and resumed."""
    _, tt = _tcfg(data_root, tmp_path / "exp", optimizer_name="AdamW")
    tr = Trainer(configs()[1], tt, device="cpu")
    before = _params(tr)
    losses = _recording(tr)
    tr.train(max_steps=2)
    assert len(losses) == 2 and all(np.isfinite(losses))
    # lr(0) of the linear warmup is 0: the first update moves nothing
    after = _params(tr)
    assert any(not torch.equal(before[n], after[n]) for n in before)
    resumed = Trainer(configs()[1], tt, device="cpu")
    assert resumed.optimizer.count == 2


def test_producer_failure_reaches_the_main_thread(tmp_path):
    """A collate that raises in the prefetch thread (a code past the
    model's vocabulary) stops train() with the error."""
    _, mcfg = configs()
    root = str(tmp_path / "data")
    items = make_dataset(root, mcfg, n_items=6)
    codes = tmp_path / "data" / "encodec_16khz_4codebooks" / f"{items[0]['id']}.txt"
    codes.write_text(codes.read_text().replace(" ", " 999 ", 1))
    _, tt = _tcfg(root, tmp_path / "exp")
    tr = Trainer(mcfg, tt, device="cpu")
    with pytest.raises(RuntimeError, match="producer") as info:
        tr.train(max_steps=8)
    assert isinstance(info.value.__cause__, ValueError)


def test_profiler_and_meters(tmp_path):
    """torch.profiler traces of a step window and of a region, written as
    Chrome traces (the trainer keeps no wall meters: its log line reads
    each step's own times)."""
    from voicecraft_tpu_torch.utils.profiling import StepProfiler, device_trace
    prof = StepProfiler(str(tmp_path / "steps"), start=1, stop=2)
    for step in range(4):
        prof.step(step)
        torch.ones(8, 8) @ torch.ones(8, 8)
    prof.close()
    with device_trace(str(tmp_path / "region")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    for d in ("steps", "region"):
        traces = list((tmp_path / d).glob("trace_*.json"))
        assert len(traces) == 1 and "aten::" in traces[0].read_text()


def test_train_losses_match_jax_step_loop(data_root, tmp_path):
    """Trainer.train(max_steps=4) from the JAX package's weights (init_from
    a checkpoint of them): each step's loss equals a loop of JAX's
    make_train_step over the batches the trainer draws."""
    jcfg, tcfg_model = configs()
    params = jax_params(jcfg)
    init = _write_checkpoint(
        tmp_path / "init", "jax",
        from_jax_params(jax.tree.map(np.asarray, params), tcfg_model),
        tcfg_model)
    jt, tt = _tcfg(data_root, tmp_path / "exp")
    tr = Trainer(tcfg_model, tt, init_from=init, device="cpu")
    losses = _recording(tr)
    tr.train(max_steps=4)
    assert len(losses) == 4

    tx = scaled_adam(lr=eden_schedule(jt.lr, jt.reduce_lr_start_step,
                                      jt.reduce_lr_start_epoch,
                                      jt.num_steps * jt.warmup_fraction,
                                      jt.pseudo_epoch_size),
                     betas=(0.9, 0.95), clipping_scale=2.0,
                     clipping_update_period=jt.clipping_update_period)
    jstep = jax_make_step(jcfg, tx)
    ds = jman.ManifestDataset(jcfg, jt, "train")
    jp = jax.tree.map(jnp.copy, params)
    js = tx.init(jp)
    batches = [jman.collate_train(ds, idxs, np.random.default_rng((1, 0, bi, 0)))
               for bi, idxs in enumerate(tr.batcher.epoch_batches(0)[:4])]
    # one shape for every batch (fully masked rows and columns add nothing),
    # so that JAX compiles its step once
    dims = [max(b.x.shape[0] for b in batches), jt.text_max_length,
            max(b.y_tokens.shape[2] for b in batches)]
    want = []
    for bi, batch in enumerate(batches):
        jp, js, m = jstep(jp, js, _pad_batch_full(batch, jcfg, *dims),
                          jax.random.PRNGKey(bi))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want, rtol=1e-5)


def test_validate_matches_jax_forward_sums(data_root, tmp_path):
    jcfg, mcfg = configs()
    params = jax_params(jcfg, seed=3)
    jt, tt = _tcfg(data_root, tmp_path / "exp")
    tr = Trainer(mcfg, tt, device="cpu")
    tr.model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                             mcfg))
    score = tr.validate()
    ds = jman.ManifestDataset(jcfg, jt, "validation")
    loss = ntok = 0.0
    for bi, idxs in enumerate(tr.valid_batcher.epoch_batches(0)[:50]):
        batch = jman.collate_train(ds, idxs,
                                   np.random.default_rng((1, 10 ** 6, bi, 0)))
        out = jax_forward_train(params, jcfg, batch, rng=None, remat=False)
        loss += float(out["loss"])
        ntok += float(out["effective_ntoken"])
    assert ntok > 0
    np.testing.assert_allclose(score, loss / ntok, rtol=1e-5)


class FakeTB:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, float(value)))


def test_tensorboard_tags_match_jax(data_root, tmp_path):
    """The same tags at the same steps as the JAX trainer's, MTP included;
    per-codebook accuracies average to the aggregate."""
    from voicecraft_tpu.training.trainer import Trainer as JaxTrainer
    jcfg, mcfg = configs(2)
    jt, tt = _tcfg(data_root, tmp_path / "port", num_steps=3,
                   val_every_n_steps=2, tb_write_every_n_steps=1)
    got, want = FakeTB(), FakeTB()
    Trainer(mcfg, tt, tb_writer=got, device="cpu").train()
    JaxTrainer(jcfg, dataclasses.replace(jt, exp_dir=str(tmp_path / "jax")),
               tb_writer=want).train()
    assert sorted(got.scalars) == sorted(want.scalars)
    for tag, vals in want.scalars.items():
        assert [s for s, _ in got.scalars[tag]] == [s for s, _ in vals], tag
    acc = dict(got.scalars["train/top10acc"])
    for step, v in acc.items():
        cbs = [dict(got.scalars[f"train/top10acc_cb{c}"])[step]
               for c in range(1, 5)]
        np.testing.assert_allclose(np.mean(cbs), v, rtol=1e-5)
