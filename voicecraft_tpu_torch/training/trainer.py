"""Training runtime: the loop, metrics, checkpoints and resume, validation
and early stop (PyTorch port of voicecraft_tpu/training/trainer.py).

  * one card, or a (data, model) mesh of processes (parallel/mesh.py), one
    per card: each data row reads its own batches (the batcher's host split
    over 'data'), its model ranks hold the tensor-parallel shards, the
    gradients are summed over 'data' and, with ``tcfg.zero1``, the
    optimizer's moments are sharded over 'data'.  Rank 0 alone writes the
    vocabulary, the checkpoints and the meta, of the gathered state (a
    checkpoint does not depend on the mesh);
  * checkpoints are ``torch.save`` files: ``<exp>/ckpt_<tag>/model.pt``
    holds the model's state (f32 master weights) and ``train_state.pt`` the
    optimizer's, the step-seed generator's and the progress, beside
    ``<exp>/meta_<tag>.json`` (progress and both configs); the directory and
    the json are each written under a temporary name and renamed (see
    ``Trainer.save``), and ``inference/loader.py:load_model`` reads
    model.pt and the json;
  * mid-epoch resume regenerates the epoch's batch list (the batcher is
    deterministic) and skips ``batch_in_epoch`` batches; each batch's host
    rng is keyed on (seed, epoch, batch), so a resumed run sees the batches
    a straight run sees.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import shutil
import threading
import time
from dataclasses import asdict
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..data.manifest import DynamicBatcher, ManifestDataset, collate_train
from ..inference.loader import CKPT_MODEL, load_state
from ..models.voicecraft import TrainBatch, VoiceCraft, forward_train
from ..parallel.mesh import (Mesh, gather_params, leaf_layouts, shard_batch,
                             shard_params, shard_state, zero1_opt_shardings)
from ..utils.profiling import AverageMeter, StepProfiler
from .optim import (AdamW, ScaledAdam, eden_schedule, linear_warmup_decay,
                    stacked_leaves)
from .step import make_train_step

log = logging.getLogger("voicecraft_tpu_torch.trainer")

CKPT_TRAIN = "train_state.pt"   # beside CKPT_MODEL: optimizer and generator


def _pad_batch(batch: TrainBatch, B_target: int) -> TrainBatch:
    """Pad a TrainBatch with fully-masked rows (target_valid all False) to
    B_target rows, so that the batch divides into the grad-accumulation
    stripes; padded rows add nothing to the loss or the metrics."""
    n = B_target - batch.x.shape[0]
    if n == 0:
        return batch

    def pad(t, fill):
        return torch.cat([t, t.new_full((n,) + t.shape[1:], fill)])

    return TrainBatch(
        x=pad(batch.x, 0), x_lens=pad(batch.x_lens, 1),
        y_tokens=pad(batch.y_tokens, 0), y_lens=pad(batch.y_lens, 1),
        mask_emb_idx=pad(batch.mask_emb_idx, -1),
        target_valid=pad(batch.target_valid, False))


class Trainer:
    def __init__(self, mcfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                 tb_writer=None, init_from: Optional[str] = None,
                 train_mtp_only: bool = False, device="cuda"):
        """``init_from``: start from a checkpoint (.pth, HF snapshot or a
        checkpoint directory of this trainer) instead of random weights;
        MTP heads it lacks are freshly initialised.  ``train_mtp_only``
        trains only ``mtp_heads``, leaving the base model bit-identical
        (grafting speculative-decoding heads onto a frozen model).
        ``mesh``: a parallel.mesh.Mesh over every process of the run (each
        calls the same methods); the model runs on the mesh's device."""
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        if (mesh is None and torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise ValueError("a multi-process run trains over a mesh: pass "
                             "mesh=parallel.mesh.make_mesh(n_data, n_model)")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.primary = mesh is None or mesh.rank == 0
        self.data_rank = 0 if mesh is None else mesh.data_rank
        n_hosts = 1 if mesh is None else mesh.n_data
        if self.device.type == "cpu" and mcfg.compute_dtype == "bfloat16":
            mcfg = dataclasses.replace(mcfg, compute_dtype="float32")
            log.info("cpu: compute dtype bfloat16 -> float32")
        self.mcfg, self.tcfg = mcfg, tcfg
        self.start_time = time.time()
        os.makedirs(tcfg.exp_dir, exist_ok=True)

        self.train_ds = ManifestDataset(mcfg, tcfg, "train")
        try:
            self.valid_ds = ManifestDataset(mcfg, tcfg, "validation")
        except FileNotFoundError:
            self.valid_ds = None
        # the phoneme vocabulary beside the checkpoints, for inference
        src_vocab = os.path.join(tcfg.dataset_dir, "vocab.txt")
        if self.primary and os.path.exists(src_vocab):
            shutil.copy(src_vocab, os.path.join(tcfg.exp_dir, "vocab.txt"))
        # the model ranks of one data row read the same batches
        self.batcher = DynamicBatcher(
            self.train_ds.lengths, tcfg.max_num_tokens,
            num_buckets=tcfg.num_buckets, seed=tcfg.seed,
            num_hosts=n_hosts, host=self.data_rank)
        if self.valid_ds is not None:
            self.valid_batcher = DynamicBatcher(
                self.valid_ds.lengths,
                tcfg.val_max_num_tokens or tcfg.max_num_tokens,
                num_buckets=tcfg.num_buckets, seed=tcfg.seed,
                num_hosts=n_hosts, host=self.data_rank)

        self.model = VoiceCraft(mcfg, self.device, trainable=True).init_weights(
            torch.Generator(device=self.device).manual_seed(tcfg.seed))
        if init_from:
            _, state, _ = load_state(init_from)
            missing, unexpected = self.model.load_state_dict(state, strict=False)
            if unexpected or any(not k.startswith("mtp_heads.") for k in missing):
                raise ValueError(f"init_from {init_from}: the checkpoint does "
                                 f"not fit the model (missing {missing}, "
                                 f"unexpected {unexpected})")
            if missing:
                log.info("init_from %s: fresh-initialised the MTP heads",
                         init_from)
        if train_mtp_only:
            if getattr(self.model, "mtp_heads", None) is None:
                raise ValueError("train_mtp_only needs n_mtp > 0")
            for name, p in self.model.named_parameters():
                p.requires_grad_(name.startswith("mtp_heads."))
        if mesh is not None:
            shard_params(self.model, mesh)

        self.total_step = tcfg.num_steps or 50000
        if tcfg.optimizer_name == "ScaledAdam":
            self.lr_fn = eden_schedule(tcfg.lr, tcfg.reduce_lr_start_step,
                                       tcfg.reduce_lr_start_epoch,
                                       self.total_step * tcfg.warmup_fraction,
                                       tcfg.pseudo_epoch_size)
            self.optimizer = ScaledAdam(
                stacked_leaves(self.model), lr=self.lr_fn, betas=(0.9, 0.95), clipping_scale=2.0,
                clipping_update_period=tcfg.clipping_update_period)
        else:
            self.lr_fn = linear_warmup_decay(
                tcfg.lr, self.total_step, self.total_step * tcfg.warmup_fraction)
            self.optimizer = AdamW(
                [p for p in self.model.parameters() if p.requires_grad],
                self.lr_fn, tcfg.weight_decay,
                groups=stacked_leaves(self.model))
        if mesh is not None:
            layouts = (zero1_opt_shardings(self.model, self.optimizer, mesh)
                       if tcfg.zero1 else None)
            if layouts is not None:
                log.info("ZeRO-1: optimizer moments sharded over data=%d",
                         mesh.n_data)
            elif tcfg.zero1 and mesh.n_data > 1:
                log.warning("ZeRO-1 requested but the optimizer state layout "
                            "is unsupported (%s): moments stay replicated per "
                            "data shard", type(self.optimizer).__name__)
            self.optimizer.shard(mesh, layouts or leaf_layouts(
                self.model, self.optimizer.groups))
        # the reference backprops loss / effective_ntoken for every optimizer
        # but ScaledAdam (steps/trainer.py:139-141)
        self.step_fn = make_train_step(
            self.model, self.optimizer,
            grad_accum=tcfg.gradient_accumulation_steps,
            normalize_loss=tcfg.optimizer_name != "ScaledAdam")
        # each step's dropout seed comes from this generator
        self.seed_gen = torch.Generator().manual_seed(tcfg.seed)

        self.meters = {k: AverageMeter(k) for k in ("data_time", "train_time")}
        self.profiler = StepProfiler(tcfg.profile_dir,
                                     start=tcfg.profile_start_step,
                                     stop=tcfg.profile_start_step + 3)
        self.progress = {"step": 1, "epoch": 0, "batch_in_epoch": 0,
                         "best_step": 1, "best_score": float("inf"),
                         "history": []}
        self.tb = tb_writer
        self.early_stop_accu = 0
        self._maybe_resume()
        log.info("model params: %d",
                 sum(p.numel() for p in self.model.parameters()))

    # ---- checkpointing ---------------------------------------------------------

    def _ckpt_dir(self, tag: str) -> str:
        return os.path.join(os.path.abspath(self.tcfg.exp_dir), "ckpt_" + tag)

    def save(self, tag: str = "latest", same_as: Optional[str] = None):
        """<exp>/ckpt_<tag>/{model,train_state}.pt and <exp>/meta_<tag>.json.
        train_state.pt holds the optimizer, the step-seed generator and the
        progress, so what a resume reads changes with the weights.  The new
        directory is written as ckpt_<tag>.tmp (train_state.pt last, under
        its own temporary name, so a .tmp that holds it is whole), the old
        one is renamed to ckpt_<tag>.old, the new one into place, and the
        old one deleted; a save cut anywhere leaves a whole directory that
        _maybe_resume finds.  ``same_as``: the tag of a checkpoint saved
        since the last step, whose files are linked (or copied) instead of
        written again.  Over a mesh every rank calls it: the parameters and
        the optimizer's state are gathered, rank 0 writes them, and the
        ranks meet at a barrier after."""
        model_state = opt_state = None
        if same_as is None:
            model_state = gather_params(self.model)
            opt_state = self.optimizer.state_dict()
        if self.primary:
            self._write(tag, same_as, model_state, opt_state)
        if self.mesh is not None:
            torch.distributed.barrier()

    def _write(self, tag, same_as, model_state, opt_state) -> None:
        path = self._ckpt_dir(tag)
        tmp, old = path + ".tmp", path + ".old"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name in (CKPT_MODEL, CKPT_TRAIN):
            part = os.path.join(tmp, name + ".part")
            if same_as is not None:
                src = os.path.join(self._ckpt_dir(same_as), name)
                try:
                    os.link(src, part)
                except OSError:
                    shutil.copy2(src, part)
            elif name == CKPT_MODEL:
                torch.save(model_state, part)
            else:
                torch.save({"optimizer": opt_state,
                            "generator": self.seed_gen.get_state(),
                            "progress": self.progress}, part)
            os.rename(part, os.path.join(tmp, name))
        if os.path.isdir(path):
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
        # for inference/loader.py and for reading; a resume does not read it
        meta = {"progress": self.progress,
                "model_config": asdict(self.mcfg),
                "train_config": asdict(self.tcfg)}
        meta_fn = os.path.join(self.tcfg.exp_dir, f"meta_{tag}.json")
        with open(meta_fn + ".tmp", "w") as f:
            json.dump(meta, f, indent=2, default=str)
        os.replace(meta_fn + ".tmp", meta_fn)

    def _maybe_resume(self):
        """Resume from ckpt_latest; from a save cut between its renames
        (no ckpt_latest), from the whole new .tmp, else the old .old."""
        path = self._ckpt_dir("latest")
        for d in (path, path + ".tmp", path + ".old"):
            if os.path.isfile(os.path.join(d, CKPT_TRAIN)):
                break
        else:
            return
        state = torch.load(os.path.join(d, CKPT_MODEL),
                           map_location=self.device, weights_only=True)
        self.model.load_state_dict(
            state if self.mesh is None else shard_state(state, self.mesh))
        state = torch.load(os.path.join(d, CKPT_TRAIN),
                           map_location=self.device, weights_only=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.seed_gen.set_state(state["generator"].cpu())
        self.progress.update(state["progress"])
        log.info("resumed from %s at step %d (epoch %d, batch %d)",
                 d, self.progress["step"], self.progress["epoch"],
                 self.progress["batch_in_epoch"])

    # ---- loops -----------------------------------------------------------------

    def _host_rng(self, epoch: int, batch_idx: int) -> np.random.Generator:
        """A batch's host rng, keyed on its data rank too (JAX keys on its
        process index)."""
        return np.random.default_rng((self.tcfg.seed, epoch, batch_idx,
                                      self.data_rank))

    def _empty_batch(self) -> TrainBatch:
        """A fully-masked batch (no target: it adds nothing to the loss, the
        counts or the gradients) that a data rank steps on when its batch
        composed to nothing, so that the ranks meet at every collective.
        Unlike JAX's global array, SPMD ranks need not share batch shapes:
        no rank is padded to fixed dims."""
        m = self.mcfg
        K, Sx, Sy = m.n_codebooks, 16, 64
        full = lambda shape, v, dt: torch.full(shape, v, dtype=dt,
                                               device=self.device)
        i32 = torch.int32
        return TrainBatch(
            x=full((1, Sx), m.text_pad_token, i32), x_lens=full((1,), 1, i32),
            y_tokens=full((1, K, Sy), m.audio_pad_token, i32),
            y_lens=full((1,), 1, i32), mask_emb_idx=full((1, Sy), -1, i32),
            target_valid=full((1, K, Sy), False, torch.bool))

    def _prefetch(self, epoch: int, batches, start_b: int, depth: int = 2):
        """Collate in a background thread (numpy composition overlaps the
        device's steps), yielding (batch index, TrainBatch on the device or
        None); a failure in the thread is raised here, on the main thread."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        done = object()
        stop = threading.Event()          # set when the consumer goes away

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for bi in range(start_b, len(batches)):
                    if not put((bi, collate_train(
                            self.train_ds, batches[bi],
                            self._host_rng(epoch, bi), device="cpu"))):
                        return
                put(done)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                put(e)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise RuntimeError("data producer thread failed") from item
                bi, batch = item
                if batch is not None:
                    batch = TrainBatch(*(t.to(self.device) for t in batch))
                yield bi, batch
        finally:
            stop.set()

    def next_seed(self) -> int:
        """The next step's dropout seed."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.seed_gen))

    def train(self, max_steps: Optional[int] = None):
        t = self.tcfg
        total = min(self.total_step, max_steps or self.total_step)
        flag = True
        data_t0 = time.time()
        while flag:
            epoch = self.progress["epoch"]
            batches = self.batcher.epoch_batches(epoch)
            start_b = self.progress["batch_in_epoch"]
            for bi, batch in self._prefetch(epoch, batches, start_b):
                step = self.progress["step"]
                if step > total:
                    flag = False
                    break
                data_time = time.time() - data_t0
                if batch is None and (self.mesh is None
                                      or self.mesh.n_data == 1):
                    self.progress["batch_in_epoch"] = bi + 1
                    continue
                if batch is None:   # the other data rows step: join them
                    batch = self._empty_batch()
                elif self.mesh is not None:
                    batch = shard_batch(batch, self.mesh)
                gas = t.gradient_accumulation_steps
                if gas > 1 and batch.x.shape[0] % gas:
                    batch = _pad_batch(batch, -(-batch.x.shape[0] // gas) * gas)
                self.profiler.step(step)
                t0 = time.time()
                metrics = self.step_fn(batch, self.next_seed())
                metrics = {k: (v.detach().cpu().numpy()
                               if isinstance(v, torch.Tensor) else v)
                           for k, v in metrics.items()}
                train_time = time.time() - t0
                self.meters["data_time"].update(data_time)
                self.meters["train_time"].update(train_time)

                if metrics["is_nan"] > 0:
                    log.info("step %d: non-finite loss, batch skipped", step)
                ntok = max(float(metrics["effective_ntoken"]), 1.0)
                avg_loss = float(metrics["loss"]) / ntok
                if not np.isfinite(avg_loss) and metrics["is_nan"] == 0:
                    raise RuntimeError("training diverged (loss is NaN)")

                if step % t.tb_write_every_n_steps == 0 and self.tb:
                    self._tb_train(metrics, step, avg_loss, ntok)
                if step % t.print_every_n_steps == 0:
                    log.info("step %d/%d epoch %d loss %.4f acc %.4f "
                             "lr %.2e data %.2fs step %.2fs",
                             step, total, epoch, avg_loss,
                             float(metrics["top10acc"]) / ntok,
                             float(self.lr_fn(step)), data_time, train_time)

                self.progress["step"] = step + 1
                self.progress["batch_in_epoch"] = bi + 1

                if step % t.val_every_n_steps == 0:
                    self.validate_and_save()
                    if self._should_early_stop():
                        log.info("early stop at step %d", step)
                        flag = False
                        break
                data_t0 = time.time()
            else:
                self.progress["epoch"] = epoch + 1
                self.progress["batch_in_epoch"] = 0
                continue
            break
        self.profiler.close()
        self.validate_and_save()

    def _tb_train(self, metrics: dict, step: int, avg_loss: float, ntok: float):
        """The train/ scalars, with the reference's tags and normalisation
        (per-codebook: acc_cb / ntoken * K, 1-indexed; steps/trainer.py:
        284-287)."""
        self.tb.add_scalar("train/loss", avg_loss, step)
        self.tb.add_scalar("train/lr", float(self.lr_fn(step)), step)
        self.tb.add_scalar("train/top10acc",
                           float(metrics["top10acc"]) / ntok, step)
        acc_cb = np.asarray(metrics["top10acc_by_codebook"])
        for ci, a in enumerate(acc_cb):
            self.tb.add_scalar(f"train/top10acc_cb{ci + 1}",
                               float(a) * len(acc_cb) / ntok, step)
        if "mtp_loss" in metrics:
            self.tb.add_scalar("train/mtp_loss",
                               float(metrics["mtp_loss"]) / ntok, step)
            for gi, a in enumerate(np.asarray(metrics["mtp_top1acc"])):
                self.tb.add_scalar(f"train/mtp_top1acc_g{gi + 1}", float(a),
                                   step)

    @torch.no_grad()
    def validate(self) -> float:
        """Loss per target token over the first 50 validation batches, with
        no dropout and no recompute (NaN without a validation split); over
        a mesh, of the global batches (every rank calls it)."""
        if self.valid_ds is None:
            return float("nan")
        losses, ntoks, accs = [], [], []
        acc_cb = None
        for bi, idxs in enumerate(self.valid_batcher.epoch_batches(0)[:50]):
            batch = collate_train(self.valid_ds, idxs,
                                  self._host_rng(10 ** 6, bi),
                                  device=self.device)
            if batch is None and self.mesh is not None \
                    and self.mesh.n_data > 1:
                batch = self._empty_batch()
            if batch is None:
                continue
            out = forward_train(self.model, batch, seed=None, remat=False)
            losses.append(float(out["loss"]))
            ntoks.append(float(out["effective_ntoken"]))
            accs.append(float(out["top10acc"]))
            cb = out["top10acc_by_codebook"].double().cpu().numpy()
            acc_cb = cb if acc_cb is None else acc_cb + cb
        if not ntoks:
            return float("nan")
        ntok = max(sum(ntoks), 1.0)
        score = sum(losses) / ntok
        if self.tb:
            step = self.progress["step"]
            self.tb.add_scalar("val/loss", score, step)
            self.tb.add_scalar("val/top10acc", sum(accs) / ntok, step)
            for ci, a in enumerate(acc_cb):
                self.tb.add_scalar(f"val/top10acc_cb{ci + 1}",
                                   float(a) * len(acc_cb) / ntok, step)
        return score

    def validate_and_save(self):
        score = self.validate()
        step = self.progress["step"]
        self.progress["history"].append(
            [step, score, time.time() - self.start_time])
        # the best is updated first, so that ckpt_latest's progress holds it
        best = np.isfinite(score) and score < self.progress["best_score"]
        if best:
            self.progress["best_score"] = score
            self.progress["best_step"] = step
        self.save("latest")
        if best:
            self.save("best", same_as="latest")
        log.info("validate: step %d score %.5f (best %.5f @ %d)",
                 step, score, self.progress["best_score"],
                 self.progress["best_step"])

    def _should_early_stop(self) -> bool:
        t = self.tcfg
        if t.early_stop_threshold <= 0:
            return False
        hist = self.progress["history"]
        if len(hist) < 2:
            return False
        finite = [h[1] for h in hist[:-1] if np.isfinite(h[1])]
        prev_best = min(finite) if finite else float("inf")
        cur = hist[-1][1]
        if np.isfinite(cur) and prev_best - cur < t.early_stop_threshold:
            self.early_stop_accu += t.val_every_n_steps
        else:
            self.early_stop_accu = 0
        return self.early_stop_accu >= t.early_stop_step
