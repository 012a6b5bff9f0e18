"""The port over a mesh of gloo processes on the CPU, for the
tests/test_torch_mesh*.py files (torch only: the children import no JAX).

:func:`spawn` starts ``world`` processes with a file rendezvous in a
temporary directory, one torch thread each and a collective timeout, runs
``fn(rank, *args)`` in each and hands back every rank's result (numpy and
plain Python values only).  A child that raises or dies fails the call
with its traceback; a hung one fails it at ``timeout``.  The workers below
are the port's side of the mesh tests."""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT_S = 120


def _child(rank, world, path, fn, args, q):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{path}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        q.put((rank, "ok", fn(rank, *args)))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


class Spawned:
    """``world`` gloo processes running fn(rank, *args); :meth:`results`
    waits for them."""

    def __init__(self, world: int, fn, *args, timeout: float = 240):
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        self.dir = tempfile.mkdtemp(prefix="mesh_rdzv_")
        self.deadline = time.time() + timeout
        self.procs = [ctx.Process(target=_child, args=(
            r, world, os.path.join(self.dir, "rdzv"), fn, args, self.q),
            daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()

    def kill(self) -> None:
        for p in self.procs:
            p.kill()
            p.join()
        shutil.rmtree(self.dir, ignore_errors=True)

    def results(self) -> list:
        out = {}
        try:
            while len(out) < len(self.procs):
                try:
                    rank, status, value = self.q.get(timeout=1)
                except queue.Empty:
                    if time.time() > self.deadline:
                        raise TimeoutError("a mesh rank did not finish")
                    dead = [p.exitcode for p in self.procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a mesh rank died: exit codes "
                                           f"{[p.exitcode for p in self.procs]}")
                    continue
                if status == "error":
                    raise RuntimeError(f"mesh rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in self.procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            shutil.rmtree(self.dir, ignore_errors=True)
        return [out[r] for r in range(len(self.procs))]


def spawn(world: int, fn, *args, timeout: float = 240) -> list:
    return Spawned(world, fn, *args, timeout=timeout).results()


def tiny(**kw):
    """The port's tiny_test config in f32 (with ``kw``)."""
    from voicecraft_tpu_torch.config import tiny_test_mtp
    return dataclasses.replace(tiny_test_mtp(), compute_dtype="float32",
                               **{"n_mtp": 0, **kw})


def model_from(state: dict, cfg, trainable: bool = True):
    from voicecraft_tpu_torch.models.voicecraft import VoiceCraft
    model = VoiceCraft(cfg, "cpu", trainable=trainable)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model if trainable else model.eval()


def numpy_state(state: dict) -> dict:
    return {k: v.detach().float().numpy().copy() for k, v in state.items()}


# ---- the training worker -------------------------------------------------------------

def _train(model, mesh, batch, zero1: bool, steps: int = 3, **opt_kw):
    """``steps`` ScaledAdam (lr 0.05, ``opt_kw``) steps of the port's train
    step on this rank's rows of ``batch``; (losses, gathered parameters,
    the optimizer's mesh-independent state)."""
    from voicecraft_tpu_torch.models.voicecraft import TrainBatch
    from voicecraft_tpu_torch.parallel.mesh import (data_slice, gather_params,
                                                    leaf_layouts,
                                                    zero1_opt_shardings)
    from voicecraft_tpu_torch.training.optim import ScaledAdam, stacked_leaves
    from voicecraft_tpu_torch.training.step import make_train_step_two_phase
    opt = ScaledAdam(stacked_leaves(model), lr=0.05, **opt_kw)
    layouts = zero1_opt_shardings(model, opt, mesh) if zero1 else None
    if zero1 and layouts is None:
        raise AssertionError("ZeRO-1 unsupported for ScaledAdam")
    opt.shard(mesh, layouts or leaf_layouts(model, opt.groups))
    step = make_train_step_two_phase(model, opt)
    sl = data_slice(batch[0].shape[0], mesh)
    local = TrainBatch(*(torch.from_numpy(a[sl]) for a in batch))
    losses = [float(step(local, None)["loss"]) for _ in range(steps)]
    return losses, numpy_state(gather_params(model)), opt


def moments_of(sd: dict) -> list:
    """ScaledAdam's gathered moments (``delta``, ``exp_avg_sq``), one flat
    array per leaf and moment."""
    return [np.concatenate([t.flatten().numpy() for t in leaf[k]])
            for leaf in sd["leaves"] for k in ("delta", "exp_avg_sq")]


def closed_stream(rank, model, mesh, x, y, burst, lanes):
    """stream_tts over ``mesh``, greedy: rank 0's consumer closes the
    generator after the first chunk (a client that hangs up), the other
    ranks drain theirs (as serve_torch_cli.py's followers do).  Returns
    (frames of the first chunk, every chunk's frames on this rank, its
    stats, whether a last chunk came)."""
    from voicecraft_tpu_torch.inference.streaming import stream_tts
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    stats = {}
    it = stream_tts(model, x, y, SamplingConfig(**GREEDY), seed=0,
                    mesh=mesh, lanes=lanes, burst=burst, stats=stats)
    chunks = [next(it)]
    if rank == 0:
        it.close()
    else:
        chunks += list(it)
    return dict(first=chunks[0]["frames"].shape[1],
                frames=sum(c["frames"].shape[1] for c in chunks),
                stats=stats, last="gen" in chunks[-1])


def train_worker(rank, state, mtp_state, batch):
    """The training scenarios of tests/test_torch_mesh.py on a world of 4:
    shard -> gather; forward_train's loss and gathered gradients at 2 x 2;
    3 ScaledAdam steps with ZeRO-1 at 4 x 1 and 2 x 2 and replicated at
    2 x 2, with the ZeRO-1 state gathered and re-loaded; train_mtp_only at
    4 x 1 with ZeRO-1.  Rank 0 returns the results."""
    from voicecraft_tpu_torch.models.voicecraft import TrainBatch, forward_train
    from voicecraft_tpu_torch.parallel.mesh import (all_reduce_data_,
                                                    data_slice, gather_params,
                                                    make_mesh, param_spec,
                                                    shard_params)
    from voicecraft_tpu_torch.training.optim import ScaledAdam, stacked_leaves
    cfg = tiny()
    meshes = {"2x2": make_mesh(2, 2), "4x1": make_mesh(4, 1)}
    out = {}

    m = shard_params(model_from(state, cfg), meshes["2x2"])
    gathered = gather_params(m)
    out["round_trip"] = all(torch.equal(gathered[k], torch.from_numpy(v))
                            for k, v in state.items())
    sl = data_slice(batch[0].shape[0], meshes["2x2"])
    res = forward_train(m, TrainBatch(*(torch.from_numpy(a[sl])
                                        for a in batch)))
    res["loss"].backward()
    grads = {n: all_reduce_data_(p.grad.clone(), meshes["2x2"])
             for n, p in m.named_parameters()}
    out["loss"] = float(res["loss"])
    out["effective_ntoken"] = float(res["effective_ntoken"])
    out["grads"] = numpy_state(gather_params(m, grads))

    # dropout on: each rank's replicated activations must stay its model
    # peers' (the residual masks drawn from the same seed), so the
    # gradients of the replicated parameters agree bit for bit
    drop = tiny(text_embedding_dropout=0.1, trm_dropout=0.1,
                audio_positional_embedding_dropout=0.1)
    m = shard_params(model_from(state, drop), meshes["2x2"])
    res = forward_train(m, TrainBatch(*(torch.from_numpy(a[sl])
                                        for a in batch)), seed=123)
    res["loss"].backward()
    dropout = {"loss": float(res["loss"].detach()),
               "grads": {n: p.grad.numpy().copy()
                         for n, p in m.named_parameters()
                         if "model" not in param_spec(n)}}

    for name, mesh, zero1 in (("4x1 zero1", "4x1", True),
                              ("2x2 zero1", "2x2", True),
                              ("2x2 replicated", "2x2", False)):
        model = shard_params(model_from(state, cfg), meshes[mesh])
        losses, params, opt = _train(model, meshes[mesh], batch, zero1)
        sd = opt.state_dict()
        out[name] = dict(losses=losses, params=params,
                         moments=moments_of(sd))
        if name == "2x2 zero1":   # the gathered state loads and re-gathers
            fresh = ScaledAdam(stacked_leaves(model), lr=0.05)
            fresh.shard(meshes[mesh], opt.layouts)
            fresh.load_state_dict(sd)
            again = fresh.state_dict()
            out["reload"] = all(
                torch.equal(a, b) for la, lb in zip(sd["leaves"],
                                                    again["leaves"])
                for k in ("delta", "exp_avg_sq")
                for a, b in zip(la[k], lb[k]))

    model = model_from(mtp_state, tiny(n_mtp=2))
    for n, p in model.named_parameters():
        p.requires_grad_(n.startswith("mtp_heads."))
    shard_params(model, meshes["4x1"])
    losses, params, opt = _train(model, meshes["4x1"], batch, zero1=True)
    out["mtp_only"] = dict(losses=losses, params=params,
                           sharded=[l.data_axis for l in opt.layouts])
    return dict(out, dropout=dropout) if rank == 0 else {"dropout": dropout}


# ---- the serving worker ----------------------------------------------------------

GREEDY = dict(top_k=1, silence_tokens=(5, 7))
SAMPLED = dict(top_k=20, temperature=1.0, silence_tokens=(5, 7))
ENGINE = dict(x_pad=32, y_pad=64, gen_max=256, burst=16)
TAU = 4


def serving_worker(rank, state, tts_reqs, edit_reqs, engine_reqs):
    """The serving scenarios of tests/test_torch_mesh_serving.py on a world
    of 4, at 2 x 2 (tiny_test with 3 MTP head groups, f32): serve_tts_batch
    and serve_edit_batch, greedy plain and speculative (tau TAU) and TTS
    sampled; the engine over 2 lanes (one a data rank), a stream, and a
    stream that rank 0's consumer closes.
    Every rank returns its results (each holds the whole wave's)."""
    from voicecraft_tpu_torch.inference.engine import ContinuousBatcher
    from voicecraft_tpu_torch.inference.serving import (serve_edit_batch,
                                                        serve_tts_batch)
    from voicecraft_tpu_torch.inference.streaming import stream_tts
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    from voicecraft_tpu_torch.parallel.mesh import make_mesh, shard_params
    from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
    mesh = make_mesh(2, 2)
    model = shard_params(model_from(state, tiny(n_mtp=3), trainable=False),
                         mesh)
    g, s = SamplingConfig(**GREEDY), SamplingConfig(**SAMPLED)
    out = {"heads": model.decoder.nhead}
    stats = {}
    out["tts"] = [o[1] for o in serve_tts_batch(model, tts_reqs, g, seed=0,
                                                mesh=mesh, stats=stats)]
    out["tts_steps"] = stats["steps"]
    out["tts_spec"] = [o[1] for o in serve_tts_batch(
        model, tts_reqs, g, seed=0, mesh=mesh, spec=TAU)]
    out["tts_sampled"] = [o[1] for o in serve_tts_batch(
        model, tts_reqs, s, seeds=[3, 4, 5, 6], mesh=mesh)]
    out["edit"] = serve_edit_batch(model, edit_reqs, g, seed=0, mesh=mesh)
    out["edit_spec"] = serve_edit_batch(model, edit_reqs, g, seed=0,
                                        mesh=mesh, spec=TAU)
    eng = ContinuousBatcher(model, lanes=2, scfg=g, seed=0, mesh=mesh,
                            **ENGINE)
    ids = [eng.submit(x, y) for x, y in engine_reqs]
    res = eng.run()
    out["engine"] = [res[i][1] for i in ids]
    out["engine_stats"] = dict(eng.stats)
    x, y = engine_reqs[-1]
    chunks = list(stream_tts(model, x, y, g, seed=0, mesh=mesh, lanes=2,
                             burst=16))
    out["stream"] = (np.concatenate([c["frames"] for c in chunks], axis=1),
                     chunks[-1]["gen"])
    out["closed"] = closed_stream(rank, model, mesh, x, y, burst=8, lanes=2)
    try:
        quantize_decoder_fp8(model)
        shard_params(quantize_decoder_fp8(model_from(
            state, tiny(n_mtp=3), trainable=False)), mesh)
    except ValueError as e:
        out["fp8_refused"] = str(e)
    return out


# ---- the two mesh faults at 2 x 1 ------------------------------------------------

# ScaledAdam's per-leaf sums steer its size update from the 4th step
# (size_update_period 4) and the clipping from the 2nd period's first step
FAULT_STEPS = 6

def faults_worker(rank, state, batch, x, y, burst):
    """tests/test_torch_mesh_faults.py on a world of 2, a 2 x 1 mesh (f32):
    FAULT_STEPS ScaledAdam steps with ZeRO-1 and replicated (losses,
    gathered parameters and moments), the size update and the clipping
    record in play, and a stream that rank 0's consumer closes after its
    first chunk, beside the same stream run to its end."""
    from voicecraft_tpu_torch.inference.streaming import stream_tts
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    from voicecraft_tpu_torch.parallel.mesh import make_mesh, shard_params
    mesh = make_mesh(2, 1)
    out = {}
    for name, zero1 in (("zero1", True), ("replicated", False)):
        model = shard_params(model_from(state, tiny()), mesh)
        losses, params, opt = _train(model, mesh, batch, zero1,
                                     steps=FAULT_STEPS,
                                     clipping_update_period=2)
        out[name] = dict(losses=losses, params=params,
                         moments=moments_of(opt.state_dict()),
                         sharded=sum(l.data_axis is not None
                                     for l in opt.layouts))
    model = shard_params(model_from(state, tiny(), trainable=False), mesh)
    out["full"] = sum(c["frames"].shape[1] for c in stream_tts(
        model, x, y, SamplingConfig(**GREEDY), seed=0, mesh=mesh, lanes=2,
        burst=burst))
    out["closed"] = closed_stream(rank, model, mesh, x, y, burst, lanes=2)
    return out


# ---- the Trainer worker ----------------------------------------------------------

def trainer_worker(rank, root, exp, steps):
    """tests/test_torch_mesh_train.py's run: Trainer(mesh=2 x 1) on the
    tiny manifest at ``root`` for ``steps`` steps (writing ``exp``), every
    step's loss and this rank's utterances kept.  Returns (losses, the
    utterance indices of its batches, the gathered parameters)."""
    from voicecraft_tpu_torch.config import TrainConfig
    from voicecraft_tpu_torch.parallel.mesh import gather_params, make_mesh
    from voicecraft_tpu_torch.training.trainer import Trainer
    mesh = make_mesh(2, 1)
    tcfg = TrainConfig(dataset_dir=root, exp_dir=exp, max_num_tokens=1200,
                       num_buckets=3, num_steps=steps, audio_min_length=2.0,
                       audio_max_length=8.0, text_min_length=2,
                       val_every_n_steps=100, print_every_n_steps=5,
                       tb_write_every_n_steps=1000, lr=0.02, seed=1)
    tr = Trainer(tiny(), tcfg, mesh=mesh, device="cpu")
    ids = {i for b in tr.batcher.epoch_batches(0)[:steps] for i in b}
    step_fn, losses = tr.step_fn, []

    def step(batch, seed):
        m = step_fn(batch, seed)
        losses.append(float(m["loss"]))
        return m
    tr.step_fn = step
    tr.train(max_steps=steps)
    return losses, sorted(ids), numpy_state(gather_params(tr.model))
