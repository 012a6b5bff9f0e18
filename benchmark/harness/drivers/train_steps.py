"""Training steps as the trainer takes them: ``training/step.py:
make_train_step`` over ScaledAdam with Eden (``training/optim.py``), called
as ``training/trainer.py`` calls it, on batches of ``data/manifest.py``'s
DynamicBatcher and collate over a synthetic dataset that set-up writes
under TMPDIR from the seed, collated in a background thread as the trainer
does.

Set-up builds the step, the model and the optimizer once and drives them
through their first ``check_steps`` steps on the feed's first batches (the
window's own call and feed); those steps are what the reference follows.
The window then runs whole steps until ``--seconds`` have passed and the
step in flight has returned: target tokens of every step over their time."""

from __future__ import annotations

import itertools
import os
import queue
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from .. import traffic as tr
from ..common import Check, RunResult, checks_json
from ..trace import Slice


def utterances(t: dict, cfg: dict, seed: int):
    """The dataset: a fixed list of utterance lengths (frames, evenly over
    the recipe's range) with phones in proportion, in a seed-drawn order,
    codes and phones drawn from the seed."""
    n = t["utterances"]
    lo, hi = t["frames"]
    frames = np.linspace(lo, hi, n).round().astype(int)
    plo, phi = t["phones"]
    phones = np.round(plo + (frames - lo) / max(hi - lo, 1) * (phi - plo))
    rng = tr.rng_for(seed, 3)
    order = rng.permutation(n)
    K, V, P = cfg["n_codebooks"], cfg["audio_vocab_size"], cfg["text_vocab_size"]
    items = []
    for i, j in enumerate(order):
        r = tr.rng_for(seed, 4, i)
        items.append({"id": f"u{i:05d}",
                      "phones": [f"p{v}" for v in
                                 r.integers(0, P, int(phones[j]))],
                      "codes": r.integers(0, V, (K, int(frames[j]))).tolist()})
    return items


def _prefetch(dataset, batches, seed, collate, device, depth=2):
    """Batches collated on the host in a thread, moved to the device here;
    a failure in the thread is raised on the caller's."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        try:
            for bi, idx in enumerate(batches):
                item = collate(dataset, idx, tr.rng_for(seed, 5, bi),
                               device="cpu")
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        pass
                if stop.is_set():
                    return
            q.put(None)
        except BaseException as e:   # noqa: BLE001 - raised on the consumer
            q.put(e)

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise RuntimeError("batch producer failed") from item
            yield type(item)(*(x.to(device) for x in item))
    finally:
        stop.set()
        th.join(timeout=10)


def _names(model, optimizer):
    """The parameter name of each tensor of each optimizer leaf."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    return [[by_id[id(p)] for p in g] for g in optimizer.groups]


def run(ctx) -> RunResult:
    import dataclasses
    from voicecraft_tpu_torch.config import TrainConfig
    from voicecraft_tpu_torch.data.manifest import (DynamicBatcher,
                                                    ManifestDataset,
                                                    collate_train,
                                                    write_manifest_tree)
    from voicecraft_tpu_torch.models.voicecraft import VoiceCraft
    from voicecraft_tpu_torch.training.optim import (ScaledAdam, eden_schedule,
                                                     stacked_leaves)
    from voicecraft_tpu_torch.training.step import make_train_step
    from ..weights import make_state

    t = ctx.traffic
    cfg = {**ctx.cfg, **t["model_overrides"]}
    ctx.cfg = cfg
    mcfg = dataclasses.replace(ctx.port_config(), **{
        k: (tuple(v) if isinstance(v, list) else v)
        for k, v in t["model_overrides"].items()})
    data_dir = tempfile.mkdtemp(prefix="bench_train_", dir=os.environ.get("TMPDIR"))
    try:
        write_manifest_tree(data_dir, utterances(t, cfg, ctx.seed), mcfg)
        tcfg = TrainConfig(**{**t["train_config"], "dataset_dir": data_dir,
                              "seed": ctx.seed % (2 ** 31)})
        dataset = ManifestDataset(mcfg, tcfg)
        batcher = DynamicBatcher(dataset.lengths, tcfg.max_num_tokens,
                                 tcfg.num_buckets, seed=ctx.seed % (2 ** 31))
        batches = itertools.chain.from_iterable(
            batcher.epoch_batches(e) for e in itertools.count())
        return _run(ctx, t, cfg, mcfg, tcfg, dataset, batches, collate_train,
                    VoiceCraft, ScaledAdam, eden_schedule, stacked_leaves,
                    make_train_step, make_state)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def _run(ctx, t, cfg, mcfg, tcfg, dataset, batches, collate, VoiceCraft,
         ScaledAdam, eden_schedule, stacked_leaves, make_train_step,
         make_state) -> RunResult:
    dev = ctx.device
    model = VoiceCraft(mcfg, dev, trainable=True)
    model.load_state_dict(make_state(cfg, ctx.seed, dev, torch.float32))
    model.train()
    total = tcfg.num_steps or 50000
    lr_fn = eden_schedule(tcfg.lr, tcfg.reduce_lr_start_step,
                          tcfg.reduce_lr_start_epoch,
                          total * tcfg.warmup_fraction, tcfg.pseudo_epoch_size)
    opt = ScaledAdam(stacked_leaves(model), lr=lr_fn, betas=(0.9, 0.95),
                     clipping_scale=2.0,
                     clipping_update_period=tcfg.clipping_update_period)
    step_fn = make_train_step(model, opt,
                              grad_accum=tcfg.gradient_accumulation_steps,
                              normalize_loss=tcfg.optimizer_name != "ScaledAdam")
    names = _names(model, opt)
    seed_of = lambda i: int(tr.rng_for(ctx.seed, 6, i).integers(0, 2 ** 62))
    feed = _prefetch(dataset, batches, ctx.seed, collate, dev)

    n_check = t["check_steps"]
    checked, losses, grad_norms = [], [], {}
    for i in range(n_check):
        batch = next(feed)
        m = step_fn(batch, seed_of(i))
        if m["is_nan"]:
            raise RuntimeError(f"set-up step {i} skipped: loss not finite")
        losses.append(float(m["loss"]))
        checked.append({k: v.detach() for k, v in batch._asdict().items()})
        if i == 0:
            # the first gradient as the optimizer got it: Adam's second
            # moment after one step is (1 - beta2) g^2
            for ns, leaf in zip(names, opt.leaves):
                for n, eas in zip(ns, leaf["exp_avg_sq"]):
                    grad_norms[n] = float((eas.double().sum()
                                           / (1 - opt.beta2)).sqrt())
    after = {n: p.detach().to("cpu", copy=True)
             for n, p in model.named_parameters()}
    ctx.setup_done()

    steps, traced = [], None
    i = n_check
    t0 = ctx.now()
    while True:
        batch = next(feed)
        ts = time.perf_counter()
        trace_this = (ctx.trace and traced is None
                      and ts - t0 >= ctx.seconds / 2)
        if trace_this:
            with Slice(dev) as sl:
                m = step_fn(batch, seed_of(i))
            traced = sl.summary
            if traced is not None:
                traced.steps = 1
        else:
            m = step_fn(batch, seed_of(i))
        ntok = int(m["effective_ntoken"])
        te = time.perf_counter()
        steps.append((ntok, ts, te, trace_this, tuple(batch.y_tokens.shape),
                      int(batch.x.shape[1]), m["is_nan"]))
        i += 1
        if te - t0 >= ctx.seconds:
            break
    feed.close()
    window = steps[-1][2] - t0
    tokens = sum(s[0] for s in steps)
    peak = ctx.memory_peak()
    flops, wall = 0.0, 0.0
    from ..counts import train_step_flops
    for ntok, ts, te, was_traced, yshape, sx, _ in steps:
        if not was_traced:
            B, _, Sy = yshape
            flops += train_step_flops(cfg, B, sx, Sy)
            wall += te - ts
    del model, opt, step_fn, feed
    ctx.free()

    checks, details = _check(ctx, cfg, t, checked,
                             [seed_of(i) for i in range(n_check)], losses,
                             grad_norms, after, make_state)
    res = RunResult(attempted=len(steps), failed=int(sum(s[6] for s in steps)),
                    checks=checks, memory_peak_bytes=peak, trace=traced)
    res.end_to_end["train_tokens_per_s"] = tokens / window
    res.readings.update(details, cfg=cfg, flops=flops, flops_wall_s=wall,
                        window_s=window, steps=len(steps))
    ctx.log(f"window {window:.3f} s, {len(steps)} steps, {tokens} target "
            f"tokens, losses {losses}")
    return res


def _follow(ref_mod, cfg, t, init, dev, batches, seeds, precision):
    """A reference (f32, or the fp8 control) through the checked steps:
    (each step's loss, the first gradient's norm per tensor, each tensor
    after the last step)."""
    tc = t["train_config"]
    ref = ref_mod.TrainReference(cfg, init, dev, cfg["codebook_weight"],
                                 precision)
    total = tc.get("num_steps", 50000)
    losses, grads = [], {}
    for i, (b, s) in enumerate(zip(batches, seeds)):
        losses.append(ref.loss_and_grads(
            b, int(s), t.get("reference_rows", 4),
            tc.get("gradient_accumulation_steps", 1)))
        if i == 0:
            grads = {n: float(p.grad.double().norm()) if p.grad is not None
                     else 0.0 for n, p in ref.p.items()}
        ref.adam_step(i, ref_mod.eden_lr(
            i, tc.get("lr", 0.05), tc.get("reduce_lr_start_step", 3000),
            tc.get("reduce_lr_start_epoch", 4),
            total * tc.get("warmup_fraction", 0.01),
            tc.get("pseudo_epoch_size", 3000)))
    after = {n: p.detach() for n, p in ref.p.items()}
    return losses, grads, after


def _worst(values: dict, ref: dict, floor: float):
    """(worst leaf's gap of norms over max(its reference norm, floor), the
    leaf)."""
    worst, leaf = 0.0, None
    for n, r in ref.items():
        gap = abs(values[n] - r) / max(r, floor)
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf


def _gaps(prog, ref, init, dev):
    """The three compared numbers of a run against the reference: the worst
    step's relative loss gap, the worst leaf's first-gradient norm gap, the
    worst moved leaf's change norm gap.  A leaf whose reference gradient is
    under a thousandth of the median leaf's (a key's bias under softmax)
    moves by round-off alone under Adam, and is left out of the change."""
    losses, grads, after = prog
    r_losses, r_grads, r_after = ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    med_g = float(np.median(list(r_grads.values())))
    grad_gap, grad_leaf = _worst(grads, r_grads, med_g)
    moved = [n for n, g in r_grads.items() if g >= 1e-3 * med_g]
    change = lambda a: {n: float((a[n].to(dev).double()
                                  - init[n].double()).norm()) for n in moved}
    c, rc = change(after), change(r_after)
    change_gap, change_leaf = _worst(c, rc, float(np.median(list(rc.values()))))
    return (loss_gap, grad_gap, change_gap), {
        "grad_leaf": grad_leaf, "change_leaf": change_leaf,
        "left_out": sorted(set(r_grads) - set(moved))}


def _check(ctx, cfg, t, batches, seeds, losses, grad_norms, after,
           make_state):
    """The reference follows the checked steps from the same weights,
    batches and seeds.  With ``ctx.control`` the fp8 control's steps take
    the program's place in the checks, so a sound control makes
    ``correct`` false; the program's own checks go to
    ``details["program"]``."""
    ref_mod = ctx.reference_module()
    ref_mod.exact_f32()
    dev = ctx.device
    init = make_state(cfg, ctx.seed, dev, torch.float32)
    ref = _follow(ref_mod, cfg, t, init, dev, batches, seeds, "f32")
    gaps, details = _gaps((losses, grad_norms, after), ref, init, dev)
    details.update(losses=losses, ref_losses=ref[0])
    limits = t["limits"]
    names = ("loss_rel_gap", "grad_norm_gap", "change_norm_gap")
    checks = [Check(n, v, limits[n]) for n, v in zip(names, gaps)]
    if ctx.control:
        details["program"] = checks_json(checks)
        ctrl = _follow(ref_mod, cfg, t, init, dev, batches, seeds, "fp8")
        checks = [Check(n, v, limits[n]) for n, v in
                  zip(names, _gaps(ctrl, ref, init, dev)[0])]
    ctx.log(f"train check: {[c.value for c in checks]} {details}")
    return checks, details
