"""ScaledAdam with the Eden schedule, and the AdamW companion (PyTorch port
of voicecraft_tpu/training/optim.py).

ScaledAdam is the reference's icefall optimizer (steps/optim.py:129-807):
per-tensor rms-scaled updates, a separately learned per-tensor scale updated
every ``size_update_period`` steps, and adaptive clipping against the median
of the last ``clipping_update_period`` gradient norms.  The update is the
JAX package's, leaf by leaf, in f32; each optimizer holds its own state and
updates its parameters in place from their ``.grad`` when ``step()`` is
called (a skipped step leaves parameters and state untouched).

The schedules are functions of the update count: Eden's epoch input is
derived from it (the reference trainer drives step_epoch(step //
pseudo_epoch_size + 1), steps/trainer.py:70-71).

Over a mesh (``shard``, parallel/mesh.py) each optimizer runs on the
tensor-parallel shards of its leaves, and ``step`` sums the gradients over
'data' itself.  Under ZeRO-1 (``zero1_opt_shardings``) each data rank
keeps only its piece of every moment: ``step`` reduce-scatters the
gradients onto it, updates it and all-gathers the update.  The replicated
layout sums the gradients through the same reduce-scatter, then gathers
the pieces; and ScaledAdam forms each per-leaf sum (the scale gradients,
the clipping norm) from the partial sums of the same ZeRO-1 pieces, added
in data-rank order, and over 'model' from the model ranks' partial sums in
rank order.  So ZeRO-1 changes no bit of the trajectory, as in the JAX
package.  ``state_dict`` / ``load_state_dict`` gather and re-shard, so a
checkpoint does not depend on the mesh.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from ..models.transformer import FFN_KEYS
from ..parallel import mesh as pm

Schedule = Union[float, Callable[[int], float]]


def eden_schedule(base_lr: float, lr_batches: float, lr_epochs: float,
                  warmup_batches: float,
                  pseudo_epoch_size: int = 3000) -> Callable[[int], float]:
    """lr(step) = base * ((step² + B²) / B²)^-.25 * ((epoch² + E²) / E²)^-.25
    * warmup, epoch = step // pseudo_epoch_size + 1, the warmup linear from
    0.5 to 1 over ``warmup_batches`` (reference steps/optim.py:759-807)."""

    def schedule(step: int) -> float:
        epoch = math.floor(step / pseudo_epoch_size) + 1.0
        factor = (((step ** 2 + lr_batches ** 2) / lr_batches ** 2) ** -0.25
                  * ((epoch ** 2 + lr_epochs ** 2) / lr_epochs ** 2) ** -0.25)
        warmup = (1.0 if step >= warmup_batches
                  else 0.5 + 0.5 * step / max(warmup_batches, 1.0))
        return base_lr * factor * warmup

    return schedule


def linear_warmup_decay(base_lr: float, total_steps: int,
                        warmup_steps: float) -> Callable[[int], float]:
    """AdamW's schedule (reference steps/trainer.py:438-444): linear up over
    ``warmup_steps``, then linear down to 0 at ``total_steps``."""

    def schedule(step: int) -> float:
        up = step / max(warmup_steps, 1.0)
        down = (total_steps - step) / max(total_steps - warmup_steps, 1.0)
        return base_lr * max(up if step < warmup_steps else down, 0.0)

    return schedule


def _schedule(lr: Schedule) -> Callable[[int], float]:
    return lr if callable(lr) else (lambda _: lr)


def _grads(group) -> List[torch.Tensor]:
    """A leaf's f32 gradients (a missing one counts as zero)."""
    return [p.grad.float() if p.grad is not None
            else torch.zeros_like(p, dtype=torch.float32) for p in group]


def _in_order(v: torch.Tensor) -> torch.Tensor:
    """v[0] + v[1] + ... in that order."""
    out = v[0]
    for row in v[1:]:
        out = out + row
    return out


# the JAX package's tree paths of a decoder layer's parameters: its layers
# (and its MTP head groups) are stacked along a leading axis, one leaf each.
# The norms' (ln1_g -> ln1/g, ln2_log_eps -> ln2/log_eps, ...) and the first
# FFN projection's (ffn/lin1, ffn/lin1_dsw, ...) follow the model's family.
_LAYER_PATHS = {
    "bk": "attn/bk", "bq": "attn/bq", "bv": "attn/bv", "bo": "attn/out/b",
    "wo": "attn/out/w", "wk": "attn/wk", "wq": "attn/wq", "wv": "attn/wv",
    "b2": "ffn/lin2/b", "w2": "ffn/lin2/w"}


def _jax_path(name: str, lin1: str = "lin1") -> Tuple[str, str]:
    """(JAX tree path, the port's name with the stacked index dropped);
    ``lin1`` is the JAX key of the first FFN projection."""
    parts = name.split(".")
    if parts[:2] == ["decoder", "layers"]:
        leaf = parts[3]
        if leaf in ("w1", "b1"):
            path = f"ffn/{lin1}/{leaf[0]}"
        elif leaf.startswith(("ln1_", "ln2_")):
            path = leaf[:3] + "/" + leaf[4:]
        else:
            path = _LAYER_PATHS[leaf]
        return "decoder/layers/" + path, f"decoder.layers.{leaf}"
    if parts[0] == "mtp_heads":
        return "mtp_heads/" + parts[2], f"mtp_heads.{parts[2]}"
    if name.startswith("decoder.final_ln_"):
        return "decoder/final_ln/" + name[len("decoder.final_ln_"):], name
    if name == "text_emb":
        return "text_emb/weight", name
    return name.replace(".", "/"), name


def stacked_leaves(model: torch.nn.Module) -> List[Tuple[torch.Tensor, ...]]:
    """The model's trainable parameters as the JAX package's optimizer sees
    them: one leaf per decoder-layer parameter across the layers (and per
    MTP-head parameter across the groups), each a tuple of the tensors it
    stacks, in the JAX tree's order.  ScaledAdam's per-tensor scale, rms and
    scale-gradient are per leaf."""
    groups: Dict[str, Tuple[str, List[torch.Tensor]]] = {}
    lin1 = FFN_KEYS[model.decoder.activation]
    for name, p in model.named_parameters():
        if p.requires_grad:
            path, key = _jax_path(name, lin1)
            groups.setdefault(key, (path, []))[1].append(p)
    return [tuple(ps) for _, ps in sorted(groups.values(), key=lambda v: v[0])]


class ScaledAdam:
    """ScaledAdam over ``params``: tensors, or tuples of same-shaped tensors
    that form one leaf (:func:`stacked_leaves`), whose rms, scale and
    scale-gradient are those of their stack.

    ``step()`` applies one update from the parameters' gradients (a missing
    grad counts as zero); ``state_dict`` / ``load_state_dict`` carry the
    update count and every tensor of the state.  ``shard`` runs it over a
    mesh (see the module's docstring)."""

    def __init__(self, params: Iterable, lr: Schedule,
                 betas=(0.9, 0.95), clipping_scale: Optional[float] = 2.0,
                 scalar_lr_scale: float = 0.1, eps: float = 1e-8,
                 param_min_rms: float = 1e-5, param_max_rms: float = 3.0,
                 scalar_max: float = 10.0, size_update_period: int = 4,
                 clipping_update_period: int = 600):
        self.groups = [tuple(p) if isinstance(p, (list, tuple)) else (p,)
                       for p in params]
        self.params = [p for g in self.groups for p in g]
        self.lr_fn = _schedule(lr)
        self.beta1, self.beta2 = betas
        self.clipping_scale = clipping_scale
        self.scalar_lr_scale = scalar_lr_scale
        self.eps = eps
        self.param_min_rms, self.param_max_rms = param_min_rms, param_max_rms
        self.scalar_max = scalar_max
        self.size_update_period = size_update_period
        self.clipping_update_period = clipping_update_period
        dev = self.params[0].device
        self.count = 0
        self.model_norms = torch.zeros(clipping_update_period,
                                       dtype=torch.float32, device=dev)
        self.model_norm_threshold = torch.tensor(math.inf, device=dev)
        self.mesh, self.layouts, self.zero1 = None, None, False
        self._init_leaves()

    def shard(self, mesh, layouts: List["pm.LeafLayout"]) -> None:
        """Run over ``mesh``: ``layouts`` (one per leaf) are
        parallel.mesh.leaf_layouts' (tensor parallelism only) or
        zero1_opt_shardings' (ZeRO-1).  Re-initialises the state, so call
        it on a fresh optimizer (and load a checkpoint after it)."""
        if self.count:
            raise ValueError("shard the optimizer before its first step")
        self.mesh, self.layouts = mesh, list(layouts)
        self.zero1 = any(l.data_axis is not None for l in self.layouts)
        # the pieces every sum over 'data' runs on, in both layouts
        self.sum_layouts = pm.with_data_axes(self.layouts, self.groups,
                                             mesh.n_data)
        self._init_leaves()

    @staticmethod
    def _scalar(group) -> bool:
        return len(group) == 1 and group[0].numel() == 1

    def _pieces(self, i: int, tensors) -> list:
        """This rank's pieces of leaf i's tensors: all of them, but under
        ZeRO-1 its data piece."""
        if not self.zero1:
            return list(tensors)
        return pm.owned_pieces(self.layouts[i], tensors, self.mesh)

    def _leaf_sums(self, fn, idx: list, leaves: list,
                   over_data: bool = False) -> list:
        """The sums fn(i, *tensors of leaf i) (0-d) of leaves ``idx``, each
        a list of per-leaf tensor lists in ``leaves``, completed over the
        mesh.  ``over_data`` (the tensors are the gradients and parameters
        of the step: ZeRO-1's pieces, or whole): a data-sharded leaf's sum
        is its pieces' partial sums added in data-rank order, the partials
        gathered under ZeRO-1 and all computed here in the replicated
        layout, each on contiguous copies.  A model-sharded leaf's sum is
        its model ranks' added in rank order.  So both layouts make the same
        additions, and no scalar is all-reduced (NCCL fixes no order)."""
        mesh = self.mesh
        whole = lambda i: [l[i] for l in leaves]
        if mesh is None or not idx:
            return [fn(i, *whole(i)) for i in idx]
        if over_data and mesh.n_data > 1:
            ranks = [mesh.data_rank] if self.zero1 else range(mesh.n_data)
            rows = {r: [] for r in ranks}
            for i in idx:
                lay = self.sum_layouts[i]
                if lay.data_axis is None:   # whole on every rank: once
                    v = fn(i, *whole(i))
                    for r in ranks:
                        rows[r].append(v if r == 0 else torch.zeros_like(v))
                    continue
                for r in ranks:
                    ts = (whole(i) if self.zero1 else
                          [pm.owned_pieces(lay, l[i], mesh, r) for l in leaves])
                    rows[r].append(fn(i, *[[t.contiguous() for t in l]
                                           for l in ts]))
            v = torch.stack([torch.stack(rows[r]) for r in ranks])
            if self.zero1:
                v = pm.stack_ranks(v[0], mesh, "data")
            v = _in_order(v)
        else:
            v = torch.stack([fn(i, *whole(i)) for i in idx])
        if mesh.n_model > 1:
            on = torch.tensor([self.layouts[i].model_axis is not None
                               for i in idx], device=v.device)
            v = torch.where(on, _in_order(pm.stack_ranks(v, mesh, "model")),
                            v)
        return list(v.unbind(0))

    def _rms(self, params: list, idx: list) -> list:
        """The parameter rms of leaves ``idx`` (params: every leaf's whole
        local f32 tensors)."""
        sums = self._leaf_sums(lambda i, ps: sum(p.square().sum() for p in ps),
                               idx, [params])
        out = []
        for i, s in zip(idx, sums):
            n = sum(p.numel() for p in params[i])
            if self.mesh is not None and self.layouts[i].model_axis is not None:
                n *= self.mesh.n_model
            out.append((s / n).sqrt())
        return out

    def _init_leaves(self) -> None:
        params = [[p.detach().float() for p in g] for g in self.groups]
        idx = [i for i, g in enumerate(self.groups) if not self._scalar(g)]
        rms = dict(zip(idx, self._rms(params, idx)))
        self.leaves = []
        for i, ps in enumerate(params):
            r = rms.get(i, torch.zeros((), device=ps[0].device))
            mine = self._pieces(i, ps)
            self.leaves.append({
                "delta": [torch.zeros_like(p) for p in mine],
                "exp_avg_sq": [torch.zeros_like(p) for p in mine],
                "param_rms": r, "scale_exp_avg_sq": torch.zeros_like(r),
                "scale_grads": r.new_zeros(self.size_update_period)})

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        step, P = self.count, self.size_update_period
        lr = float(self.lr_fn(step))
        beta1, beta2, eps = self.beta1, self.beta2, self.eps
        grads = [_grads(g) for g in self.groups]
        full = [[p.detach().float() for p in g] for g in self.groups]
        if self.mesh is not None and self.mesh.n_data > 1:
            # the sum over 'data': ZeRO-1 keeps its piece of it, the
            # replicated layout gathers the pieces
            summed = pm.scatter_grads if self.zero1 else pm.sum_grads
            grads = [summed(l, gs, self.mesh)
                     for l, gs in zip(self.sum_layouts, grads)]
        params = [self._pieces(i, ps) for i, ps in enumerate(full)]
        every = list(range(len(self.groups)))

        # adaptive clipping (reference optim.py:316-412): the clip factor
        # scales only the scale-gradient record
        clip = 1.0
        if self.clipping_scale is not None:
            C = self.clipping_update_period
            def sumsq(i, gs):
                w = 1.0 if self._scalar(self.groups[i]) else \
                    self.leaves[i]["param_rms"]
                return sum((g * w).square().sum() for g in gs)
            tot_sumsq = sum(self._leaf_sums(sumsq, every, [grads],
                                            over_data=True))
            tot_norm = tot_sumsq.sqrt()
            slot = step % C
            self.model_norms[slot] = tot_norm
            if slot == 0 and step > 0:
                median = self.model_norms.sort().values[min(C - 1, (C // 4) * 2)]
                self.model_norm_threshold = self.clipping_scale * median
            if step >= C:
                clip = (self.model_norm_threshold
                        / (tot_norm + 1e-20)).clamp(max=1.0)

        slot4 = step % P
        is_rms_step = slot4 == P - 1
        do_size = is_rms_step and step > 0
        beta2_corr = beta2 ** P
        bc2_size = 1.0 - beta2_corr ** ((step + 1) // P)
        bc2_main = 1.0 - beta2 ** (step + 1)
        lr_s = -lr * self.scalar_lr_scale

        # the scale gradient of this step (optim.py:506-510) and, every P
        # steps, the parameter rms (optim.py:511-517), of each tensor leaf
        idx = [i for i, g in enumerate(self.groups) if not self._scalar(g)]
        scale_grads = dict(zip(idx, self._leaf_sums(
            lambda i, ps, gs: sum((pf * (g * clip)).sum()
                                  for pf, g in zip(ps, gs)),
            idx, [params, grads], over_data=True)))
        new_rms = dict(zip(idx, self._rms(full, idx))) if is_rms_step else {}

        for i, (grp, gs, ps, st) in enumerate(zip(self.groups, grads, params,
                                                   self.leaves)):
            if self._scalar(grp):  # the scalar path (reference optim.py:639-661)
                (p,), (g,), (pf,) = grp, gs, ps
                eas = st["exp_avg_sq"][0] * beta2 + (1 - beta2) * g * g
                denom = (eas / bc2_main).sqrt() + eps
                delta = st["delta"][0] * beta1 + g / denom * (lr_s * (1 - beta1))
                new_p = pf.clamp(-self.scalar_max, self.scalar_max) + delta
                st["delta"], st["exp_avg_sq"] = [delta], [eas]
                p.add_((new_p - pf).to(p.dtype))
                continue

            st["scale_grads"][slot4] = scale_grads[i]
            if is_rms_step:
                st["param_rms"] = new_rms[i]
            rms = st["param_rms"]
            scale_step = None
            if do_size:  # the size update (optim.py:531-596)
                sg = st["scale_grads"]
                seas = (st["scale_exp_avg_sq"] * beta2_corr
                        + sg.square().mean() * (1 - beta2_corr))
                scale_step = (lr_s * math.sqrt(bc2_size) * sg.sum()
                              / (seas.sqrt() + eps))
                scale_step = torch.where(rms < self.param_min_rms, 0.0,
                                         scale_step)
                scale_step = torch.where(rms > self.param_max_rms, lr_s * P,
                                         scale_step)
                st["scale_exp_avg_sq"] = seas

            # the main step (optim.py:598-637)
            alpha = -lr * (1 - beta1) * rms.clamp(min=self.param_min_rms)
            deltas = []
            for j, (g, pf) in enumerate(zip(gs, ps)):
                delta = st["delta"][j] * beta1
                if scale_step is not None:
                    delta = delta + pf * scale_step * (1 - beta1)
                eas = st["exp_avg_sq"][j] * beta2 + (1 - beta2) * g * g
                denom = (eas / bc2_main if bc2_main < 0.99 else eas).sqrt() + eps
                delta = delta + (g / denom) * alpha
                st["delta"][j], st["exp_avg_sq"][j] = delta, eas
                deltas.append(delta)
            if self.zero1:  # every rank adds the whole update
                deltas = pm.gather_pieces(self.layouts[i], deltas, self.mesh)
            for p, delta in zip(grp, deltas):
                p.add_(delta.to(p.dtype))
        self.count += 1

    def _leaf_state(self, i: int, key: str, to_mesh: bool) -> list:
        """Leaf i's ``key`` moments re-laid: from this rank's pieces to the
        global tensors, or (``to_mesh``) back."""
        layout, v = self.layouts[i], self.leaves[i][key]
        if to_mesh:
            return self._pieces(i, pm.slice_model_pieces(layout, v, self.mesh))
        if self.zero1:
            v = pm.gather_pieces(layout, v, self.mesh)
        return pm.gather_model_pieces(layout, v, self.mesh)

    def state_dict(self) -> dict:
        """The update count and the state; over a mesh, the moments
        gathered to their global shapes (every rank must call it)."""
        leaves = self.leaves
        if self.mesh is not None:
            leaves = [dict(leaf, **{k: self._leaf_state(i, k, False)
                                    for k in ("delta", "exp_avg_sq")})
                      for i, leaf in enumerate(self.leaves)]
        return {"count": self.count, "model_norms": self.model_norms,
                "model_norm_threshold": self.model_norm_threshold,
                "leaves": leaves}

    def load_state_dict(self, sd: dict) -> None:
        dev = self.model_norms.device
        to = lambda v: [t.to(dev) for t in v] if isinstance(v, list) else v.to(dev)
        self.count = int(sd["count"])
        self.model_norms = to(sd["model_norms"])
        self.model_norm_threshold = to(sd["model_norm_threshold"])
        if len(sd["leaves"]) != len(self.groups):
            raise ValueError(f"optimizer state has {len(sd['leaves'])} "
                             f"leaves, the model {len(self.groups)}")
        self.leaves = [{k: to(v) for k, v in leaf.items()}
                       for leaf in sd["leaves"]]
        if self.mesh is not None:
            for i, leaf in enumerate(self.leaves):
                for k in ("delta", "exp_avg_sq"):
                    leaf[k] = [t.clone() for t in
                               self._leaf_state(i, k, True)]


class AdamW:
    """The reference's AdamW (steps/trainer.py:436): torch.optim.AdamW with
    betas (0.9, 0.999), eps 1e-8, decoupled weight decay, and the lr of
    ``lr(update count)`` at each step (optax.adamw's schedule).

    ``groups``: the parameters as the JAX package's optimizer leaves
    (:func:`stacked_leaves`), which ZeRO-1 shards (default: one leaf per
    tensor).  Under ZeRO-1 (``shard``) torch's AdamW runs over copies of
    this rank's pieces of the parameters, which the update all-gathers
    into them."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule,
                 weight_decay: float = 1e-2, groups: Optional[Iterable] = None):
        self.lr_fn = _schedule(lr)
        self.count = 0
        self.params = list(params)
        self.groups = ([tuple(g) for g in groups] if groups is not None
                       else [(p,) for p in self.params])
        self.hyper = dict(lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                          weight_decay=weight_decay)
        self.opt = torch.optim.AdamW(self.params, **self.hyper)
        self.mesh, self.layouts, self.zero1 = None, None, False
        self.pieces = [list(g) for g in self.groups]

    def shard(self, mesh, layouts: List["pm.LeafLayout"]) -> None:
        """Run over ``mesh`` with ``layouts``, one per group (see
        ScaledAdam.shard); a fresh optimizer only."""
        if self.count:
            raise ValueError("shard the optimizer before its first step")
        self.mesh, self.layouts = mesh, list(layouts)
        self.zero1 = any(l.data_axis is not None for l in self.layouts)
        self.sum_layouts = pm.with_data_axes(self.layouts, self.groups,
                                             mesh.n_data)
        if self.zero1:
            self.pieces = [[t.detach().clone() for t in
                            pm.owned_pieces(l, g, mesh)]
                           for l, g in zip(self.layouts, self.groups)]
            self.opt = torch.optim.AdamW(
                [t for ps in self.pieces for t in ps], **self.hyper)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for group in self.opt.param_groups:
            group["lr"] = float(self.lr_fn(self.count))
        if not self.zero1:
            if self.mesh is not None and self.mesh.n_data > 1:
                # the sum over 'data' through ZeRO-1's reduce-scatter
                for l, g in zip(self.sum_layouts, self.groups):
                    for p, gr in zip(g, pm.sum_grads(l, _grads(g), self.mesh)):
                        p.grad = gr.to(p.dtype)
            self.opt.step()
            self.count += 1
            return
        for l, g, ps in zip(self.layouts, self.groups, self.pieces):
            for t, gr in zip(ps, pm.scatter_grads(l, _grads(g), self.mesh)):
                t.grad = gr.to(t.dtype)
        self.opt.step()
        for l, g, ps in zip(self.layouts, self.groups, self.pieces):
            for p, new in zip(g, pm.gather_pieces(l, ps, self.mesh)):
                p.copy_(new)
        self.count += 1

    def _moments(self) -> list:
        """[(param index, {exp_avg, exp_avg_sq, step})] of every parameter
        over the mesh, global shapes (collective)."""
        index = {id(p): i for i, p in enumerate(self.params)}
        out = []
        for l, g, ps in zip(self.layouts, self.groups, self.pieces):
            states = [self.opt.state.get(t, {}) for t in ps]
            if not all(states):
                continue
            st = {}
            for k in ("exp_avg", "exp_avg_sq"):
                v = [s[k] for s in states]
                if self.zero1:
                    v = pm.gather_pieces(l, v, self.mesh)
                st[k] = pm.gather_model_pieces(l, v, self.mesh)
            for j, p in enumerate(g):
                out.append((index[id(p)], {"step": states[0]["step"],
                                           "exp_avg": st["exp_avg"][j],
                                           "exp_avg_sq": st["exp_avg_sq"][j]}))
        return out

    def state_dict(self) -> dict:
        """The update count and torch's AdamW state over the parameters in
        order; over a mesh, gathered to global shapes (every rank must call
        it)."""
        sd = self.opt.state_dict()
        if self.mesh is not None:
            sd = {"state": dict(sorted(self._moments())),
                  "param_groups": [dict(sd["param_groups"][0],
                                        params=list(range(len(self.params))))]}
        return {"count": self.count, "adamw": sd}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        if self.mesh is None:
            self.opt.load_state_dict(sd["adamw"])
            return
        state, pg = sd["adamw"]["state"], sd["adamw"]["param_groups"][0]
        for group in self.opt.param_groups:
            group.update({k: v for k, v in pg.items() if k != "params"})
        index = {id(p): i for i, p in enumerate(self.params)}
        for l, g, ps in zip(self.layouts, self.groups, self.pieces):
            if index[id(g[0])] not in state:
                continue
            moments = {}
            for k in ("exp_avg", "exp_avg_sq"):
                v = pm.slice_model_pieces(
                    l, [state[index[id(p)]][k].to(p.device) for p in g],
                    self.mesh)
                if self.zero1:
                    v = pm.owned_pieces(l, v, self.mesh)
                moments[k] = v
            for j, t in enumerate(ps):
                self.opt.state[t] = {
                    "step": state[index[id(g[0])]]["step"].clone(),
                    "exp_avg": moments["exp_avg"][j].clone(),
                    "exp_avg_sq": moments["exp_avg_sq"][j].clone()}
