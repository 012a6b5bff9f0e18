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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from ..models.transformer import FFN_KEYS

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
    update count and every tensor of the state."""

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
        self.leaves = [self._leaf_init(g) for g in self.groups]

    @staticmethod
    def _scalar(group) -> bool:
        return len(group) == 1 and group[0].numel() == 1

    @staticmethod
    def _rms(ps) -> torch.Tensor:
        return (sum(p.square().sum() for p in ps)
                / sum(p.numel() for p in ps)).sqrt()

    def _leaf_init(self, group) -> dict:
        ps = [p.detach().float() for p in group]
        rms = (torch.zeros((), device=ps[0].device) if self._scalar(group)
               else self._rms(ps))
        return {"delta": [torch.zeros_like(p) for p in ps],
                "exp_avg_sq": [torch.zeros_like(p) for p in ps],
                "param_rms": rms, "scale_exp_avg_sq": torch.zeros_like(rms),
                "scale_grads": rms.new_zeros(self.size_update_period)}

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        step, P = self.count, self.size_update_period
        lr = float(self.lr_fn(step))
        beta1, beta2, eps = self.beta1, self.beta2, self.eps
        grads = [[p.grad.float() if p.grad is not None
                  else torch.zeros_like(p, dtype=torch.float32) for p in g]
                 for g in self.groups]
        params = [[p.detach().float() for p in g] for g in self.groups]

        # adaptive clipping (reference optim.py:316-412): the clip factor
        # scales only the scale-gradient record
        clip = 1.0
        if self.clipping_scale is not None:
            C = self.clipping_update_period
            tot_sumsq = sum(
                sum((g * (1.0 if self._scalar(grp) else st["param_rms"]))
                    .square().sum() for g in gs)
                for grp, gs, st in zip(self.groups, grads, self.leaves))
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

        for grp, gs, ps, st in zip(self.groups, grads, params, self.leaves):
            if self._scalar(grp):  # the scalar path (reference optim.py:639-661)
                (p,), (g,), (pf,) = grp, gs, ps
                eas = st["exp_avg_sq"][0] * beta2 + (1 - beta2) * g * g
                denom = (eas / bc2_main).sqrt() + eps
                delta = st["delta"][0] * beta1 + g / denom * (lr_s * (1 - beta1))
                new_p = pf.clamp(-self.scalar_max, self.scalar_max) + delta
                st["delta"], st["exp_avg_sq"] = [delta], [eas]
                p.add_((new_p - pf).to(p.dtype))
                continue

            # the scale gradient of this step (optim.py:506-510)
            st["scale_grads"][slot4] = sum((pf * (g * clip)).sum()
                                           for pf, g in zip(ps, gs))
            if is_rms_step:  # optim.py:511-517
                st["param_rms"] = self._rms(ps)
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
            for i, (p, g, pf) in enumerate(zip(grp, gs, ps)):
                delta = st["delta"][i] * beta1
                if scale_step is not None:
                    delta = delta + pf * scale_step * (1 - beta1)
                eas = st["exp_avg_sq"][i] * beta2 + (1 - beta2) * g * g
                denom = (eas / bc2_main if bc2_main < 0.99 else eas).sqrt() + eps
                delta = delta + (g / denom) * alpha
                st["delta"][i], st["exp_avg_sq"][i] = delta, eas
                p.add_(delta.to(p.dtype))
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "model_norms": self.model_norms,
                "model_norm_threshold": self.model_norm_threshold,
                "leaves": self.leaves}

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


class AdamW:
    """The reference's AdamW (steps/trainer.py:436): torch.optim.AdamW with
    betas (0.9, 0.999), eps 1e-8, decoupled weight decay, and the lr of
    ``lr(update count)`` at each step (optax.adamw's schedule)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule,
                 weight_decay: float = 1e-2):
        self.lr_fn = _schedule(lr)
        self.count = 0
        self.opt = torch.optim.AdamW(list(params), lr=0.0, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group in self.opt.param_groups:
            group["lr"] = float(self.lr_fn(self.count))
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw": self.opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        self.opt.load_state_dict(sd["adamw"])
