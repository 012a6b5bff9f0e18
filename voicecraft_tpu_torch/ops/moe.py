"""Routed SwiGLU experts with no host sync (the expert layers of
models/deepseek_v2.py and models/kimi_linear.py).

A step of T rows picks k experts a row (:func:`route`: the router's
product and its softmax or sigmoid in f32, the top k in descending order
of the scores or, with a correction bias, of the scores plus the bias;
the weights are the scores, renormalised over the k and scaled where the
configuration says so).  The T * k (row, expert) pairs are then ordered
by expert on the device (:func:`group_by_expert`: a stable argsort, the
rows per expert and their cumulative ends), and the gate/up and down
products
run over the routed rows only, each a grouped product
(``torch._grouped_mm``: one launch, expert e's weights against its own
rows, so each touched expert's weights are read once and an untouched
expert's not at all).  The combine is deterministic: each row gathers its
k outputs back (a permutation, no scatter-add) and sums them weighted, in
f32, in one reduction over k.

Nothing here reads the device from the host or takes a shape from the
routing: every tensor's shape follows from T, k and the widths, so a step
runs under ``torch.cuda.set_sync_debug_mode("error")`` and can be captured
in a CUDA graph.  (``torch.bincount`` would size its output from the
input's maximum, a host read on CUDA: the rows per expert are a comparison
against the expert ids, summed.)

Weights: gate and up side by side, ``w1`` [E, D, 2 I] (gate in the first
I columns), and ``w2`` [E, I, D], in the compute dtype.  The hidden
activation silu(gate) * up is computed in f32 and rounded once to the
compute dtype; each grouped product's output is rounded once from its f32
accumulator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def route(x: torch.Tensor, w_router: torch.Tensor, k: int,
          scoring: str = "softmax", bias: Optional[torch.Tensor] = None,
          renorm: bool = False, scale: float = 1.0
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights f32 [T, k], experts int64 [T, k]) of rows x [T, D]: the
    scores of x @ w_router [D, E] computed in f32 (``scoring`` "softmax"
    or "sigmoid") and the experts of their k largest in descending order,
    or of the scores plus ``bias`` [E] (a correction that chooses and does
    not weight); the weights are those experts' scores, divided by their
    sum (plus 1e-20) where ``renorm`` and multiplied by ``scale``."""
    logits = x.float() @ w_router.float()
    p = (torch.softmax(logits, dim=-1) if scoring == "softmax"
         else torch.sigmoid(logits))
    if bias is None:
        weights, experts = p.topk(k, dim=-1)
    else:
        experts = (p + bias.float()).topk(k, dim=-1)[1]
        weights = p.gather(-1, experts)
    if renorm:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    if scale != 1:
        weights = weights * scale
    return weights, experts


def group_by_expert(experts: torch.Tensor, n_experts: int):
    """The pairs of ``experts`` [T, k] ordered by expert: (order [T * k],
    the pair index of each sorted slot; rows per held expert [E] int64;
    their cumulative ends [E] int32, the grouped product's offsets).  The
    held experts are 0 .. n_experts - 1; pairs routed to others sort after
    theirs and are counted in no group."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ids = torch.arange(n_experts, device=flat.device)
    counts = (flat[:, None] == ids[None, :]).sum(0)
    return order, counts, counts.cumsum(0).to(torch.int32)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """Rows x [M, K] grouped by expert (group e's rows end at offs[e])
    against w [E, K, N]: [M, N] in x's dtype."""
    return torch._grouped_mm(x, w, offs=offs)


def swiglu_hidden(h: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up of a gate/up product h [..., 2 I], in f32, rounded
    once to h's dtype."""
    gate, up = h.float().chunk(2, dim=-1)
    return (F.silu(gate) * up).to(h.dtype)


def expert_products(xs: torch.Tensor, offs: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLUs of the rows xs [P, D] ordered by expert
    (group e's rows end at offs[e]): two grouped products, [P, D]."""
    return grouped_mm(swiglu_hidden(grouped_mm(xs, w1, offs)), w2, offs)


def combine(y: torch.Tensor, order: torch.Tensor, weights: torch.Tensor,
            held_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The weighted sum, f32 [T, D], of the expert outputs y [T * k, D] in
    expert order (``order``: the pair index of each): each row's k outputs
    gathered back through the inverse permutation and summed in one
    reduction over k.  ``held_rows`` (an expert share's: the grouped
    products' last offset, a 1-element tensor): only y's first held_rows
    rows hold a held expert's output; the pairs sorted after them are
    selected out, never multiplied by a zero weight."""
    T, k = weights.shape
    back = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    y = y.index_select(0, back).view(T, k, -1).float()
    if held_rows is not None:
        y = torch.where((back < held_rows).view(T, k, 1), y, 0.0)
    return (y * weights[..., None]).sum(1)
