"""Routed SwiGLU experts with no host sync (the expert layers of
models/deepseek_v2.py).

A step of T rows picks k experts a row (:func:`route`: the router's
product and softmax in f32, the top k in descending order, the weights
not renormalised).  The T * k (row, expert) pairs are then ordered by
expert on the device (:func:`group_by_expert`: a stable argsort, the rows
per expert and their cumulative ends), and the gate/up and down products
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

from typing import Tuple

import torch
import torch.nn.functional as F



def route(x: torch.Tensor, w_router: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights f32 [T, k], experts int64 [T, k]) of rows x [T, D]: the
    softmax of x @ w_router [D, E] computed in f32, its k largest in
    descending order (not renormalised)."""
    p = torch.softmax(x.float() @ w_router.float(), dim=-1)
    return p.topk(k, dim=-1)


def group_by_expert(experts: torch.Tensor, n_experts: int):
    """The pairs of ``experts`` [T, k] ordered by expert: (order [T * k],
    the pair index of each sorted slot; rows per expert [E] int64; their
    cumulative ends [E] int32, the grouped product's offsets)."""
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


def combine(y: torch.Tensor, order: torch.Tensor, weights: torch.Tensor
            ) -> torch.Tensor:
    """The weighted sum, f32 [T, D], of the expert outputs y [T * k, D] in
    expert order (``order``: the pair index of each): each row's k outputs
    gathered back through the inverse permutation and summed in one
    reduction over k."""
    T, k = weights.shape
    back = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    y = y.index_select(0, back).view(T, k, -1).float()
    return (y * weights[..., None]).sum(1)
