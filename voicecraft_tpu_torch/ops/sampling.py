"""Top-k / top-p (nucleus) sampling (PyTorch port of
voicecraft_tpu/ops/sampling.py).  Draws come from an explicit
``torch.Generator``, or from one generator per lane (a sequence of them,
one per entry of the leading axis); ``temperature <= 0`` means greedy
argmax."""

from __future__ import annotations

from typing import Sequence, Union

import torch

FILTER_VALUE = -1e9


def top_k_top_p_filter(logits: torch.Tensor, top_k: int,
                       top_p: float) -> torch.Tensor:
    """Filter logits [..., V].  top_k <= 0 disables top-k; top_p >= 1
    disables nucleus filtering."""
    V = logits.shape[-1]
    if top_k > 0:
        k = min(max(top_k, 1), V)
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, FILTER_VALUE)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # drop tokens past the threshold, shifted right so the first token
        # crossing it is kept
        remove = cum > top_p
        remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]],
                           dim=-1)
        thresh = sorted_logits.masked_fill(remove, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, FILTER_VALUE)
    return logits


Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


def uniform(generator: Generators, shape, device) -> torch.Tensor:
    """Uniforms of ``shape`` from one generator, or, given one generator per
    lane, lane b's block ``shape[1:]`` from generator b (the only per-lane
    work of a lane-vectorised draw)."""
    if isinstance(generator, (list, tuple)):
        if len(generator) != shape[0]:
            raise ValueError(f"{len(generator)} generators for {shape[0]} lanes")
        return torch.stack([torch.rand(shape[1:], generator=g, device=device)
                            for g in generator])
    return torch.rand(shape, generator=generator, device=device)


def sample(generator: Generators, logits: torch.Tensor,
           top_k: int = 0, top_p: float = 1.0,
           temperature: float = 1.0) -> torch.Tensor:
    """Token ids [...] from logits [..., V]: temperature, then top-k/top-p,
    then a categorical draw (Gumbel-max with uniforms from ``generator``,
    see ``uniform``).  ``temperature <= 0`` -> argmax, and ``generator`` is
    not used."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    if temperature != 1.0:
        logits = logits / temperature
    logits = top_k_top_p_filter(logits, top_k, top_p)
    u = uniform(generator, logits.shape, logits.device)
    gumbel = -torch.log(-torch.log(u))
    return (logits + gumbel).argmax(dim=-1)
