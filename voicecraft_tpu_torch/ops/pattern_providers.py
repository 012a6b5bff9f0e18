"""General codebook-pattern providers (PyTorch port of
voicecraft_tpu/ops/pattern_providers.py; reference
models/codebooks_patterns.py:280-537).

VoiceCraft itself only instantiates the delayed pattern (ops/patterns.py,
in closed form).  This module carries the rest of the reference's provider
family (Delayed with arbitrary delays / flatten_first / empty_initial,
Parallel, Unrolled, VALLE, MusicLM): each layout is composed once on the
host in numpy and compiled into a gather-index matrix, so ``build`` /
``revert`` are one ``index_select`` each, on the device of the tensor they
are given.  No model path calls it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# layout: for each sequence step, a list of (t, q) coordinates
Layout = List[List[Tuple[int, int]]]


@dataclass
class Pattern:
    """An interleaving layout + gather-index compilation (reference
    codebooks_patterns.py:20-266)."""

    layout: Layout
    n_q: int
    timesteps: int

    def __post_init__(self):
        # validity checks mirror reference Pattern._validate_layout
        q_ts = {q: 0 for q in range(self.n_q)}
        for s, coords in enumerate(self.layout):
            qs = set()
            for t, q in coords:
                qs.add(q)
                assert t >= q_ts[q], f"past timestep at step {s} (q={q})"
                q_ts[q] = t
            assert len(qs) == len(coords), f"duplicate codebook at step {s}"

    @property
    def num_sequence_steps(self) -> int:
        return len(self.layout) - 1

    @property
    def max_delay(self) -> int:
        mx = 0
        for coords in self.layout[1:]:
            for t, _ in coords:
                mx = max(mx, t + 1)
        return mx - self.timesteps

    @property
    def valid_layout(self) -> Layout:
        return self.layout[:len(self.layout) - self.max_delay]

    # ---- index compilation -----------------------------------------------------

    def build_indexes(self, keep_only_valid_steps: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """[K, S] gather indexes into flattened [K*T]+special, + mask."""
        ref = self.valid_layout if keep_only_valid_steps else self.layout
        T, K = self.timesteps, self.n_q
        idx = np.full((K, len(ref)), K * T, np.int64)
        mask = np.zeros((K, len(ref)), bool)
        for s, coords in enumerate(ref):
            for t, q in coords:
                if t < T:
                    idx[q, s] = t + q * T
                    mask[q, s] = True
        return idx, mask

    def revert_indexes(self, sequence_steps: int,
                       keep_only_valid_steps: bool = False,
                       is_model_output: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """[K, T] gather indexes into flattened [K*S]+special, + mask."""
        ref = self.valid_layout if keep_only_valid_steps else self.layout
        assert sequence_steps <= len(ref), (sequence_steps, len(ref))
        if is_model_output:
            ref = ref[1:]
        T, K = self.timesteps, self.n_q
        idx = np.full((K, T), K * sequence_steps, np.int64)
        mask = np.zeros((K, T), bool)
        for s, coords in enumerate(ref):
            if s >= sequence_steps:
                break
            for t, q in coords:
                if t < T:
                    idx[q, t] = s + q * sequence_steps
                    mask[q, t] = True
        return idx, mask

    # ---- apply -------------------------------------------------------------------

    def _take(self, x: torch.Tensor, idx: np.ndarray, special_token: int,
              n_out: int) -> torch.Tensor:
        """x [..., K, N] flattened with one special slot appended, gathered
        at idx [K, n_out] -> [..., K, n_out] on x's device."""
        lead, K = x.shape[:-2], x.shape[-2]
        flat = torch.cat([x.reshape(*lead, -1),
                          torch.full((*lead, 1), special_token,
                                     dtype=x.dtype, device=x.device)], dim=-1)
        out = flat.index_select(-1, torch.from_numpy(idx.reshape(-1))
                                .to(x.device))
        return out.reshape(*lead, K, n_out)

    def build(self, z: torch.Tensor, special_token: int,
              keep_only_valid_steps: bool = False):
        """[..., K, T] -> ([..., K, S], indexes, mask) like the reference's
        build_pattern_sequence."""
        idx, mask = self.build_indexes(keep_only_valid_steps)
        K, T = z.shape[-2], z.shape[-1]
        assert K == self.n_q and T == self.timesteps, (z.shape, self.n_q,
                                                       self.timesteps)
        return self._take(z, idx, special_token, idx.shape[1]), idx, mask

    def revert(self, s: torch.Tensor, special_token: int,
               keep_only_valid_steps: bool = False):
        """[..., K, S] -> ([..., K, T], indexes, mask)."""
        idx, mask = self.revert_indexes(s.shape[-1], keep_only_valid_steps)
        return self._take(s, idx, special_token, self.timesteps), idx, mask


# ==============================================================================
# providers (reference codebooks_patterns.py:302-537)
# ==============================================================================

def delayed_pattern(timesteps: int, n_q: int,
                    delays: Optional[Sequence[int]] = None,
                    flatten_first: int = 0, empty_initial: int = 0
                    ) -> Pattern:
    """DelayedPatternProvider.get_pattern (codebooks_patterns.py:302-352)."""
    if delays is None:
        delays = list(range(n_q))
    assert len(delays) == n_q and sorted(delays) == list(delays)
    out: Layout = [[]]
    max_delay = max(delays)
    out += [[] for _ in range(empty_initial)]
    if flatten_first:
        for t in range(min(timesteps, flatten_first)):
            for q in range(n_q):
                out.append([(t, q)])
    for t in range(flatten_first, timesteps + max_delay):
        v = []
        for q, delay in enumerate(delays):
            t_for_q = t - delay
            if t_for_q >= flatten_first:
                v.append((t_for_q, q))
        out.append(v)
    return Pattern(out, n_q, timesteps)


def parallel_pattern(timesteps: int, n_q: int) -> Pattern:
    """ParallelPatternProvider — the delayed pattern with zero delays."""
    return delayed_pattern(timesteps, n_q, delays=[0] * n_q)


def unrolled_pattern(timesteps: int, n_q: int,
                     flattening: Optional[Sequence[int]] = None,
                     delays: Optional[Sequence[int]] = None) -> Pattern:
    """UnrolledPatternProvider.get_pattern (codebooks_patterns.py:366-488):
    flatten codebooks into inner steps (optionally grouped) with per-group
    delays."""
    if flattening is None:
        flattening = list(range(n_q))
    if delays is None:
        delays = [0] * n_q
    assert len(flattening) == n_q and sorted(flattening) == list(flattening)
    assert len(delays) == n_q and sorted(delays) == list(delays)
    groups = {}  # inner_step -> (codebooks, delay)
    for q, (inner, delay) in enumerate(zip(flattening, delays)):
        if inner in groups:
            cbs, d = groups[inner]
            assert d == delay, "inconsistent delay within a flattened group"
            cbs.append(q)
        else:
            groups[inner] = ([q], delay)
    num_inner = max(groups) + 1
    max_delay = max(delays)

    indexed: List[Tuple[int, List[Tuple[int, int]]]] = [(-1, [])]
    max_t = timesteps + max_delay
    for t in range(max_t):
        for step in range(num_inner):
            if step in groups:
                cbs, delay = groups[step]
                t_for_q = t + delay
                if t_for_q < max_t:
                    indexed.append((t_for_q, [(t, q) for q in cbs]))
            else:
                indexed.append((t, []))
    # lexicographic sort on (t_for_q, coords) — the reference's
    # ``sorted(indexed_out)`` tie-breaks equal timesteps on the coord lists
    layout = [coords for _, coords in sorted(indexed)]
    return Pattern(layout, n_q, timesteps)


def valle_pattern(timesteps: int, n_q: int,
                  delays: Optional[Sequence[int]] = None) -> Pattern:
    """VALLEPattern.get_pattern (codebooks_patterns.py:490-516): the first
    codebook fully, then the remaining codebooks (with optional delays)."""
    if delays is None:
        delays = [0] * (n_q - 1)
    assert len(delays) == n_q - 1 and sorted(delays) == list(delays)
    out: Layout = [[]]
    for t in range(timesteps):
        out.append([(t, 0)])
    max_delay = max(delays) if delays else 0
    for t in range(timesteps + max_delay):
        v = []
        for q, delay in enumerate(delays):
            t_for_q = t - delay
            if t_for_q >= 0:
                v.append((t_for_q, q + 1))
        out.append(v)
    return Pattern(out, n_q, timesteps)


def musiclm_pattern(timesteps: int, n_q: int, group_by: int = 2) -> Pattern:
    """MusicLMPattern.get_pattern (codebooks_patterns.py:519-537): full
    flattening, grouped ``group_by`` codebooks at a time."""
    out: Layout = [[]]
    for offset in range(0, n_q, group_by):
        for t in range(timesteps):
            for q in range(offset, min(offset + group_by, n_q)):
                out.append([(t, q)])
    return Pattern(out, n_q, timesteps)


PROVIDERS = {
    "delay": delayed_pattern,
    "parallel": parallel_pattern,
    "unroll": unrolled_pattern,
    "valle": valle_pattern,
    "musiclm": musiclm_pattern,
}
