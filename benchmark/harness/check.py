"""The comparison that decides ``correct`` for a served model.

A served token is checked where the program chose it freely: a regular
audio code (below the audio vocabulary) that it emitted at a step.  The
number compared is the widest gap, over every such cell of the sampled
requests, by which the reference's logit of the served token lies below the
reference's best logit among the codes the program could have emitted
there.  The candidates are the regular codes, less the previous row-0 code
in codebook 0 when it is a silence code (the repetition penalty may lower
it).  Greedy tokens only: a greedy decode emits its own best code, so a
sound program's gap is rounding, and a wrong one's is the logits' scale.

The numbers compared are that widest gap and the mean gap over the
compared cells (most of them 0, where the program's code is the
reference's best): a sound program's codes leave the reference's best only
at near-ties, a lower precision's more often and farther.

The control reads the same cells under a reference in a lower precision:
the gap of the code that the lower precision puts first.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch


def _candidates(rows: torch.Tensor, V: int, card: int,
                silence: Iterable[int]) -> torch.Tensor:
    """[n, K, card] bool: the codes each cell could have been."""
    n, K = rows.shape
    ok = torch.zeros((n, K, card), dtype=torch.bool, device=rows.device)
    ok[..., :V] = True
    sil = torch.tensor(sorted(silence), dtype=torch.long, device=rows.device)
    if n > 1 and sil.numel():
        prev = rows[:-1, 0]
        hit = (prev[:, None] == sil[None]).any(-1)
        r = torch.nonzero(hit)[:, 0]
        ok[r + 1, 0, prev[r]] = False
    return ok


def served_gap(ref_logits: torch.Tensor, rows: torch.Tensor, V: int,
               silence: Iterable[int] = (),
               ctrl_logits: Optional[torch.Tensor] = None
               ) -> Tuple[float, float, int]:
    """(widest gap, summed gap, cells compared) of served ``rows`` [n, K]
    against the reference's logits [n, K, card] predicting them.  With
    ``ctrl_logits`` the gap is that of the control's first choice in each
    of the same cells."""
    rows = rows.long()
    card = ref_logits.shape[-1]
    ok = _candidates(rows, V, card, silence)
    free = rows < V
    ref = ref_logits.float().masked_fill(~ok, float("-inf"))
    best = ref.amax(-1)
    if ctrl_logits is None:
        chosen = rows
    else:
        chosen = ctrl_logits.float().masked_fill(~ok, float("-inf")).argmax(-1)
    picked = ref.gather(-1, chosen.clamp(max=card - 1)[..., None])[..., 0]
    gap = torch.where(free, best - picked, torch.zeros_like(best))
    n_cells = int(free.sum())
    return (float(gap.max()) if n_cells else float("nan"),
            float(gap.double().sum()), n_cells)


def tts_rows_from_codes(gen: torch.Tensor, K: int, empty: int) -> torch.Tensor:
    """The delayed-space rows [Tg, K] that a TTS decode emitted, rebuilt
    from its generated codes [K, Tg]: row i holds codebook q's code i - q,
    the empty code before it.  Only rows whose every cell is known from the
    codes are rebuilt (the last K - 1 rows' tails are the stop cascade)."""
    Tg = gen.shape[1]
    rows = torch.full((Tg, K), empty, dtype=torch.long, device=gen.device)
    for q in range(K):
        if Tg > q:
            rows[q:, q] = gen[q, :Tg - q]
    return rows
