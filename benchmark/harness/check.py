"""The comparison that decides ``correct`` for a served model.

A served token is checked where the program chose it freely: a regular
audio code (below the audio vocabulary) that it emitted at a step.  The
number compared is the widest gap, over every such cell of the sampled
requests, by which the reference's logit of the served token lies below the
reference's best logit among the codes the program could have emitted
there.  The candidates are the regular codes.  Greedy tokens only: a greedy
decode emits its own best code, so a sound program's gap is rounding, and a
wrong one's is the logits' scale.

The sampler's silence-repetition penalty is followed as the sampler applies
it (``_adjust_logits`` of the port's ``models/voicecraft.py``): where the
previous row-0 code is a silence code repeated more than
``stop_repetition`` times in a row and codebook 0 has not ended, its
logit in codebook 0 is divided by the repeats less ``stop_repetition - 1``
(multiplied where negative), in the reference's logits and the control's
alike.  The repeats are counted from the served rows, from the first.

The numbers compared are that widest gap and the mean gap over the
compared cells (most of them 0, where the program's code is the
reference's best): a sound program's codes leave the reference's best only
at near-ties, a lower precision's more often and farther.

The control reads the same cells under a reference in a lower precision:
the gap of the code that the lower precision puts first.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch


def _penalties(rows: torch.Tensor, silence: Iterable[int],
               stop_repetition: int) -> List[Tuple[int, int, int]]:
    """(row, code, denominator) of each row whose codebook-0 cell the
    sampler's silence-repetition penalty lowers: the previous row's code is
    a silence code and the repeats counted up to it exceed
    ``stop_repetition``.  The count follows the sampler: a row-0 code equal
    to the previous one and a silence code adds one, any other sets it to
    0; a stop code of codebook 0 is no silence code, so the count ends
    there too."""
    sil = set(silence)
    if stop_repetition <= 0 or not sil:
        return []
    out, prev, consec = [], -1, 0
    for i, code in enumerate(rows[:, 0].tolist()):
        if prev in sil and consec > stop_repetition:
            out.append((i, prev, consec - (stop_repetition - 1)))
        consec = consec + 1 if code in sil and code == prev else 0
        prev = code
    return out


def silence_repeats(rows: torch.Tensor, silence: Iterable[int],
                    stop_repetition: int) -> Tuple[int, int]:
    """(rows whose codebook-0 code repeats the previous row's silence code,
    rows the sampler's penalty lowered): what the served rows give the
    penalty rule to do, for the run's log."""
    sil = set(silence)
    code0 = rows[:, 0].tolist()
    same = sum(1 for a, b in zip(code0, code0[1:]) if a == b and a in sil)
    return same, len(_penalties(rows, silence, stop_repetition))


def _penalised(logits: torch.Tensor, hits: List[Tuple[int, int, int]]
               ) -> torch.Tensor:
    """``logits`` [n, K, card] f32 with the penalty applied in codebook 0 at
    each (row, code, denominator) of ``hits``."""
    if not hits:
        return logits
    r, c, d = (torch.tensor(v, device=logits.device) for v in zip(*hits))
    out = logits.clone()
    v = out[r, 0, c]
    out[r, 0, c] = torch.where(v < 0, v * d, v / d)
    return out


def served_gap(ref_logits: torch.Tensor, rows: torch.Tensor, V: int,
               silence: Iterable[int] = (),
               ctrl_logits: Optional[torch.Tensor] = None,
               stop_repetition: int = 0) -> Tuple[float, float, int]:
    """(widest gap, summed gap, cells compared) of served ``rows`` [n, K]
    against the reference's logits [n, K, card] predicting them, under the
    sampler's penalty of ``silence`` codes repeated more than
    ``stop_repetition`` times.  With ``ctrl_logits`` the gap is that of the
    control's first choice in each of the same cells."""
    rows = rows.long()
    card = ref_logits.shape[-1]
    hits = _penalties(rows, silence, stop_repetition)
    not_code = torch.arange(card, device=rows.device) >= V
    free = rows < V
    ref = _penalised(ref_logits.float(), hits).masked_fill(not_code,
                                                           float("-inf"))
    best = ref.amax(-1)
    if ctrl_logits is None:
        chosen = rows
    else:
        chosen = _penalised(ctrl_logits.float(), hits).masked_fill(
            not_code, float("-inf")).argmax(-1)
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
