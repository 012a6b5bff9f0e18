"""The served-code check under the sampler's silence-repetition penalty: a
silence code that the program repeats stays a candidate, and its logit
is lowered only where the sampler lowers it, by the sampler's amount."""

import math

import pytest
import torch

from harness.check import _penalised, _penalties, served_gap, silence_repeats

V, CARD, SIL = 10, 12, 3


def _logits(n, best_code):
    """[n, 1, CARD]: each row's best regular code is ``best_code``, the
    next best 7 at 1.0 below it; a special code above both."""
    g = torch.Generator().manual_seed(5)
    lg = torch.rand((n, 1, CARD), generator=g) - 2.0
    lg[:, 0, best_code] = 2.0
    lg[:, 0, 7] = 1.0
    lg[:, 0, V:] = 9.0
    return lg


def _gap_dropping_the_repeat(ref_logits, rows, silence):
    """The widest gap under the rule the check had before: codebook 0's
    previous code left out of the candidates whenever it is a silence
    code."""
    n = rows.shape[0]
    ok = torch.zeros(ref_logits.shape, dtype=torch.bool)
    ok[..., :V] = True
    for i in range(1, n):
        if int(rows[i - 1, 0]) in silence:
            ok[i, 0, rows[i - 1, 0]] = False
    ref = ref_logits.masked_fill(~ok, float("-inf"))
    picked = ref.gather(-1, rows[..., None])[..., 0]
    return float((ref.amax(-1) - picked).max())


def test_a_silence_repeat_below_the_threshold_is_no_fault():
    """Greedy rows that repeat a silence code twice, under stop_repetition
    3: the sampler applies no penalty, so the repeat is the program's own
    best code and its gap is 0.  Leaving the code out of the candidates
    read an infinite gap (null in the result line)."""
    rows = torch.tensor([[1], [SIL], [SIL], [SIL], [4]])
    lg = _logits(5, SIL)
    lg[0, 0, 1] = 3.0
    lg[4, 0, 4] = 3.0
    assert _penalties(rows, [SIL], 3) == []
    assert silence_repeats(rows, [SIL], 3) == (2, 0)
    assert _gap_dropping_the_repeat(lg, rows, {SIL}) == math.inf
    gap, total, cells = served_gap(lg, rows, V, [SIL], stop_repetition=3)
    assert (gap, total, cells) == (0.0, 0.0, 5)


@pytest.mark.parametrize("best", [2.0, -0.5])
def test_a_silence_repeat_above_the_threshold_is_penalised(best):
    """Under stop_repetition 3 the fifth row of one silence code has made
    the count 4 when the sixth is drawn: its logit is divided by 4 - 2
    (multiplied where negative).  The greedy program then emits the next
    best code, which the check reads as the best; emitting the silence
    code again reads the gap by which the penalty put it below."""
    rows = torch.tensor([[SIL]] * 5 + [[7]])
    lg = _logits(6, SIL)
    lg[:, 0, SIL] = best
    lg[:, 0, 7] = best - 1.0
    lg[5, 0, 7] = 1.5 if best > 0 else -0.8     # between the penalised and best
    assert _penalties(rows, [SIL], 3) == [(5, SIL, 2)]
    assert silence_repeats(rows, [SIL], 3) == (4, 1)
    penalised = best / 2 if best > 0 else best * 2
    assert float(_penalised(lg, [(5, SIL, 2)])[5, 0, SIL]) == penalised
    gap, _, cells = served_gap(lg, rows, V, [SIL], stop_repetition=3)
    assert gap == 0.0 and cells == 6
    rows[5, 0] = SIL
    gap, _, _ = served_gap(lg, rows, V, [SIL], stop_repetition=3)
    assert gap == pytest.approx(float(lg[5, 0, 7]) - penalised)
    # without the penalty (stop_repetition 0 turns it off, as in the sampler)
    assert served_gap(lg, rows, V, [SIL], stop_repetition=0)[0] == 0.0


def test_the_penalty_is_the_samplers():
    """Along served rows the check lowers the same cells by the same amount
    as the port's sampler (``_adjust_logits``) does, fed the silence count
    and previous code that its own finalisation keeps."""
    from voicecraft_tpu_torch.config import PRESETS
    from voicecraft_tpu_torch.models.voicecraft import (SamplingConfig,
                                                        _adjust_logits)
    cfg = PRESETS["tiny_test"]()
    Vt, K = cfg.audio_vocab_size, cfg.n_codebooks
    card = Vt + cfg.n_special
    scfg = SamplingConfig(stop_repetition=2, silence_tokens=(5, 9))
    code0 = [5, 5, 5, 5, 5, 9, 9, 9, 9, 9, 9, 1, 5, 5, 5, 5]
    rows = torch.tensor([[c] + [2] * (K - 1) for c in code0])
    lg = torch.randn((len(code0), K, card), generator=torch.Generator()
                     .manual_seed(1))
    ours = _penalised(lg, _penalties(rows, scfg.silence_tokens,
                                     scfg.stop_repetition))
    consec, prev = 0, -1
    for i, code in enumerate(code0):
        theirs = _adjust_logits(
            cfg, scfg, True, lg[i], torch.zeros(K, dtype=torch.bool),
            torch.tensor(100), torch.tensor(consec), torch.tensor(prev))
        torch.testing.assert_close(ours[i, :, :Vt], theirs[:, :Vt],
                                   rtol=0, atol=0)
        consec = consec + 1 if code in scfg.silence_tokens and \
            code == prev else 0
        prev = code
    assert not torch.equal(ours, lg)
