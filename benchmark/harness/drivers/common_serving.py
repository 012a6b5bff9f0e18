"""What the serving drivers share: the sampled requests to check, and the
check itself against the reference (and, for a control, a lower
precision in the program's place)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import traffic as tr
from ..check import served_gap, silence_repeats
from ..common import Check, checks_json


def bias_stop_code(ctx, code: int, bias: float) -> None:
    """Add ``bias`` to codebook 0's head bias of ``code`` in the seed's
    weights, for the program and the reference alike.  Random weights put
    a stop code first at random steps, so a seed would change how long its
    requests run: a traffic file lowers its stop code's bias so that its
    own length limits end them."""
    def edit(st):
        st["heads.b2"][0, code] += bias
    ctx.state_edits.append(edit)


def pick_checked(done: Sequence, n: int, seed: int, length) -> List:
    """``n`` of the finished greedy requests ``done``: the longest by
    ``length``, then others drawn from the seed."""
    if not done:
        return []
    order = sorted(range(len(done)), key=lambda i: -length(done[i]))
    rest = list(tr.rng_for(seed, 2).permutation(order[1:]))
    return [done[i] for i in [order[0]] + rest[:max(0, n - 1)]]


def _served_checks(worst: float, total: float, cells: int, limits: dict
                   ) -> List[Check]:
    """The widest gap, the mean gap where the traffic file gives it a
    limit, and the count of cells compared."""
    nan = float("nan")
    checks = [Check("logit_gap", worst if cells else nan, limits["logit_gap"])]
    if "logit_gap_mean" in limits:
        checks.append(Check("logit_gap_mean", total / cells if cells else nan,
                            limits["logit_gap_mean"]))
    checks.append(Check("cells_compared", cells, limits["min_cells"],
                        at_least=True))
    return checks


def check_served(ctx, items, kv: str = "exact"):
    """Checks of served TTS rows: items are (x [Lx], prompt [K, T], rows
    [n, K]).  Returns (checks, details).  With ``ctx.control`` the checks
    are the control's: in each compared cell the code that the control's
    lower precision puts first takes the served code's place, so a sound
    control makes ``correct`` false; the program's own checks go to
    ``details["program"]``."""
    cfg, limits = ctx.cfg, ctx.traffic["limits"]
    V = cfg["audio_vocab_size"]
    from .tts_closed import _scfg
    scfg = _scfg(ctx.traffic["sampling"])      # what the program was told
    silence, stop_rep = scfg.silence_tokens, scfg.stop_repetition
    weights = ctx.traffic.get("reference_weights", "exact")
    ref, _ = ctx.reference(weights)
    ctrl = None
    if ctx.control:
        ctrl, _ = ctx.reference(ctx.traffic["control_weights"],
                                ctx.traffic.get("control_acts", "exact"))
    dev = ctx.device
    # (widest gap, summed gap, cells) of the program and of the control
    acc = {"program": [0.0, 0.0, 0], "control": [0.0, 0.0, 0]}

    def add(side, gap, total, cells):
        if cells:
            a = acc[side]
            a[0], a[1], a[2] = max(a[0], gap), a[1] + total, a[2] + cells

    per_req = []
    for x, prompt, rows in items:
        x_t = torch.as_tensor(np.asarray(x), dtype=torch.long, device=dev)
        p_t = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=dev)
        r_t = torch.as_tensor(np.asarray(rows), dtype=torch.long, device=dev)
        n, T = r_t.shape[0], p_t.shape[1]
        if n == 0:
            continue
        cols = ref.tts_columns(p_t, r_t[:n - 1])
        kw = dict(kv=kv, decode_from=T + 1, out_from=T)
        logits = ref.logits(x_t, cols, **kw)
        gap, total, m = served_gap(logits, r_t, V, silence,
                                   stop_repetition=stop_rep)
        add("program", gap, total, m)
        entry = {"rows": n, "cells": m, "gap": gap,
                 "silence_repeats": silence_repeats(r_t, silence, stop_rep)}
        if ctrl is not None:
            cg, ct, _ = served_gap(logits, r_t, V, silence,
                                   ctrl.logits(x_t, cols, **kw), stop_rep)
            add("control", cg, ct, m)
            entry["control_gap"] = cg
        per_req.append(entry)
    for e in per_req:
        ctx.log(f"checked request: {e}")
    program = _served_checks(*acc["program"], limits)
    details = {"requests": per_req}
    if ctrl is None:
        return program, details
    details["program"] = checks_json(program)
    return _served_checks(*acc["control"], limits), details
