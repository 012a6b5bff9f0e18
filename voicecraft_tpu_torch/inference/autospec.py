"""Online plain-vs-speculative mode selection for the serving tiers
(PyTorch port of voicecraft_tpu/inference/autospec.py; the policy is host
bookkeeping, copied as it is, and resolve_spec_arg reads the port model's
MTP heads).

Whether speculative decoding (``spec=tau``) beats plain lockstep serving is
NOT knowable offline: it depends on draft acceptance (prompt mix, sampling
temperature, MTP-head quality) and on the wave's lane count, and which tau
wins moves with both, so *tau itself is part of the decision*: the policy
is an N-armed bandit over ``{0} ∪ taus`` (0 = plain), not a plain/spec
toggle.

Design:

- Each arm keeps a small window of throughput samples (generated frames /
  wall second, timed through the host readback inside ``serve_tts_batch`` /
  ``serve_edit_batch``, or a stream's producer time).  The estimate is the
  median of the window — robust to a one-off warm-up or a straggler wave.
- Until every arm has ``probe_waves`` samples, waves rotate through the
  arms (largest tau first).
- After that the fastest arm serves every wave, except one probe of a
  rotating non-best arm every ``reprobe_every`` waves — acceptance drifts
  with the traffic mix, so an arm written off at startup can win later
  (and vice versa).
- The first sample of each arm is dropped once a second arrives: the
  first wave of a geometry pays the warm-up (cuBLAS heuristics, allocator
  growth), which would poison the estimate for the process lifetime.

The policy is pure host-side bookkeeping (no device work) and arm choice
never changes greedy outputs: greedy spec serving equals the plain loop in
f32; sampled speculative output is keyed per (request, token index), so it
is invariant to tau (tests/test_torch_serving_spec.py).  Servers run one
instance per tier (TTS waves, edit waves, engine) — the tiers have
different economics, so their samples must not be pooled.
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Dict, Optional, Sequence

log = logging.getLogger("voicecraft_tpu_torch.autospec")


class AutoSpecPolicy:
    """N-armed throughput bandit over {plain} ∪ {spec=tau for tau in taus}.

    Usage (one instance per server tier; thread-safe)::

        policy = AutoSpecPolicy(taus=[4, 8])
        mode = policy.next_mode()              # 0 or one of the taus
        stats = {}
        serve_tts_batch(..., spec=mode, stats=stats)
        policy.observe(mode, stats["frames"], stats["seconds"],
                       tok_per_pass=stats["tok_per_pass"])

    ``AutoSpecPolicy(tau=8)`` (the two-armed form) means ``taus=[8]``.
    """

    def __init__(self, tau: Optional[int] = None, *,
                 taus: Optional[Sequence[int]] = None,
                 probe_waves: int = 2, reprobe_every: int = 12,
                 window: int = 4):
        if taus is None:
            assert tau is not None and tau > 1, tau
            taus = [int(tau)]
        else:
            assert tau is None, "pass either tau= or taus=, not both"
            taus = sorted({int(t) for t in taus})
            assert taus and all(t > 1 for t in taus), taus
        assert probe_waves >= 1 and reprobe_every >= 2 and window >= 2
        self.taus = list(taus)
        self.tau = self.taus[-1]        # back-compat: the deepest arm
        self.arms = [0] + self.taus
        self.probe_waves = int(probe_waves)
        self.reprobe_every = int(reprobe_every)
        self._lock = threading.Lock()
        # per-arm sample windows of frames/s
        self._samples: Dict[int, deque] = {a: deque(maxlen=window)
                                           for a in self.arms}
        self._n_obs: Dict[int, int] = {a: 0 for a in self.arms}
        self._tpp: Dict[int, Optional[float]] = {a: None for a in self.arms}
        self._since_probe = 0
        # rotation cursors: probing starts at the deepest tau
        self._probe_order = list(reversed(self.arms))
        self._probe_i = 0
        self._reprobe_i = 0

    # ---- estimates -----------------------------------------------------------

    def _estimate(self, mode: int) -> Optional[float]:
        s = self._samples[mode]
        if not s:
            return None
        vals = sorted(s)
        n = len(vals)
        return (vals[n // 2] if n % 2
                else 0.5 * (vals[n // 2 - 1] + vals[n // 2]))

    def snapshot(self) -> dict:
        """Telemetry: per-arm estimates and sample counts (for /healthz,
        logs, tests).  Keys ``plain_fps``/``spec_fps``/``n_plain``/
        ``n_spec``/``tok_per_pass`` keep their two-armed meaning (spec_* =
        the deepest arm); ``arms`` carries the full per-arm view."""
        with self._lock:
            return {
                "tau": self.tau,
                "plain_fps": self._estimate(0),
                "spec_fps": self._estimate(self.tau),
                "n_plain": self._n_obs[0],
                "n_spec": self._n_obs[self.tau],
                "tok_per_pass": self._tpp[self.tau],
                "serving_mode": self._exploit_mode(),
                "arms": {str(a): {"fps": self._estimate(a),
                                  "n": self._n_obs[a],
                                  "tok_per_pass": self._tpp[a]}
                         for a in self.arms},
            }

    def _exploit_mode(self) -> int:
        best, best_fps = None, None
        for a in self.arms:
            e = self._estimate(a)
            if e is None:
                continue
            # ties break toward the deeper arm (arms are ascending and
            # >= keeps the later/deeper candidate)
            if best_fps is None or e >= best_fps:
                best, best_fps = a, e
        if best is None:
            return self.taus[-1]        # nothing measured yet: assume spec
        return best

    # ---- the bandit ----------------------------------------------------------

    def next_mode(self) -> int:
        """Arm for the next wave: 0 (plain lockstep) or one of the taus."""
        with self._lock:
            # probe phase: rotate until every arm has enough samples
            for _ in range(len(self._probe_order)):
                m = self._probe_order[self._probe_i]
                self._probe_i = (self._probe_i + 1) % len(self._probe_order)
                if self._n_obs[m] < self.probe_waves:
                    return m
            # exploit, with a periodic probe of a rotating non-best arm
            best = self._exploit_mode()
            self._since_probe += 1
            if self._since_probe >= self.reprobe_every:
                self._since_probe = 0
                others = [a for a in self.arms if a != best]
                if others:
                    m = others[self._reprobe_i % len(others)]
                    self._reprobe_i += 1
                    return m
            return best

    def observe(self, mode: int, frames: int, seconds: float,
                tok_per_pass: Optional[float] = None) -> None:
        """Record one wave's outcome.  ``frames``/``seconds`` as filled into
        ``serve_tts_batch(stats=)``; zero-frame or zero-time waves are
        ignored (nothing to learn from an empty wave)."""
        if mode not in self._samples:
            raise ValueError(f"mode {mode} is not an arm of {self.arms}")
        if frames <= 0 or seconds <= 0:
            return
        with self._lock:
            s = self._samples[mode]
            self._n_obs[mode] += 1
            # shed the warm-up-tainted first sample once a clean one exists
            if self._n_obs[mode] == 2 and len(s) == 1:
                s.clear()
            s.append(frames / seconds)
            if tok_per_pass is not None and mode != 0:
                self._tpp[mode] = float(tok_per_pass)
            n = sum(self._n_obs.values())
        if n in (4, 16, 64):    # occasional telemetry, outside the lock
            log.info("autospec: %s", self.snapshot())


def resolve_spec_arg(value, model) -> "tuple[int, Optional[AutoSpecPolicy]]":
    """Parse a ``--spec`` CLI value into (tau, policy).

    ``0``/``1`` → plain; an int > 1 → fixed spec tau; ``"auto"`` → adaptive
    over arms {plain, 4, full depth} (deduped, capped at the model's MTP
    depth, its n_mtp head groups + 1); ``"auto:T1[,T2...]"`` → adaptive
    over exactly those taus.  Auto degrades to plain (0, None) when the
    model has no MTP heads.  The returned tau is the policy's deepest arm.
    """
    sval = str(value).strip().lower()
    if sval.startswith("auto"):
        n_mtp = len(getattr(model, "mtp_heads", None) or ())
        if n_mtp == 0:
            return 0, None
        depth = n_mtp + 1
        if ":" in sval:
            taus = [int(t) for t in sval.split(":", 1)[1].split(",")]
        else:
            # tau itself is the decision: probe a mid tau beside full depth
            taus = [4, depth]
        taus = sorted({max(2, min(t, depth)) for t in taus})
        policy = AutoSpecPolicy(taus=taus)
        return policy.tau, policy
    return int(value or 0), None
