"""The general traffic generator: a traffic file's parameters and a seed in,
requests out.

Every seed gets the same multiset of sizes (and, in an open loop, the same
set of gaps between arrivals), in an order drawn from the seed, so seeds
change which tokens a request carries and in what order the sizes come,
and not how much work a run holds.  Token ids are drawn per request from
the seed and the request's index."""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Request:
    index: int
    prompt_frames: int          # T of the voice prompt [K, T]
    gen: int                    # the generation budget, in the traffic's unit
    phones: int                 # text tokens
    greedy: bool
    x: np.ndarray               # [phones] int
    prompt: np.ndarray          # [K, T] int
    due_s: float = 0.0          # open loop: when it is due, from the start


def rng_for(seed: int, *path: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed % (2 ** 63), *path])))


def size_set(t: dict) -> List[dict]:
    """The traffic's sizes, in a fixed order: every (prompt, generation)
    pair of ``prompt_frames`` x ``gen`` whose total frames stay within
    ``max_total_frames``, each given the next phone rate of
    ``phones_per_s`` and, every ``greedy_every``-th, the greedy flag."""
    pairs = [(p, g) for p, g in itertools.product(t["prompt_frames"], t["gen"])
             if p + g <= t.get("max_total_frames", 10 ** 9)]
    rates = t.get("phones_per_s", [None])
    every = t.get("greedy_every", 0)
    out = []
    for i, (p, g) in enumerate(pairs):
        out.append({"prompt_frames": p, "gen": g,
                    "phones_per_s": rates[i % len(rates)],
                    "greedy": bool(every) and i % every == every - 1})
    return out


def phones_of(t: dict, s: dict, frame_rate: int) -> int:
    """Text tokens of one request: ``phones_per_s`` per second of prompt and
    generated audio, or (``phones_from_cap``) just enough that the length
    cap (phones x ``cap_frames_per_phone`` frames in all) ends the
    generation after ``gen`` frames."""
    if t.get("phones_from_cap"):
        return (s["prompt_frames"] + s["gen"]) // t["cap_frames_per_phone"] + 1
    secs = (s["prompt_frames"] + s["gen"]) / frame_rate
    return max(1, int(round(s["phones_per_s"] * secs)))


def make_request(t: dict, cfg: dict, seed: int, index: int, s: dict,
                 due_s: float = 0.0) -> Request:
    rng = rng_for(seed, 1, index)
    n_ph = phones_of(t, s, cfg["encodec_sr"])
    x = rng.integers(0, cfg["text_vocab_size"], n_ph).astype(np.int64)
    prompt = rng.integers(0, cfg["audio_vocab_size"],
                          (cfg["n_codebooks"], s["prompt_frames"]))
    return Request(index, s["prompt_frames"], s["gen"], n_ph, s["greedy"],
                   x, prompt.astype(np.int64), due_s)


def closed_loop(t: dict, cfg: dict, seed: int):
    """Requests without end: the size set in a seed-drawn order, again and
    again, each pass in a new order."""
    sizes = size_set(t)
    rng = rng_for(seed, 0)
    index = itertools.count()
    greedy = [s for s in sizes if s["greedy"]]
    other = [s for s in sizes if not s["greedy"]]
    while True:
        # each pass in a new order, the greedy sizes spread evenly through
        # it (one in every ``greedy_every``, first), so that any window of
        # a few requests holds some to check
        g = [greedy[i] for i in rng.permutation(len(greedy))]
        o = [other[i] for i in rng.permutation(len(other))]
        every = t.get("greedy_every", 0)
        for k in range(len(sizes)):
            pick = g if (g and (not o or (every and k % every == 0))) else o
            yield make_request(t, cfg, seed, next(index), pick.pop(0))


def exp_gaps(rate: float, seconds: float) -> np.ndarray:
    """round(rate x seconds) gaps at the quantiles (i + 1/2) / n of an
    exponential law, scaled to sum to ``seconds`` (offered rate exact)."""
    n = max(1, int(round(rate * seconds)))
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    return gaps * (seconds / gaps.sum())


def open_loop(t: dict, cfg: dict, seed: int, seconds: float,
              rate: Optional[float] = None) -> List[Request]:
    """The requests due in a window of ``seconds`` at ``rate`` a second
    (the file's ``rate_per_s`` unless given): the size set repeated to
    their number, and the gaps, each in a seed-drawn order."""
    rate = t["rate_per_s"] if rate is None else rate
    gaps = exp_gaps(rate, seconds)
    n = len(gaps)
    sizes = size_set(t)
    sizes = [sizes[i % len(sizes)] for i in range(n)]
    rng = rng_for(seed, 0)
    order = rng.permutation(n)
    gaps = gaps[rng.permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [make_request(t, cfg, seed, i, sizes[order[i]], float(due[i]))
            for i in range(n)]


def ceil_to(v: int, m: int) -> int:
    return int(math.ceil(v / m) * m)
