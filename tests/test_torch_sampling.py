"""The port's sampling (ops/sampling.py and the sample_helper machinery of
models/voicecraft.py) against the JAX package, exactly, on the same logits
and on forged decode states."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu.ops import sampling as jsampling
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops import sampling


def _logits(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 3


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.8),
                                         (40, 0.9), (1, 0.5)])
def test_top_k_top_p_filter_matches_jax(top_k, top_p):
    x = _logits((4, 131))
    want = np.asarray(jsampling.top_k_top_p_filter(jnp.asarray(x), top_k, top_p))
    got = sampling.top_k_top_p_filter(torch.from_numpy(x), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_sample_matches_jax():
    x = _logits((4, 2051), seed=1)
    want = np.asarray(jsampling.sample(None, jnp.asarray(x), 40, 0.9, 0.0))
    got = sampling.sample(None, torch.from_numpy(x), 40, 0.9, 0.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_draws_stay_in_the_filtered_set():
    x = torch.from_numpy(_logits((4, 131), seed=2))
    gen = torch.Generator().manual_seed(0)
    allowed = sampling.top_k_top_p_filter(x, 5, 1.0) > sampling.FILTER_VALUE
    for _ in range(50):
        s = sampling.sample(gen, x, top_k=5, temperature=0.7)
        assert allowed.gather(-1, s[:, None]).all()


def _cfg(eos: bool):
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32")
    if eos:   # the TTS-enhanced token layout (eos = card - 1)
        cfg = dataclasses.replace(cfg, eos=131, n_special=4, reduced_eog=1)
    return cfg


SCFG = vc.SamplingConfig(top_k=0, temperature=0.0, stop_repetition=3,
                         silence_tokens=(5, 7))
JSCFG = jvc.SamplingConfig(top_k=0, temperature=0.0, stop_repetition=3,
                           silence_tokens=(5, 7))

# forged states: (codebook_eog, cur_num_gen, consec_silence, prev_token,
# y_pos, x_len) — first step, min-length guard, silence penalty, the
# eog cascade in flight, and the y_pos > x_len * cap length cap
STATES = [
    ((0, 0, 0, 0), 0, 0, -1, 10, 8),
    ((0, 0, 0, 0), 2, 0, 5, 20, 8),
    ((0, 0, 0, 0), 11, 5, 5, 40, 8),
    ((0, 0, 0, 0), 30, 4, 7, 90, 8),
    ((1, 0, 0, 0), 31, 0, 12, 91, 8),
    ((1, 1, 1, 0), 33, 0, 12, 93, 8),
    ((0, 0, 0, 0), 40, 0, 3, 81, 8),
]


def _logits_for(cfg, seed, silence_peak):
    x = _logits((cfg.n_codebooks, cfg.card), seed)
    if silence_peak:
        x[0, 5] = 9.0       # row 0 prefers the silence token
    return x


@pytest.mark.parametrize("eos,is_tts,state", [
    (eos, tts, st) for eos, tts, st in itertools.product(
        [False, True], [True, False], STATES)])
def test_adjust_and_finalize_match_jax(eos, is_tts, state):
    cfg = _cfg(eos)
    eog, cur, consec, prev, y_pos, x_len = state
    cap_mult = (cfg.encodec_sr // 5) if is_tts else 10
    x = _logits_for(cfg, seed=sum(state[1:]), silence_peak=prev == 5)
    jstate = (jnp.asarray(eog, bool), jnp.asarray(cur), jnp.asarray(consec),
              jnp.asarray(prev))
    tstate = (torch.tensor(eog, dtype=torch.bool), torch.tensor(cur),
              torch.tensor(consec), torch.tensor(prev))

    want_la = jvc._adjust_logits(cfg, JSCFG, is_tts, jnp.asarray(x), *jstate)
    got_la = vc._adjust_logits(cfg, SCFG, is_tts, torch.from_numpy(x), *tstate)
    np.testing.assert_array_equal(got_la.numpy(), np.asarray(want_la))

    samples = np.asarray(jnp.argmax(want_la, axis=-1))
    want = jvc._finalize_sample(cfg, JSCFG, is_tts, cap_mult, want_la,
                                jnp.asarray(samples), *jstate,
                                jnp.asarray(y_pos), jnp.asarray(x_len))
    got = vc._finalize_sample(cfg, SCFG, is_tts, cap_mult, got_la,
                              torch.tensor(samples).long(), *tstate,
                              torch.tensor(y_pos), torch.tensor(x_len))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    got_all = vc._adjust_and_sample(cfg, SCFG, is_tts, cap_mult, None,
                                    torch.from_numpy(x), *tstate,
                                    torch.tensor(y_pos), torch.tensor(x_len))
    for g, w in zip(got_all, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
