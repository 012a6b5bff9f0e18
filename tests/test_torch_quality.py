"""The port's copy of the quality metrics (voicecraft_tpu_torch/utils/
quality.py) against the JAX package's (voicecraft_tpu/utils/quality.py) on
the same audio, exactly; and tests/test_quality.py's properties, held by
the copy: the DTW against a brute-force DP, zero for identical audio,
monotone under noise, robust to a small time shift."""

import numpy as np
import pytest

from voicecraft_tpu.utils import quality as jq
from voicecraft_tpu_torch.utils import quality as q
from tests.test_quality import _dtw_bruteforce

SR = 16000


def _audio(seed, seconds=1.3):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR), dtype=np.float32) / SR
    f0 = 120 + 200 * rng.random()
    return (np.sin(2 * np.pi * f0 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * t))
            + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def test_same_functions_as_the_jax_package():
    public = lambda m: {n for n in dir(m) if not n.startswith("__")
                        and callable(getattr(m, n))}
    assert public(q) == public(jq)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_jax_package(seed):
    ref, hyp = _audio(seed), _audio(seed + 10, seconds=1.1)
    np.testing.assert_array_equal(q.stft_power(ref), jq.stft_power(ref))
    np.testing.assert_array_equal(q.mel_filterbank(SR, 1024),
                                  jq.mel_filterbank(SR, 1024))
    np.testing.assert_array_equal(q.log_mel(ref, SR), jq.log_mel(ref, SR))
    assert q.log_mel_distance(ref, hyp, SR) == jq.log_mel_distance(ref, hyp,
                                                                   SR)
    assert q.mcd(ref, hyp, SR) == jq.mcd(ref, hyp, SR)
    assert q.duration_ratio(ref, hyp) == jq.duration_ratio(ref, hyp)
    dist = np.random.default_rng(seed).random((11, 17))
    assert q.dtw_path_cost(dist) == jq.dtw_path_cost(dist)


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (6, 1), (5, 5), (9, 4),
                                   (13, 17)])
def test_dtw_matches_bruteforce(shape):
    dist = np.random.default_rng(sum(shape)).random(shape)
    got_c, got_n = q.dtw_path_cost(dist)
    exp_c, exp_n = _dtw_bruteforce(dist)
    np.testing.assert_allclose(got_c * got_n, exp_c * exp_n, rtol=1e-12)


def test_metric_properties():
    rng = np.random.default_rng(1)
    wav = _audio(3, seconds=1.0)
    assert q.log_mel_distance(wav, wav, SR) < 0.01
    assert q.mcd(wav, wav, SR) < 0.05
    assert q.duration_ratio(wav, wav) == 1.0
    small = wav + 0.01 * rng.standard_normal(wav.shape).astype(np.float32)
    big = wav + 0.3 * rng.standard_normal(wav.shape).astype(np.float32)
    assert q.log_mel_distance(wav, small, SR) < q.log_mel_distance(wav, big,
                                                                   SR)
    assert q.mcd(wav, small, SR) < q.mcd(wav, big, SR)
    t = np.arange(2 * SR, dtype=np.float32) / SR
    tone = (np.sin(2 * np.pi * 330 * t)
            * (0.5 + 0.5 * np.sin(2 * np.pi * 1.5 * t))).astype(np.float32)
    other = np.sin(2 * np.pi * 97 * t).astype(np.float32)
    assert q.mcd(tone, np.roll(tone, int(0.05 * SR)), SR) < 0.3 * q.mcd(
        tone, other, SR)
    fb = q.mel_filterbank(SR, 1024, n_mels=80)
    assert fb.shape == (80, 513) and (fb.sum(axis=1) > 0).all()
    assert q.log_mel(np.zeros(SR, np.float32), SR).shape[1] == 80
