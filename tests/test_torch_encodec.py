"""The port's EnCodec (models/encodec.py) against the JAX package's on the
same weights: codes exactly, wav to 1e-4, on a seeded 1 s wav.  Both run in
f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.models import encodec as jec
from voicecraft_tpu_torch.models import encodec as ec
from voicecraft_tpu_torch.utils.convert import codec_from_jax_params


@pytest.fixture(scope="module")
def codecs():
    jcfg = jec.EncodecConfig()
    params = jec.init_encodec(jcfg, jax.random.PRNGKey(0))
    codec = ec.Encodec(ec.EncodecConfig(), "cpu")
    codec.load_state_dict(codec_from_jax_params(
        jax.tree.map(np.asarray, params), codec.cfg))
    return jcfg, params, codec


def _wav(seconds=1.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
    return (wav + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)[None]


def test_encode_codes_match_jax_exactly(codecs):
    jcfg, params, codec = codecs
    wav = _wav()
    want = np.asarray(jec.encode(params, jnp.asarray(wav), jcfg))
    got = codec.encode(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (1, 4, 50)
    np.testing.assert_array_equal(got, want)


def test_decode_wav_matches_jax(codecs):
    jcfg, params, codec = codecs
    codes = np.random.default_rng(1).integers(0, 2048, (1, 4, 50)).astype(np.int32)
    want = np.asarray(jec.decode(params, jnp.asarray(codes), jcfg))
    got = codec.decode(torch.from_numpy(codes).long()).numpy()
    assert got.shape == want.shape == (1, 50 * 320)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bucketed_round_trip_matches_jax(codecs):
    jcfg, params, codec = codecs
    wav = _wav(seconds=0.7, seed=2)
    want_codes = jec.encode_bucketed(params, wav, jcfg)
    codes = ec.encode_bucketed(codec, wav)
    np.testing.assert_array_equal(codes, want_codes)
    want_wav = jec.decode_bucketed(params, want_codes, jcfg)
    np.testing.assert_allclose(ec.decode_bucketed(codec, codes), want_wav,
                               atol=1e-4)


def test_special_codes_decode_to_finite_audio(codecs):
    """Random LM weights can emit the special tokens (>= codebook size);
    they add nothing to the latent instead of poisoning the wav."""
    _, _, codec = codecs
    codes = torch.full((1, 4, 20), 7)
    codes[0, 0, 5] = 2048
    codes[0, 2, 9] = 2050
    wav = codec.decode(codes)
    assert torch.isfinite(wav).all()
