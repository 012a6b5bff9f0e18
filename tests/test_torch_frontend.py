"""The port's own config, tokenizer and WAV I/O (voicecraft_tpu_torch
config.py, data/phonemes.py, utils/audio.py) against the JAX package's:
the same presets field by field, the same phone symbols and ids, the same
samples and bytes."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from voicecraft_tpu import config as jcfg
from voicecraft_tpu.data import phonemes as jph
from voicecraft_tpu.utils import audio as jau
from voicecraft_tpu_torch import config as tcfg
from voicecraft_tpu_torch.data import phonemes as tph
from voicecraft_tpu_torch.utils import audio as tau

DEMO = str(Path(__file__).resolve().parents[1] / "demo" / "demo.wav")


# the port's presets of a block the JAX package lacks, and the fields that
# choose and size it (every other field is the JAX package's)
PORT_ONLY_PRESETS = {"deepseek_v2_lite", "tiny_test_dsv2",
                     "kimi_linear_48b_a3b", "tiny_test_kimi"}
JAX_FIELDS = {f.name for f in dataclasses.fields(jcfg.ModelConfig)}
PORT_DEFAULTS = {f.name: f.default for f in dataclasses.fields(tcfg.ModelConfig)
                 if f.name not in JAX_FIELDS}


def _shared(cfg) -> dict:
    """A config's fields that the JAX package has; the port's own fields
    must hold their defaults (VoiceCraft's block)."""
    d = dataclasses.asdict(cfg)
    return {k: v for k, v in d.items() if k in JAX_FIELDS}


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_matches(name):
    assert sorted(tcfg.PRESETS) == sorted(set(jcfg.PRESETS) | PORT_ONLY_PRESETS)
    got, want = tcfg.PRESETS[name](), jcfg.PRESETS[name]()
    assert _shared(got) == dataclasses.asdict(want)
    assert {k: getattr(got, k) for k in PORT_DEFAULTS} == PORT_DEFAULTS
    for prop in ("n_text_tokens", "card", "eog_inference", "head_dim",
                 "ffn_dim"):
        assert getattr(got, prop) == getattr(want, prop)


def test_config_json_crosses_packages():
    want = dataclasses.replace(jcfg.giga830M_tts_enhanced(),
                               codebook_weight=(5.0, 1.0, 0.5, 0.1))
    got = tcfg.ModelConfig.from_json(want.to_json())
    assert _shared(got) == dataclasses.asdict(want)
    assert {k: getattr(got, k) for k in PORT_DEFAULTS} == PORT_DEFAULTS
    assert jcfg.ModelConfig.from_json(got.to_json()) == want
    # a reference args namespace: stringly-typed fields and extra keys
    args = {"audio_vocab_size": "2048", "codebook_weight": "[5, 1, 0.5, 0.1]",
            "d_model": 1024, "audio_embedding_dim": 1024, "exp_dir": "/x"}
    assert (_shared(tcfg.ModelConfig.from_dict(args))
            == dataclasses.asdict(jcfg.ModelConfig.from_dict(args)))


@pytest.mark.parametrize("text", [
    "the sound of birds over the river at dawn",
    "  Hello, World! It's 3 o'clock -- really?  ",
    "ünïcödé wörds   and tabs\tbetween"])
def test_grapheme_tokens_match(text):
    got = tph.make_text_tokenizer("en-us", "grapheme").phonemize(text)
    want = jph.make_text_tokenizer("en-us", "grapheme").phonemize(text)
    assert got == want
    vocab = jph.build_vocab([want[::-1], list("xyz")])
    assert tph.build_vocab([got[::-1], list("xyz")]) == vocab
    assert (tph.phones_to_ids(got + ["<unk>"], vocab)
            == jph.phones_to_ids(want + ["<unk>"], vocab))


@pytest.mark.parametrize("phonemized", ["h|ə|l|oʊ_w|ɜː|l|d",
                                        "ðə_s|aʊ|n|d,_ʌv_b|ɜː|d|z!"])
def test_split_phones_matches(phonemized):
    assert tph.split_phones(phonemized) == jph.split_phones(phonemized)


@pytest.mark.parametrize("sr", [16000, 24000, 8000])
def test_load_audio_matches(sr):
    got, want = tau.load_audio(DEMO, sr), jau.load_audio(DEMO, sr)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tau.load_audio(DEMO, sr, 1000, 4000),
                                  jau.load_audio(DEMO, sr, 1000, 4000))


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_write_read_matches(tmp_path, channels):
    wav = np.random.default_rng(channels).uniform(
        -1.2, 1.2, (channels, 3001)).astype(np.float32)
    tau.write_wav(str(tmp_path / "t.wav"), wav, 22050)
    jau.write_wav(str(tmp_path / "j.wav"), wav, 22050)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, want = tau.read_wav(str(tmp_path / "t.wav")), jau.read_wav(
        str(tmp_path / "t.wav"))
    assert got[1] == want[1] == 22050
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(tau.convert_audio(got[0], 22050, 16000, 2),
                                  jau.convert_audio(want[0], 22050, 16000, 2))
