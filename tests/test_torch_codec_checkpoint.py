"""Audiocraft EnCodec checkpoints into the port (utils/convert_encodec.py and
``load_codec(path)``), against the JAX package's converter on the same
file: a seeded state dict in audiocraft's layout (SEANet sequential
indices, weight-norm pairs, LSTM and codebook names), saved as a ``.th``
with its ``xp.cfg``.  Codes must be exactly equal and the wav within 1e-4,
as in tests/test_torch_encodec.py; both run in f32 on the CPU."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.models import encodec as jec
from voicecraft_tpu.utils import convert_encodec as jconv
from voicecraft_tpu_torch.inference.loader import load_codec
from voicecraft_tpu_torch.models import encodec as ec
from voicecraft_tpu_torch.utils import convert_encodec as conv

# a narrow codec (hop 320 as the giga codec's), so the LSTMs stay small
XP_CFG = {"channels": 1, "sample_rate": 16000,
          "seanet": {"dimension": 32, "n_filters": 4, "ratios": [8, 5, 4, 2],
                     "n_residual_layers": 1, "lstm": 2, "kernel_size": 7,
                     "last_kernel_size": 7, "residual_kernel_size": 3,
                     "dilation_base": 2, "compress": 2, "causal": True,
                     "pad_mode": "reflect", "true_skip": False},
          "rvq": {"n_q": 4, "bins": 64}}


def _audiocraft_state(xp, style: str, seed: int = 0) -> dict:
    """A seeded state dict with audiocraft's EncodecModel names: SEANet
    convs as ``<seq>.conv.conv`` (transposed: ``.convtr.convtr``) with
    weight norm split into g and v (``style``: 'old' weight_g/weight_v, or
    'parametrize'), resnet blocks' convs at block.1/block.3 with a 1x1
    shortcut, LSTMs, and one codebook per quantizer layer."""
    rng = np.random.default_rng(seed)
    s = xp["seanet"]
    nf, ratios, dim_lat = s["n_filters"], s["ratios"], s["dimension"]
    sd = {}

    def t(*shape, scale=0.3):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    def wn_conv(name, cout, cin, k, transposed=False):
        # weight norm over dim 0: g [dim0, 1, 1]
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        g, v = t(shape[0], 1, 1).abs() + 0.5, t(*shape)
        if style == "old":
            sd[name + ".weight_g"], sd[name + ".weight_v"] = g, v
        else:
            sd[name + ".parametrizations.weight.original0"] = g
            sd[name + ".parametrizations.weight.original1"] = v
        sd[name + ".bias"] = t(cout, scale=0.1)

    def resnet(name, dim):
        wn_conv(f"{name}.block.1.conv.conv", dim // 2, dim, 3)
        wn_conv(f"{name}.block.3.conv.conv", dim, dim // 2, 1)
        wn_conv(f"{name}.shortcut.conv.conv", dim, dim, 1)

    def lstm(name, dim):
        for i in range(s["lstm"]):
            for w in ("weight_ih", "weight_hh"):
                sd[f"{name}.{w}_l{i}"] = t(4 * dim, dim, scale=dim ** -0.5)
            for b in ("bias_ih", "bias_hh"):
                sd[f"{name}.{b}_l{i}"] = t(4 * dim, scale=dim ** -0.5)

    top = nf * 2 ** len(ratios)
    # encoder: conv, [resnet, ELU, down conv] per stage, LSTM, ELU, conv
    wn_conv("encoder.model.0.conv.conv", nf, 1, 7)
    for st, r in enumerate(reversed(ratios)):
        dim, base = nf * 2 ** st, 1 + 3 * st
        resnet(f"encoder.model.{base}", dim)
        wn_conv(f"encoder.model.{base + 2}.conv.conv", 2 * dim, dim, 2 * r)
    lstm("encoder.model.13.lstm", top)
    wn_conv("encoder.model.15.conv.conv", dim_lat, top, 7)
    # decoder: conv, LSTM, [ELU, up convtr, resnet] per stage, ELU, conv
    wn_conv("decoder.model.0.conv.conv", top, dim_lat, 7)
    lstm("decoder.model.1.lstm", top)
    for st, r in enumerate(ratios):
        dim, base = top // 2 ** st, 2 + 3 * st
        wn_conv(f"decoder.model.{base + 1}.convtr.convtr", dim // 2, dim, 2 * r,
                transposed=True)
        resnet(f"decoder.model.{base + 2}", dim // 2)
    wn_conv("decoder.model.15.conv.conv", 1, nf, 7)
    for q in range(xp["rvq"]["n_q"]):
        sd[f"quantizer.vq.layers.{q}._codebook.embed"] = t(
            xp["rvq"]["bins"], dim_lat, scale=1.0)
    return sd


def _wav(seconds=1.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
    return (wav + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)[None]


@pytest.mark.parametrize("style,nesting", [("old", "best_state"),
                                           ("parametrize", "flat")])
def test_load_codec_checkpoint_matches_jax(tmp_path, style, nesting):
    sd = _audiocraft_state(XP_CFG, style)
    ckpt = ({"xp.cfg": XP_CFG, "best_state": {"model": sd}}
            if nesting == "best_state" else {"xp.cfg": XP_CFG, **sd})
    path = tmp_path / "codec.th"
    torch.save(ckpt, path)

    jcfg, params = jconv.load_audiocraft_checkpoint(str(path))
    cfg, codec = load_codec(str(path), device="cpu")
    assert codec.cfg == cfg and cfg.true_skip is False and cfg.n_filters == 4
    wav = _wav()
    want = np.asarray(jec.encode(params, jnp.asarray(wav), jcfg))
    got = codec.encode(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (1, 4, 50)
    assert len(np.unique(want)) > 4            # not one code everywhere
    np.testing.assert_array_equal(got, want)

    codes = np.random.default_rng(1).integers(0, 64, (1, 4, 50)).astype(np.int32)
    want_wav = np.asarray(jec.decode(params, jnp.asarray(codes), jcfg))
    got_wav = codec.decode(torch.from_numpy(codes).long()).numpy()
    assert got_wav.shape == want_wav.shape == (1, 50 * 320)
    assert np.abs(want_wav).max() > 1e-3
    np.testing.assert_allclose(got_wav, want_wav, atol=1e-4)


def _namespace(d):
    return types.SimpleNamespace(**{k: _namespace(v) if isinstance(v, dict) else v
                                    for k, v in d.items()})


@pytest.mark.parametrize("form", ["dict", "attributes", "partial"])
def test_config_from_xp_cfg_matches_jax(form):
    xp = {"dict": XP_CFG, "attributes": _namespace(XP_CFG),
          "partial": {"seanet": {"n_filters": 32, "lstm": 1},
                      "rvq": {"bins": 1024}}}[form]
    got, want = conv.config_from_xp_cfg(xp), jconv.config_from_xp_cfg(xp)
    for field in ec.EncodecConfig.__dataclass_fields__:
        assert getattr(got, field) == getattr(want, field), field


def test_weight_norm_fold_matches_jax():
    sd = _audiocraft_state(XP_CFG, "old")
    for name in ("encoder.model.0.conv.conv", "decoder.model.3.convtr.convtr"):
        np.testing.assert_array_equal(conv._fold_weight_norm(sd, name),
                                      jconv._fold_weight_norm(sd, name))
    with pytest.raises(KeyError):
        conv._fold_weight_norm(sd, "encoder.model.99.conv.conv")
