"""The port's decoder (models/transformer.py, ops/attention.py, the heads)
against the JAX package on the same weights and inputs, in f32 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.models import transformer as jtrm
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu.models.embedding import sine_table as jsine
from voicecraft_tpu.ops.attention import NEG_INF as J_NEG_INF
from voicecraft_tpu.ops.attention import decode_attention_self as jdecode_attn
from voicecraft_tpu_torch.models import transformer as trm
from voicecraft_tpu_torch.models.embedding import sine_table
from voicecraft_tpu_torch.models.voicecraft import VoiceCraft, apply_heads
from voicecraft_tpu_torch.ops.attention import NEG_INF, decode_attention_self
from voicecraft_tpu_torch.ops.flash_attention import (flash_prefix_attention,
                                                      prefill_attention)
from voicecraft_tpu_torch.utils.convert import from_jax_params

TOL = dict(rtol=2e-4, atol=2e-4)


def _model(cfg, seed=0):
    params = jvc.init_params(cfg, jax.random.PRNGKey(seed))
    model = VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return params, model


@pytest.fixture(scope="module")
def tiny():
    return _model(dataclasses.replace(tiny_test(), compute_dtype="float32"))


@pytest.fixture(scope="module")
def ffn1024():
    """d_model 256, so F = 1024 is a multiple of the JAX kernel's tile_f."""
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32",
                              d_model=256, audio_embedding_dim=256)
    return cfg, *_model(cfg, seed=1)


def test_constants_and_sine_table():
    assert NEG_INF == J_NEG_INF
    np.testing.assert_array_equal(sine_table(4096, 64), jsine(4096, 64))


PREFILL = dict(B=2, S=128, x_pad=48, x_lens=[30, 41], y_lens=[60, 70])


def _jax_prefill(params, x, nhead):
    S, x_pad = PREFILL["S"], PREFILL["x_pad"]
    jj = jnp.arange(S)
    xl = jnp.asarray(PREFILL["x_lens"])[:, None]
    yl = jnp.asarray(PREFILL["y_lens"])[:, None]
    key_valid = (jj[None] < xl) | ((jj[None] >= x_pad) & (jj[None] < x_pad + yl))
    allowed = (jj[None, :] <= jj[:, None])[None] & key_valid[:, None, :]
    bias = jnp.where(allowed, 0.0, J_NEG_INF).astype(jnp.float32)[:, None]
    D = x.shape[-1]
    cache = jtrm.init_kv_cache(len(params["layers"]["ln1"]["g"]), PREFILL["B"],
                               S, nhead, D // nhead, jnp.float32)
    h, cache = jtrm.prefill(params, jnp.asarray(x), bias, cache, nhead)
    return np.asarray(h), np.asarray(cache)


@pytest.mark.parametrize("path", ["dense", "flash_plain"])
def test_prefill_matches_jax(tiny, path):
    params, model = tiny
    cfg = model.cfg
    B, S, x_pad = PREFILL["B"], PREFILL["S"], PREFILL["x_pad"]
    x = np.random.default_rng(0).standard_normal((B, S, cfg.d_model)).astype(
        np.float32)
    want_h, want_c = _jax_prefill(params["decoder"], x, cfg.nhead)
    xl = torch.tensor(PREFILL["x_lens"], dtype=torch.int32)
    yl = torch.tensor(PREFILL["y_lens"], dtype=torch.int32)
    if path == "dense":      # what the dispatcher picks for CPU tensors
        attn = prefill_attention(xl, yl, x_pad, cfg.nhead, S)
    else:
        attn = lambda q, k, v: flash_prefix_attention(q, k, v, xl, yl, x_pad,
                                                      cfg.nhead)
    cache = trm.init_kv_cache(cfg.num_decoder_layers, B, S, cfg.nhead,
                              cfg.head_dim, torch.float32, "cpu")
    with torch.inference_mode():
        h, cache = trm.prefill(model.decoder, torch.from_numpy(x), attn, cache)
    np.testing.assert_allclose(h.numpy(), want_h, **TOL)
    np.testing.assert_allclose(cache.numpy(), want_c, **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_decode_step_fast_matches_jax(ffn1024, fused):
    cfg, params, model = ffn1024
    L, H, Dh, D = cfg.num_decoder_layers, cfg.nhead, cfg.head_dim, cfg.d_model
    s_max, pos, x_len, x_pad = 48, 37, 9, 16
    rng = np.random.default_rng(3)
    cache = (rng.standard_normal((L, 2, 1, s_max, H, Dh)) * 0.5).astype(np.float32)
    x_t = rng.standard_normal((1, 1, D)).astype(np.float32)

    def jax_step():
        return jtrm.decode_step_fast(
            params["decoder"], jnp.asarray(x_t), jnp.asarray(cache),
            jnp.asarray(pos), H, x_len=jnp.asarray(x_len), x_pad=x_pad,
            fused_ffn=fused)
    if fused:
        from jax.experimental.pallas import tpu as pltpu
        with pltpu.force_tpu_interpret_mode():
            want_h, want_c = jax_step()
    else:
        want_h, want_c = jax_step()
    c = torch.from_numpy(cache.copy())
    with torch.inference_mode():
        h, c = trm.decode_step_fast(model.decoder, torch.from_numpy(x_t), c,
                                    torch.tensor(pos), x_len=torch.tensor(x_len),
                                    x_pad=x_pad, fused_ffn=fused)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), **TOL)


def test_decode_attention_self_matches_jax():
    B, S_max, H, Dh = 2, 40, 4, 16
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, 1, H * Dh)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S_max, H, Dh)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
              for _ in range(2))
    for x_len, x_pad in ((None, None), (5, 12)):
        want = jdecode_attn(*map(jnp.asarray, (q, kc, vc)), jnp.asarray(29),
                            jnp.asarray(kn), jnp.asarray(vn), H,
                            x_len=None if x_len is None else jnp.asarray(x_len),
                            x_pad=x_pad)
        got = decode_attention_self(
            *map(torch.from_numpy, (q, kc, vc)), torch.tensor(29),
            torch.from_numpy(kn), torch.from_numpy(vn), H,
            x_len=None if x_len is None else torch.tensor(x_len), x_pad=x_pad)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_heads_matches_jax(tiny):
    params, model = tiny
    h = np.random.default_rng(5).standard_normal((3, model.cfg.d_model)).astype(
        np.float32)
    want = np.asarray(jvc.apply_heads(params["heads"], jnp.asarray(h)))
    got = apply_heads(model.heads, torch.from_numpy(h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
