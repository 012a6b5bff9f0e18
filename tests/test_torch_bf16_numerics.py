"""The port's bf16 rounding points against the JAX package's, on the CPU.

The JAX package takes attention logits, p@v and both products of the heads
in f32 (``preferred_element_type=f32``) and rounds to bf16 only where it
casts.  The other port tests run f32 (the loaders downgrade bf16 there), so
they cannot see where bf16 is rounded; these feed both packages the same
seeded bf16 inputs.  The two still sum in different orders in f32, which
flips a rounding now and then: hence one bf16 ulp of the output's magnitude,
on under 1% of the elements."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.ops import fused_decode as jfd
from voicecraft_tpu.ops.attention import decode_attention_self as jdecode_attn
from voicecraft_tpu.ops.attention import mha as jmha
from voicecraft_tpu.ops.attention import segment_padding_bias as jbias
from voicecraft_tpu.utils.quantize import _quantize_matrix
from voicecraft_tpu_torch.models.voicecraft import Heads, apply_heads
from voicecraft_tpu_torch.ops.attention import (decode_attention_self,
                                                matmul_f32, mha,
                                                segment_padding_bias)
from voicecraft_tpu_torch.ops.fused_decode import fused_ffn_plain
from voicecraft_tpu_torch.utils.convert import to_torch

BF16 = torch.bfloat16


def _bf16(rng, shape, std=2.0):
    """Seeded normal values rounded to bf16, as a torch tensor."""
    return torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).to(BF16)


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _assert_within_one_ulp(got, want):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    diff = np.abs(got - want)
    assert diff.max() <= ulp, (diff.max(), ulp)
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()


@pytest.mark.parametrize("x_lens,y_lens", [([20], [60]), ([20, 32], [64, 40])])
def test_mha_rounds_where_jax_does(x_lens, y_lens):
    S, D, H, x_pad = 96, 256, 4, 32
    rng = np.random.default_rng(len(x_lens))
    q, k, v = (_bf16(rng, (len(x_lens), S, D)) for _ in range(3))
    xl, yl = (torch.tensor(a, dtype=torch.int32) for a in (x_lens, y_lens))
    got = mha(q, k, v, segment_padding_bias(S, x_pad, xl, yl), H)
    want = jmha(_jax(q), _jax(k), _jax(v),
                jbias(S, x_pad, jnp.asarray(xl.numpy()), jnp.asarray(yl.numpy())),
                H)
    assert got.dtype == BF16
    _assert_within_one_ulp(got, want)


@pytest.mark.parametrize("x_pad", [None, 32])
def test_decode_attention_self_rounds_where_jax_does(x_pad):
    B, S_max, H, Dh, kv_len, x_len = 2, 160, 4, 64, 150, 20
    rng = np.random.default_rng(7)
    q = _bf16(rng, (B, 1, H * Dh))
    kc, vc = (_bf16(rng, (B, S_max, H, Dh)) for _ in range(2))
    kn, vn = (_bf16(rng, (B, 1, H, Dh)) for _ in range(2))
    xl = None if x_pad is None else x_len
    got = decode_attention_self(
        q, kc, vc, torch.tensor(kv_len), kn, vn, H,
        x_len=None if xl is None else torch.tensor(xl), x_pad=x_pad)
    want = jdecode_attn(_jax(q), _jax(kc), _jax(vc), jnp.asarray(kv_len),
                        _jax(kn), _jax(vn), H,
                        x_len=None if xl is None else jnp.asarray(xl),
                        x_pad=x_pad)
    assert got.dtype == BF16
    _assert_within_one_ulp(got, want)


def _heads_reference(heads, h):
    """The JAX package's apply_heads (voicecraft.py:191-194) in f64: both
    products and the GELU exact, the hidden layer rounded f32 -> bf16 after
    its bias and the GELU, the logits plus b2 unrounded."""
    d = lambda t: t.double()
    h1 = torch.einsum("nd,kdh->knh", d(h), d(heads.w1)) + d(heads.b1)[:, None]
    h1 = torch.nn.functional.gelu(h1, approximate="none")
    h1 = h1.float().to(BF16)
    logits = torch.einsum("knh,khc->knc", d(h1), d(heads.w2))
    return (logits + d(heads.b2)[:, None]).transpose(0, 1)


@pytest.mark.parametrize("n", [1, 4])
def test_apply_heads_rounds_where_jax_does(n):
    K, D, card = 4, 256, 130
    heads = Heads(K, D, 64, card, BF16, "cpu")
    heads.init_weights(torch.Generator().manual_seed(n))
    h = _bf16(np.random.default_rng(n), (n, D), std=1.0)
    got = apply_heads(heads, h)
    assert got.dtype == torch.float32 and got.shape == (n, K, card)
    want = _heads_reference(heads, h)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_matmul_f32_keeps_the_product_in_f32():
    rng = np.random.default_rng(3)
    a = _bf16(rng, (1, 5, 64))
    b = _bf16(rng, (3, 64, 7))
    got = matmul_f32(a, b)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 7)
    want = torch.matmul(a.double(), b.double())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-5)
    assert not torch.equal(got, torch.matmul(a, b).float())


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("fp8", [False, True])
def test_fused_ffn_plain_rounds_where_jax_does(B, fp8):
    """fused_ffn_plain in bf16 against the Pallas kernel in bf16 (interpret
    mode): f32 products, scale and bias in f32, the hidden vector rounded to
    bf16 before the second product, one output rounding.  The card's kernel
    is held against fused_ffn_plain, so this pins its rounding points too."""
    from jax.experimental.pallas import tpu as pltpu
    D, F = 256, 1024
    rng = np.random.default_rng(10 + B + 2 * fp8)
    x = _bf16(rng, (B, D), std=1.0)
    w1, w2 = _bf16(rng, (D, F), std=D ** -0.5), _bf16(rng, (F, D), std=F ** -0.5)
    b1, b2 = _bf16(rng, (F,), std=0.1), _bf16(rng, (D,), std=0.1)
    jw1, jw2 = _jax(w1), _jax(w2)
    if fp8:
        jw1, jw2 = _quantize_matrix(jw1), _quantize_matrix(jw2)
    with pltpu.force_tpu_interpret_mode():
        want = jfd.fused_ffn(_jax(x), jw1, _jax(b1), jw2, _jax(b2), tile_f=256)
    conv = lambda w: ({"q": to_torch(w["q"]), "scale": to_torch(w["scale"])}
                      if isinstance(w, dict) else to_torch(w))
    got = fused_ffn_plain(x, conv(jw1), b1, conv(jw2), b2)
    assert got.dtype == BF16 and got.shape == (B, D)
    _assert_within_one_ulp(got, want)


def test_fp8_proj_rounds_where_jax_does():
    """The fp8 form of _proj in bf16 (transformer.py:188-195): the product
    rounded to bf16, then times the scale cast to bf16, then the bias."""
    from voicecraft_tpu.models.transformer import _proj as jproj
    from voicecraft_tpu_torch.models.transformer import _proj
    from voicecraft_tpu_torch.utils.quantize import _quantize_matrix as quant
    rng = np.random.default_rng(21)
    x = _bf16(rng, (3, 256), std=1.0)
    w, b = _bf16(rng, (256, 192), std=0.06), _bf16(rng, (192,), std=0.1)
    got = _proj(x, quant(w), b)
    want = jproj(_jax(x), _quantize_matrix(_jax(w)), _jax(b))
    assert got.dtype == BF16
    _assert_within_one_ulp(got, want)


def test_fp8_apply_heads_rounds_where_jax_does():
    """apply_heads on fp8 heads in bf16 (voicecraft.py:183-194): the
    per-column scale applied in f32 after each product, the hidden layer
    rounded to bf16 once.  The JAX package's function in f64 (its bf16 x
    bf16 -> f32 batched product does not run on the CPU), on the JAX
    quantizer's bytes."""
    import types
    from voicecraft_tpu_torch.utils.quantize import _quantize_matrix as quant
    K, D, card = 4, 256, 130
    heads = Heads(K, D, 64, card, BF16, "cpu")
    heads.init_weights(torch.Generator().manual_seed(5))
    h = _bf16(np.random.default_rng(5), (4, D), std=1.0)
    fp8 = types.SimpleNamespace(w1=quant(heads.w1), b1=heads.b1,
                                w2=quant(heads.w2), b2=heads.b2)
    got = apply_heads(fp8, h)
    jw1, jw2 = (_quantize_matrix(_jax(w)) for w in (heads.w1, heads.w2))
    d = lambda a: torch.from_numpy(np.asarray(a.astype(jnp.float32))).double()
    h1 = (torch.einsum("nd,kdh->knh", h.double(), d(jw1["q"])) * d(jw1["scale"])
          + heads.b1.double()[:, None])
    h1 = torch.nn.functional.gelu(h1, approximate="none").float().to(BF16)
    want = (torch.einsum("knh,khc->knc", h1.double(), d(jw2["q"])) * d(jw2["scale"])
            + heads.b2.double()[:, None]).transpose(0, 1)
    assert got.dtype == torch.float32 and got.shape == (4, K, card)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
