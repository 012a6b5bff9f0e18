"""Weight-only fp8 in the port (utils/quantize.py, the fp8 forms of _proj,
qkv_proj and apply_heads) against the JAX package's utils/quantize.py, on
the CPU: quantized bytes and scales bit for bit, the quantized trees
carried across by from_jax_params, and fp8 prefill / decode-step logits
(f32 compute) within 1e-4 of JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test, tiny_test_mtp
from voicecraft_tpu.inference import tts as jtts
from voicecraft_tpu.models import transformer as jtrm
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu.ops import fused_decode as jfd
from voicecraft_tpu.utils import quantize as jq
from voicecraft_tpu_torch.inference import tts
from voicecraft_tpu_torch.models import transformer as trm
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops.attention import segment_padding_bias, mha
from voicecraft_tpu_torch.ops.fused_decode import fused_ffn, fused_ffn_plain
from voicecraft_tpu_torch.utils import quantize as q
from voicecraft_tpu_torch.data import spans
from voicecraft_tpu_torch.utils.convert import from_jax_params, to_torch

from tests.test_torch_spec import (  # noqa: F401  (one_torch_thread: autouse)
    assert_rows_tie_aware, recording_sample, one_torch_thread)

# f32 logits of the port against JAX's on the same fp8 weights: both
# dequantize exactly (e4m3 and bf16 scales are exact in f32) and differ only
# in f32 summation order, ~1e-6 of logits of magnitude ~1
TOL_LOGITS = 1e-4


def _cfg(mtp=False):
    return dataclasses.replace(tiny_test_mtp() if mtp else tiny_test(),
                               compute_dtype="float32")


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of an fp8 or bf16 tensor."""
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16).numpy()


def _jbits(a) -> np.ndarray:
    return _bits(to_torch(a))


@pytest.fixture(scope="module")
def jax_params():
    cfg = _cfg(mtp=True)
    return jax.tree.map(np.asarray, jvc.init_params(cfg, jax.random.PRNGKey(0)))


def _port_model(cfg, tree):
    model = vc.VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(tree, cfg))
    return model.eval()


@pytest.mark.parametrize("case", ["2d", "stacked", "zero_column", "bf16",
                                  "tiny_values"])
def test_quantize_matrix_bit_equal_to_jax(case):
    rng = np.random.default_rng(hash(case) % 2 ** 32)
    shape = (3, 64, 130) if case == "stacked" else (64, 48)
    w = rng.standard_normal(shape).astype(np.float32)
    if case == "zero_column":
        w[:, 5] = 0.0                      # the scale floor, 1e-12
    if case == "tiny_values":
        w *= 1e-30                         # scales below bf16's normals
    jw = jnp.asarray(w)
    tw = torch.from_numpy(w)
    if case == "bf16":
        jw, tw = jw.astype(jnp.bfloat16), tw.to(torch.bfloat16)
    want = jq._quantize_matrix(jw)
    got = q._quantize_matrix(tw)
    assert got.q.dtype == torch.float8_e4m3fn and got.scale.dtype == torch.bfloat16
    assert got.q.shape == shape and got.scale.shape == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(_bits(got.q), _jbits(want["q"]))
    np.testing.assert_array_equal(_bits(got.scale), _jbits(want["scale"]))
    if case == "zero_column":
        assert (got.q[:, 5].float() == 0).all()


def test_dequant_dot_matches_jax():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    want = jq.dequant_dot(jnp.asarray(x), jq._quantize_matrix(jnp.asarray(w)))
    got = q.dequant_dot(torch.from_numpy(x), q._quantize_matrix(torch.from_numpy(w)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert q.is_quantized(q._quantize_matrix(torch.from_numpy(w)))
    assert not q.is_quantized(torch.from_numpy(w))


@pytest.mark.parametrize("pack_qkv", [False, True], ids=["unpacked", "packed"])
def test_quantize_decoder_fp8_carried_by_from_jax_params(jax_params, pack_qkv):
    """The port's quantizer on the port's model and the JAX quantizer on the
    same tree give the same state, bit for bit (MTP heads included), and the
    quantized JAX tree loads into the quantized model's layout."""
    cfg = _cfg(mtp=True)
    model = q.quantize_decoder_fp8(_port_model(cfg, jax_params),
                                   pack_qkv=pack_qkv)
    qtree = jax.tree.map(np.asarray,
                         jq.quantize_decoder_fp8(jax_params, pack_qkv=pack_qkv))
    want = from_jax_params(qtree, cfg)
    got = model.state_dict()
    assert set(got) - {"pe"} == set(want)
    names = [k for k in want if k.endswith(".q")]
    assert len(names) == cfg.num_decoder_layers * (4 if pack_qkv else 6) + 2 * (
        1 + cfg.n_mtp)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        if v.dtype in (torch.float8_e4m3fn, torch.bfloat16):
            np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    layer = model.decoder.layers[0]
    assert hasattr(layer, "wqkv") == pack_qkv and hasattr(layer, "wq") != pack_qkv
    assert not any(p.dtype == torch.float8_e4m3fn for p in model.parameters())
    fresh = q.quantize_decoder_fp8(vc.VoiceCraft(cfg, "cpu").init_weights(
        torch.Generator().manual_seed(1)), pack_qkv=pack_qkv)
    fresh.load_state_dict(want)                       # strict


def _jax_prefill_logits(tree, cfg, x, y_emb_in, steps):
    """JAX: prefill over dense mha, then teacher-forced decode_step_fast
    steps; the logits after each."""
    x_pad, S = 16, y_emb_in.shape[1]
    Sp = x_pad + S
    bias = jnp.asarray(segment_padding_bias(
        Sp, x_pad, torch.tensor([x]), torch.tensor([S])).numpy())
    cache = jtrm.init_kv_cache(cfg.num_decoder_layers, 1, Sp + len(steps),
                               cfg.nhead, cfg.head_dim, jnp.float32)
    xy = jnp.asarray(_prefix(cfg, x_pad, y_emb_in))
    h, cache = jtrm.prefill(tree["decoder"], xy, bias, cache, cfg.nhead)
    out = [jvc.apply_heads(tree["heads"], h[:, Sp - 1])]
    for i, e in enumerate(steps):
        h, cache = jtrm.decode_step_fast(
            tree["decoder"], jnp.asarray(e)[None, None], cache,
            jnp.asarray(Sp + i), cfg.nhead, x_len=jnp.asarray(x), x_pad=x_pad)
        out.append(jvc.apply_heads(tree["heads"], h[:, 0]))
    return [np.asarray(o) for o in out]


def _prefix(cfg, x_pad, y_emb_in):
    return np.concatenate([np.random.default_rng(9).standard_normal(
        (1, x_pad, cfg.d_model)).astype(np.float32), y_emb_in], axis=1)


def _port_prefill_logits(model, cfg, x, y_emb_in, steps):
    x_pad, S = 16, y_emb_in.shape[1]
    Sp = x_pad + S
    bias = segment_padding_bias(Sp, x_pad, torch.tensor([x]), torch.tensor([S]))
    cache = trm.init_kv_cache(cfg.num_decoder_layers, 1, Sp + len(steps),
                              cfg.nhead, cfg.head_dim, torch.float32, "cpu")
    xy = torch.from_numpy(_prefix(cfg, x_pad, y_emb_in))
    with torch.inference_mode():
        h, cache = trm.prefill(model.decoder, xy,
                               lambda q_, k, v: mha(q_, k, v, bias, cfg.nhead),
                               cache)
        out = [vc.apply_heads(model.heads, h[:, Sp - 1])]
        for i, e in enumerate(steps):
            h, cache = trm.decode_step_fast(
                model.decoder, torch.from_numpy(e)[None, None], cache,
                torch.tensor(Sp + i), x_len=torch.tensor(x), x_pad=x_pad)
            out.append(vc.apply_heads(model.heads, h[:, 0]))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("pack_qkv", [False, True], ids=["unpacked", "packed"])
def test_fp8_prefill_and_decode_logits_match_jax(jax_params, pack_qkv):
    cfg = _cfg(mtp=True)
    qtree = jq.quantize_decoder_fp8(jax_params, pack_qkv=pack_qkv)
    model = q.quantize_decoder_fp8(_port_model(cfg, jax_params),
                                   pack_qkv=pack_qkv)
    rng = np.random.default_rng(5)
    y_emb = rng.standard_normal((1, 40, cfg.d_model)).astype(np.float32)
    steps = [rng.standard_normal(cfg.d_model).astype(np.float32)
             for _ in range(4)]
    want = _jax_prefill_logits(qtree, cfg, 11, y_emb, steps)
    got = _port_prefill_logits(model, cfg, 11, y_emb, steps)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_LOGITS,
                                   err_msg=f"logits {i}")
    # and fp8 is not bf16's twin: the quantized logits moved
    plain = _port_prefill_logits(_port_model(cfg, jax_params), cfg, 11, y_emb,
                                 steps)
    assert np.abs(plain[0] - got[0]).max() > 10 * TOL_LOGITS


@pytest.mark.parametrize("B", [1, 8])
def test_fused_ffn_plain_on_quantizer_output_matches_jax_kernel(jax_params, B):
    """fused_ffn on one layer of quantize_decoder_fp8's output (a CPU
    tensor: the plain version) against the Pallas kernel in interpret mode
    on the JAX quantizer's output, f32 x."""
    from jax.experimental.pallas import tpu as pltpu
    cfg = _cfg(mtp=True)
    layer = q.quantize_decoder_fp8(_port_model(cfg, jax_params)).decoder.layers[1]
    qtree = jq.quantize_decoder_fp8(jax_params)
    ffn = jax.tree.map(lambda a: a[1], qtree["decoder"]["layers"]["ffn"])
    x = np.random.default_rng(B).standard_normal((B, cfg.d_model)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jfd.fused_ffn(jnp.asarray(x), ffn["lin1"]["w"], ffn["lin1"]["b"],
                             ffn["lin2"]["w"], ffn["lin2"]["b"], tile_f=128)
    got = fused_ffn(torch.from_numpy(x), layer.w1, layer.b1, layer.w2, layer.b2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), fused_ffn_plain(torch.from_numpy(x), layer.w1, layer.b1,
                                     layer.w2, layer.b2).numpy())


def test_fp8_greedy_tts_matches_jax_and_packing(monkeypatch):
    """Greedy tiny_test TTS on fp8 weights: packed and unpacked qkv give the
    same tokens in the port (as in the JAX package's test), and the port's
    rows equal the JAX package's until the first near-tie."""
    cfg = _cfg()
    params = jvc.init_params(cfg, jax.random.PRNGKey(11))
    model = _port_model(cfg, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(2)
    x = rng.integers(0, cfg.text_vocab_size, 9).astype(np.int32)
    y = rng.integers(0, cfg.audio_vocab_size, (4, 16)).astype(np.int32)
    scfg = vc.SamplingConfig(top_k=1, silence_tokens=(5, 7))
    prefix = spans.compose_tts_prefix(y, cfg)
    logits = recording_sample(monkeypatch)
    rows = [tts.run_decode(q.quantize_decoder_fp8(model, pack_qkv=p),
                           is_tts=True, x_tokens=x, prefix=prefix, n_spans=1,
                           scfg=scfg, seed=0, return_raw=True)[0]
            for p in (True, False)]
    monkeypatch.undo()
    np.testing.assert_array_equal(rows[0], rows[1])
    want, _ = jtts.run_decode(jq.quantize_decoder_fp8(params, pack_qkv=True), cfg,
                              is_tts=True, x_tokens=x, prefix=prefix,
                              queue_mask_ids=[], n_spans=1,
                              scfg=jvc.SamplingConfig(top_k=1, silence_tokens=(5, 7)),
                              seed=0, return_raw=True)
    assert_rows_tie_aware(rows[0], want, logits[:len(rows[0])])
