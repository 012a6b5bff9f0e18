"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels, run as the JAX tests run them on the CPU
(interpret mode), and against the dense attention they replace.  The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.ops import fused_decode as jfd
from voicecraft_tpu.ops.attention import mha as jmha
from voicecraft_tpu.ops.attention import segment_padding_bias as jbias
from voicecraft_tpu.ops.flash_attention import flash_prefix_attention as jflash
from voicecraft_tpu.utils.quantize import _quantize_matrix
from voicecraft_tpu_torch.ops.flash_attention import (
    flash_prefix_attention, flash_prefix_attention_plain)
from voicecraft_tpu_torch.config import PRESETS
from voicecraft_tpu_torch.ops.fused_decode import (FFN_MAX_BLOCKS, FFN_TILE_F,
                                                   ffn_route, ffn_sm90_tiles,
                                                   fused_ffn, fused_ffn_plain)
from voicecraft_tpu_torch.utils.convert import to_torch

FLASH_CASES = [
    # S, D, nhead, x_pad, x_lens, y_lens
    (256, 64, 4, 64, [40, 64], [150, 190]),
    (200, 64, 2, 48, [30, 48], [100, 152]),     # S not a multiple of 64
    (130, 128, 8, 32, [7, 32], [98, 50]),       # Dh 16, ragged
]


def _flash_inputs(S, D, x_lens, y_lens, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(len(x_lens), S, D)).astype(np.float32)
               for _ in range(3))
    return q, k, v, np.asarray(x_lens, np.int32), np.asarray(y_lens, np.int32)


def _valid_rows(S, x_pad, x_lens, y_lens):
    rows = np.zeros((len(x_lens), S), bool)
    for b, (xl, yl) in enumerate(zip(x_lens, y_lens)):
        rows[b, :xl] = True
        rows[b, x_pad:x_pad + yl] = True
    return rows


def _port_flash(q, k, v, xl, yl, x_pad, nhead):
    t = torch.from_numpy
    return flash_prefix_attention(t(q), t(k), t(v), t(xl), t(yl), x_pad,
                                  nhead).numpy()


@pytest.mark.parametrize("S,D,nhead,x_pad,x_lens,y_lens", FLASH_CASES)
def test_flash_plain_matches_jax_dense(S, D, nhead, x_pad, x_lens, y_lens):
    q, k, v, xl, yl = _flash_inputs(S, D, x_lens, y_lens)
    bias = jbias(S, x_pad, jnp.asarray(xl), jnp.asarray(yl))
    want = np.asarray(jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           bias, nhead))
    got = _port_flash(q, k, v, xl, yl, x_pad, nhead)
    rows = _valid_rows(S, x_pad, x_lens, y_lens)
    np.testing.assert_allclose(got[rows], want[rows], atol=2e-5)


@pytest.mark.parametrize("S,D,nhead,x_pad,x_lens,y_lens", FLASH_CASES[:2])
def test_flash_plain_matches_jax_pallas_interpret(S, D, nhead, x_pad, x_lens,
                                                  y_lens):
    q, k, v, xl, yl = _flash_inputs(S, D, x_lens, y_lens, seed=1)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(xl), jnp.asarray(yl), x_pad, nhead,
                             block_q=64, block_k=64, interpret=True))
    got = _port_flash(q, k, v, xl, yl, x_pad, nhead)
    rows = _valid_rows(S, x_pad, x_lens, y_lens)
    np.testing.assert_allclose(got[rows], want[rows], atol=2e-5)


def test_flash_wrapper_takes_plain_version_only_on_cpu():
    q, k, v, xl, yl = _flash_inputs(64, 32, [5, 9], [20, 30], seed=2)
    t = torch.from_numpy
    args = (t(q), t(k), t(v), t(xl), t(yl), 16, 2)
    assert torch.equal(flash_prefix_attention(*args),
                       flash_prefix_attention_plain(*args))
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefix_attention(*meta)


def _ffn_inputs(B, D=256, F=1024, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, D)).astype(np.float32),
            (rng.standard_normal((D, F)) * 0.05).astype(np.float32),
            (rng.standard_normal((F,)) * 0.01).astype(np.float32),
            (rng.standard_normal((F, D)) * 0.05).astype(np.float32),
            (rng.standard_normal((D,)) * 0.01).astype(np.float32))


def _jax_fused_interp(x, w1, b1, w2, b2, tile_f):
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jfd.fused_ffn(x, w1, b1, w2, b2, tile_f=tile_f))


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("fp8", [False, True])
def test_fused_ffn_plain_matches_jax_interpret(B, fp8):
    x, w1, b1, w2, b2 = _ffn_inputs(B, seed=B + 2 * fp8)
    jw1, jw2 = jnp.asarray(w1), jnp.asarray(w2)
    if fp8:
        jw1, jw2 = _quantize_matrix(jw1), _quantize_matrix(jw2)
    want = _jax_fused_interp(jnp.asarray(x), jw1, jnp.asarray(b1), jw2,
                             jnp.asarray(b2), tile_f=256)
    conv = lambda w: ({"q": to_torch(w["q"]), "scale": to_torch(w["scale"])}
                      if isinstance(w, dict) else to_torch(w))
    got = fused_ffn(torch.from_numpy(x), conv(jw1), torch.from_numpy(b1),
                    conv(jw2), torch.from_numpy(b2)).numpy()
    tol = 1e-4 if fp8 else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_fused_ffn_wrapper_takes_plain_version_only_on_cpu():
    x, w1, b1, w2, b2 = map(torch.from_numpy, _ffn_inputs(2, D=64, F=96))
    assert torch.equal(fused_ffn(x, w1, b1, w2, b2),
                       fused_ffn_plain(x, w1, b1, w2, b2))
    with pytest.raises(ValueError, match="CUDA"):
        fused_ffn(*(t.to("meta") for t in (x, w1, b1, w2, b2)))


F32, BF16, FP8 = torch.float32, torch.bfloat16, torch.float8_e4m3fn


@pytest.mark.parametrize("x_dtype,w_dtype,B,D,F,want", [
    (BF16, BF16, 1, 2048, 8192, "sm90"),       # giga830M, the card's path
    (BF16, FP8, 8, 2048, 8192, "sm90"),
    (BF16, BF16, 4, 1024, 4096, "sm90"),
    (BF16, FP8, 1, 64, 256, "sm90"),           # tiny_test
    (F32, F32, 1, 2048, 8192, "f32"),          # the check kernel
    (F32, FP8, 8, 100, 300, "f32"),            # it takes any D and F
    (BF16, BF16, 9, 2048, 8192, ValueError),   # more rows than the mma's n
    (BF16, BF16, 0, 2048, 8192, ValueError),
    (F32, F32, 9, 64, 256, ValueError),
    (BF16, BF16, 1, 2000, 8000, ValueError),   # D, F not multiples of 64
    (BF16, BF16, 1, 2048, 8100, ValueError),
    (BF16, BF16, 1, 4096, 16384, ValueError),  # wider than any preset
    (BF16, F32, 1, 2048, 8192, TypeError),
    (F32, BF16, 1, 2048, 8192, TypeError),
    (torch.float16, torch.float16, 1, 2048, 8192, TypeError),
])
def test_fused_ffn_routes_cuda_calls(x_dtype, w_dtype, B, D, F, want):
    """Which kernel a CUDA call of fused_ffn launches, and what raises: bf16
    x goes to the sm90 kernel, f32 x to the check kernel, nothing falls
    back."""
    if isinstance(want, str):
        assert ffn_route(x_dtype, w_dtype, B, D, F) == want
    else:
        with pytest.raises(want):
            ffn_route(x_dtype, w_dtype, B, D, F)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_fused_ffn_sm90_partition_covers_every_hidden_column_once(preset):
    """The sm90 kernel's split of F over its blocks (as the kernel computes
    it): every 64-column tile of every preset's FFN exactly once, contiguous
    runs, at most FFN_MAX_BLOCKS blocks whose loads differ by at most one
    tile.  A Kimi Linear preset has no VoiceCraft FFN of width 4 D (its
    width, 2304, is past the kernel's): the decode loop refuses it the
    fused FFN, naming the block."""
    cfg = PRESETS[preset]()
    if cfg.block == "kimi_linear":
        from voicecraft_tpu_torch.models.voicecraft import require_voicecraft
        with pytest.raises(ValueError, match="kimi_linear"):
            require_voicecraft(cfg, "the fused FFN")
        return
    F = cfg.ffn_dim
    assert ffn_route(BF16, BF16, 1, cfg.d_model, F) == "sm90"
    runs = ffn_sm90_tiles(F)
    assert 1 <= len(runs) <= FFN_MAX_BLOCKS
    cols = [c for r in runs for t in r
            for c in range(t * FFN_TILE_F, (t + 1) * FFN_TILE_F)]
    assert cols == list(range(F))
    sizes = [len(r) for r in runs]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


def test_fused_ffn_rejects_non_relu_models():
    """The fused kernel hard-codes relu: decode_step_fast refuses a model
    built with another activation, as the JAX package does."""
    from voicecraft_tpu.config import tiny_test
    from voicecraft_tpu_torch.models import transformer as trm
    from voicecraft_tpu_torch.models.voicecraft import VoiceCraft
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32",
                              ffn_activation="doubleswish")
    model = VoiceCraft(cfg, "cpu").init_weights(torch.Generator().manual_seed(0))
    cache = trm.init_kv_cache(cfg.num_decoder_layers, 1, 32, cfg.nhead,
                              cfg.head_dim, torch.float32, "cpu")
    x_t = torch.zeros((1, 1, cfg.d_model))
    with pytest.raises(ValueError, match="relu"):
        trm.decode_step_fast(model.decoder, x_t, cache, torch.tensor(4),
                             fused_ffn=True)


def test_kernel_build_is_keyed_by_sources_and_reports_nvcc_errors(
        tmp_path, monkeypatch):
    """The build glue of ops/_native.py with a stand-in nvcc: one build per
    distinct set of sources (an nvcc per source, then a link), reuse
    otherwise, and a failing compile raises with the compiler's message."""
    from voicecraft_tpu_torch.ops import _native
    csrc, bin_dir = tmp_path / "csrc", tmp_path / "cuda" / "bin"
    csrc.mkdir()
    bin_dir.mkdir(parents=True)
    (csrc / "a.cu").write_text("// kernel a\n")
    (csrc / "common.cuh").write_text("// header\n")
    calls = tmp_path / "calls"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        'case "$*" in *broken*) echo "error: broken.cu" >&2; exit 2;; esac\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n'
        'echo "ptxas info    : Used 32 registers" >&2\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_native, "CSRC_DIR", csrc)
    monkeypatch.setattr(_native, "BUILD_ROOT", tmp_path / "build")

    path, log = _native.build()
    assert path.exists() and "registers" in log
    assert _native.build() == (path, "")              # reused, not rebuilt
    (csrc / "common.cuh").write_text("// header, edited\n")
    path2, _ = _native.build()
    assert path2 != path and path2.exists()
    assert len(calls.read_text().split()) == 2 * 2    # a.cu, the link
    (csrc / "broken.cu").write_text("// does not compile\n")
    with pytest.raises(RuntimeError, match="error: broken.cu"):
        _native.build()
