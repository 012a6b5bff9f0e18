"""The plain reference against the port at tiny size on the CPU, and the
import guard."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from bench_helpers import tiny_config
from harness import common, runner
from harness.check import served_gap, tts_rows_from_codes

CFG = tiny_config(common.load_json(common.BENCH_DIR / "configs"
                                   / "giga830M_TTSEnhanced.json"))
CFG["reference"] = "voicecraft"


def _ctx():
    cell = common.load_cell("tts830e.single")
    return runner.Context(cell, 4242, 1.0, False, device="cpu",
                          config_overrides=CFG)


def _prefill_logits(model, x, cols):
    from voicecraft_tpu_torch.models.voicecraft import prefill_prompt
    K, S = cols.shape
    yt = torch.as_tensor(cols)[None]
    mi = torch.full((1, S), -1)
    _, logits, _ = prefill_prompt(model, torch.as_tensor(x)[None], len(x), yt,
                                  S, mi, s_max=len(x) + S + 4)
    return logits[0]


@pytest.mark.parametrize("weights", ["exact", "fp8"])
def test_reference_matches_the_port(weights):
    """Every column's logits: the reference's full forward against the
    port's prefill of each prefix (f32 on the CPU), with the fp8 weights
    worked out again on the reference's side."""
    ctx = _ctx()
    model = ctx.build_model()
    if weights == "fp8":
        from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
        model = quantize_decoder_fp8(model, pack_qkv=True)
    ref, _ = ctx.reference(weights)
    rng = np.random.default_rng(3)
    x = rng.integers(0, CFG["text_vocab_size"], 7)
    prompt = torch.as_tensor(rng.integers(0, CFG["audio_vocab_size"], (4, 12)))
    cols = ref.tts_columns(prompt, torch.zeros((0, 4), dtype=torch.long))
    full = ref.logits(torch.as_tensor(x), cols)
    for s in (1, 5, cols.shape[1]):
        got = _prefill_logits(model, x, cols[:, :s].numpy())
        torch.testing.assert_close(full[s - 1], got, rtol=1e-4, atol=1e-4)


def test_fp8_slab_changes_only_decode_columns():
    ref, _ = _ctx().reference("exact")
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.integers(0, CFG["text_vocab_size"], 5))
    cols = torch.as_tensor(rng.integers(0, CFG["audio_vocab_size"], (4, 20)))
    a = ref.logits(x, cols)
    b = ref.logits(x, cols, kv="fp8", decode_from=12)
    torch.testing.assert_close(a[:12], b[:12], rtol=0, atol=0)
    assert (a[12:] - b[12:]).abs().max() > 0


def test_served_gap_and_rows():
    gen = torch.tensor([[5, 6, 7], [8, 9, 10]])
    rows = tts_rows_from_codes(gen, 2, 99)
    assert rows.tolist() == [[5, 99], [6, 8], [7, 9]]
    logits = torch.zeros((3, 2, 101))
    logits[0, 0, 5] = 2.0
    logits[0, 0, 3] = 2.5                       # the reference prefers 3
    logits[1, 0, 6] = 1.0
    logits[2, 0, 7] = 1.0
    logits[1, 1, 8] = 1.0
    logits[2, 1, 9] = 1.0
    logits[:, :, 100] = 50.0                    # a special code: not a candidate
    gap, total, cells = served_gap(logits, rows, V=99)
    assert cells == 5 and gap == pytest.approx(0.5)
    assert total == pytest.approx(0.5)
    ctrl = logits.clone()
    ctrl[2, 1, 4] = 9.0
    cgap, ctotal, _ = served_gap(logits, rows, V=99, ctrl_logits=ctrl)
    assert cgap == pytest.approx(1.0) and ctotal == pytest.approx(1.0)
    # a silence code repeated in codebook 0 stays a candidate after itself
    # (the sampler's penalty waits for more repeats than stop_repetition)
    rows2 = torch.tensor([[3, 99], [3, 8], [7, 9]])
    logits[1, 0, 3] = 1.5
    gap2, _, _ = served_gap(logits, rows2, V=99, silence=[3],
                            stop_repetition=3)
    assert gap2 == pytest.approx(0.0)


def test_import_guard_names_what_it_finds(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(ImportError, match="jax"):
        common.guard_imports("test")
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "voicecraft_tpu_torch_x",
                        types.ModuleType("voicecraft_tpu_torch_x"))
    common.guard_imports("a name that only begins with the JAX package's")


def test_a_run_loads_no_jax():
    """A whole tiny run, the reference included, in a fresh process: no
    module whose top-level name is jax, jaxlib, flax or voicecraft_tpu."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from bench_helpers import tiny_run\n"
        "line, _ = tiny_run('tts830e.single', seconds=0.5)\n"
        "from harness import common\n"
        "assert line['correct'], line\n"
        "print('FOUND', common.forbidden_modules())\n"
        % (os.path.dirname(__file__), str(common.BENCH_DIR)))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300,
                         cwd=str(common.REPO_DIR))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
