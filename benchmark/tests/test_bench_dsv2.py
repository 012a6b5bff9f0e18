"""The files that add DeepSeek-V2-Lite (``architectures/deepseek_v2.py``,
``reference/deepseek_v2.py``, ``configs/deepseek_v2_lite.json``, the
``*.dsv2`` readers): the weights at tiny size, the published counts, the
readers on synthetic slices, the reference against the port, and the cell
end to end at tiny_test_dsv2's sizes on the CPU (the generic cell tests
size every configuration as tiny_test, VoiceCraft's block)."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from bench_helpers import TINY_LIMITS, TINY_TRAFFIC
from harness import common, runner
from harness.trace import TraceSummary

CELL = "dsv2lite.stream32"
CONFIG = common.load_json(common.BENCH_DIR / "configs"
                          / "deepseek_v2_lite.json")
ARCH = common.architecture(CONFIG)


def _tiny():
    from voicecraft_tpu_torch.config import tiny_test_dsv2
    return {**dataclasses.asdict(tiny_test_dsv2()), "compute_dtype": "float32"}


def _tiny_run(seed=424242424242, trace=False, control=False):
    cell = common.load_cell(CELL)
    ctx = runner.Context(
        cell, seed, 1.5, trace, device="cpu", control=control,
        config_overrides=_tiny(),
        traffic_overrides={**TINY_TRAFFIC["engine_open"],
                           "limits": {k: TINY_LIMITS[k]
                                      for k in cell.traffic["limits"]}})
    return runner.run_cell(ctx)


# ---- weights ------------------------------------------------------------------------

def test_state_loads_strictly_and_repeats_by_seed():
    from voicecraft_tpu_torch.config import ModelConfig
    from voicecraft_tpu_torch.models.voicecraft import VoiceCraft
    cfg = {**CONFIG, **_tiny()}
    a = ARCH.make_state(cfg, 31415926535, "cpu", torch.float32)
    b = ARCH.make_state(cfg, 31415926535, "cpu", torch.float32)
    c = ARCH.make_state(cfg, 27182818284, "cpu", torch.float32)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.layers.1.experts_w1"],
                           c["decoder.layers.1.experts_w1"])
    model = VoiceCraft(ModelConfig.from_dict(cfg), "cpu")
    model.load_state_dict(a, strict=True)
    assert "heads.b2" in a and a["heads.b2"].dtype == torch.float32
    bf = ARCH.make_state(cfg, 31415926535, "cpu", torch.bfloat16)
    assert bf["decoder.layers.2.experts_w2"].dtype == torch.bfloat16
    assert bf["decoder.layers.2.ln2_g"].dtype == torch.float32


# ---- counts -------------------------------------------------------------------------

def test_published_counts_are_the_hand_sums():
    mla = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    assert mla == 13_762_560
    dense, expert = 3 * 2048 * 10944, 3 * 2048 * 1408
    assert (dense, expert) == (67_239_936, 8_650_752)
    assert ARCH.decoder_params(CONFIG) == 15_286_927_360 == (
        27 * mla + dense + 26 * (64 * expert + 2 * expert + 2048 * 64))
    active = [mla + dense] + [mla + 8 * expert + 2048 * 64] * 26
    assert ARCH.layer_active_params(CONFIG) == active
    assert ARCH.layer_matmul_params(CONFIG) == active[-1]
    heads = ARCH.head_matmul_params(CONFIG)
    assert heads == 4 * (2048 * 1024 + 1024 * 2052)
    per_key = 2 * 16 * (192 + 128)
    assert ARCH.decode_token_flops(CONFIG, 700) == \
        2.0 * (sum(active) + heads) + 27 * per_key * 700
    assert ARCH.prefill_flops(CONFIG, 500) == \
        2.0 * 500 * sum(active) + 2.0 * heads + 27 * per_key * 500 * 501 / 2
    rows = [0] * 64
    rows[3], rows[40] = 5, 1
    assert ARCH.expert_product_bytes(CONFIG, rows) == \
        2 * expert * 2 + 6 * (2048 + 2816 + 1408 + 2048) * 2


# ---- the readers ----------------------------------------------------------------------

def _read(name, res):
    return runner.read_metric(name, res)


class _Res:
    def __init__(self, trace, readings=None):
        self.trace, self.readings = trace, readings or {}


def test_readers_read_synthetic_slices_and_none_without_spans():
    """Three launches at host 10, 30 and 60 us (ids 1-3) putting device
    operations of 2, 3 and 5 us on the stream; moe.layer spans cover the
    first two launches, moe.experts the second, mla.attend the third."""
    from voicecraft_tpu_torch.utils import tracing
    tracing.clear()
    t0 = time.time_ns() // 1000
    host = [("cudaLaunchKernel", t0 + 10, t0 + 11),
            ("cudaLaunchKernel", t0 + 30, t0 + 31),
            ("cudaLaunchKernel", t0 + 60, t0 + 61),
            ("aten::add", t0, t0 + 60_000_000)]
    dev = [("k1", t0 + 12, t0 + 14), ("k2", t0 + 32, t0 + 35),
           ("k3", t0 + 62, t0 + 67)]
    tr = TraceSummary(dev, host, 0.005, steps=2,
                      correlation={"host": [1, 2, 3, 0],
                                   "device": [1, 2, 3]})
    cfg = {**CONFIG, common.ARCH_DIR: str(common.BENCH_DIR / "architectures")}
    res = _Res(tr, {"cfg": cfg})
    for name in ("moe_share.dsv2", "latent_attn_share.dsv2",
                 "expert_roofline.dsv2", "experts_touched.dsv2"):
        assert _read(name, res) is None, name
    S = tracing.Span
    for span in (S("moe.layer", (t0 + 5) * 1000, (t0 + 40) * 1000, 1, None),
                 S("moe.experts", (t0 + 25) * 1000, (t0 + 33) * 1000, 2, 1),
                 S("mla.attend", (t0 + 55) * 1000, (t0 + 65) * 1000, 3, None)):
        tracing._spans.append(span)
    assert _read("moe_share.dsv2", res) == pytest.approx(50.0)
    assert _read("latent_attn_share.dsv2", res) == pytest.approx(50.0)
    assert _read("experts_touched.dsv2", res) is None
    rows = torch.zeros((26, 64), dtype=torch.long)
    rows[:, 0], rows[:, 5], rows[0, 9] = 3, 1, 2
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tracing.record_expert_rows(rows)
        tracing.record_expert_rows(rows)
    assert _read("experts_touched.dsv2", res) == pytest.approx(
        (2 * 26 + 1) / 26)
    need = 2 * sum(ARCH.expert_product_bytes(cfg, r.tolist()) for r in rows)
    assert _read("expert_roofline.dsv2", res) == pytest.approx(
        100.0 * need / common.PEAK_HBM_BYTES / 3e-6)
    assert _read("step_device_ms.dsv2", res) == pytest.approx(0.005)
    tracing.clear()


# ---- the reference against the port --------------------------------------------------

def test_reference_matches_the_port():
    """Every audio column's logits: the reference's full forward against
    the port's prefill of each prefix (f32 on the CPU; sums in another
    order, so to 1e-5)."""
    from voicecraft_tpu_torch.config import ModelConfig
    from voicecraft_tpu_torch.models.voicecraft import (VoiceCraft,
                                                        prefill_prompt)
    cfg = {**CONFIG, **_tiny()}
    state = ARCH.make_state(cfg, 4242, "cpu", torch.float32)
    model = VoiceCraft(ModelConfig.from_dict(cfg), "cpu")
    model.load_state_dict(state, strict=True)
    mod = common.load_file(common.BENCH_DIR / "reference" / "deepseek_v2.py",
                           "t_ref_dsv2")
    mod.exact_f32()
    ref = mod.Reference(cfg, state, "cpu")
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.integers(0, cfg["text_vocab_size"], 7))
    prompt = torch.as_tensor(rng.integers(0, cfg["audio_vocab_size"], (4, 12)))
    cols = ref.tts_columns(prompt, torch.zeros((0, 4), dtype=torch.long))
    full = ref.logits(x, cols)
    for s in (1, 5, cols.shape[1]):
        _, got, _ = prefill_prompt(model, x[None], len(x), cols[None, :, :s],
                                   s, torch.full((1, s), -1),
                                   s_max=len(x) + s + 4)
        torch.testing.assert_close(full[s - 1], got[0], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="latent"):
        ref.logits(x, cols, kv="fp8")


# ---- the cell at tiny size ---------------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct_at_tiny_size(trace):
    line, res = _tiny_run(trace=trace)
    json.dumps(line)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 2 and line["failed"] == 0
    if not trace:
        assert set(line["metrics"]) == {"rtf_p90", "first_frames_p90_ms",
                                        "setup_s"}
    else:
        assert set(line["metrics"]) <= {m["name"] for m in
                                         common.load_cell(CELL).per_layer}


def test_control_fails_where_the_program_passes_at_tiny_size():
    line, res = _tiny_run(control=True)
    assert line["correct"] is False, line["checks"]
    assert common.within_limits(res.readings["program"]), res.readings


def test_altered_token_is_not_correct_at_tiny_size(monkeypatch):
    from harness.faults import FAULTS
    monkeypatch.setattr(*FAULTS["altered_token"](_tiny()["audio_vocab_size"]))
    line, _ = _tiny_run()
    assert line["correct"] is False
    assert line["checks"]["logit_gap"]["value"] > TINY_LIMITS["logit_gap"]
