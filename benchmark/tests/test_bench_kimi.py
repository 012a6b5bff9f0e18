"""The files that add Kimi-Linear-48B-A3B (``architectures/kimi_linear.py``,
``reference/kimi_linear.py``, ``configs/kimi_linear_48b_a3b.json``, the
``*.kimi`` readers): the weights at tiny size, the published counts, the
readers on synthetic slices, the reference against the port, and the cell
end to end at tiny_test_kimi's sizes on the CPU (the generic cell tests
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

CELL = "kimilinear.stream32"
CONFIG = common.load_json(common.BENCH_DIR / "configs"
                          / "kimi_linear_48b_a3b.json")
ARCH = common.architecture(CONFIG)


def _tiny():
    from voicecraft_tpu_torch.config import tiny_test_kimi
    d = dataclasses.asdict(tiny_test_kimi())
    return {**d, "kda_layers": list(d["kda_layers"]),
            "compute_dtype": "float32"}


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
    assert a["decoder.layers.1.router"].shape[1] == 16
    assert a["decoder.layers.1.experts_w1"].shape[0] == 8
    A = a["decoder.layers.0.A_log"].exp()
    assert ((A >= 1) & (A <= 16)).all()
    dt = torch.nn.functional.softplus(a["decoder.layers.0.dt_bias"])
    assert ((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all()
    assert a["decoder.layers.3.router_bias"].abs().max() <= 0.01
    bf = ARCH.make_state(cfg, 31415926535, "cpu", torch.bfloat16)
    assert bf["decoder.layers.2.experts_w2"].dtype == torch.bfloat16
    assert bf["decoder.layers.1.conv_w"].dtype == torch.bfloat16
    assert bf["decoder.layers.2.A_log"].dtype == torch.float32
    with pytest.raises(ValueError, match="kimi_linear"):
        ARCH.make_state({**cfg, "block": "voicecraft"}, 1, "cpu",
                        torch.float32)


# ---- counts -------------------------------------------------------------------------

def test_published_counts_are_the_hand_sums():
    D, HK = 2304, 32 * 128
    kda = (D * 3 * HK + 3 * HK * 4 + D * 128 + 128 * HK + D * 32 + D * 128
           + 128 * HK + HK * D)
    mla = D * 32 * 192 + D * 576 + 512 * 32 * 256 + 32 * 128 * D
    dense, expert = 3 * D * 9216, 3 * D * 1024
    assert (kda, mla, dense, expert) == (39_510_016, 29_114_368, 63_700_992,
                                         7_077_888)
    moe = 64 * expert + expert + D * 256
    assert moe == 460_652_544
    held = 20 * kda + 7 * mla + dense + 26 * moe
    assert ARCH.decoder_params(CONFIG) == held == 13_034_668_032
    full = {**CONFIG, "n_routed_experts": 256}
    assert ARCH.decoder_params(full) == 48_367_484_928 == (
        held + 26 * 192 * expert)
    kinds = [li + 1 in set(CONFIG["kda_layers"]) for li in range(27)]
    attn = [kda if k else mla for k in kinds]
    active = [attn[0] + dense] + [a + (2 + 1) * expert + D * 256
                                  for a in attn[1:]]
    assert ARCH.layer_active_params(CONFIG) == active
    assert ARCH.layer_matmul_params(CONFIG) == active[-1]
    heads = ARCH.head_matmul_params(CONFIG)
    assert heads == 4 * (D * 1024 + 1024 * 2052)
    per_key, recur = 2 * 32 * (192 + 128), 20 * 32 * 6 * 128 * 128
    assert ARCH.decode_token_flops(CONFIG, 700) == pytest.approx(
        2.0 * (sum(active) + heads) + recur + 7 * per_key * 700, rel=1e-12)
    assert ARCH.prefill_flops(CONFIG, 500) == pytest.approx(
        2.0 * 500 * sum(active) + 2.0 * heads + 500 * recur
        + 7 * per_key * 500 * 501 / 2, rel=1e-12)
    rows = [0] * 64
    rows[3], rows[40] = 5, 1
    assert ARCH.expert_product_bytes(CONFIG, rows) == \
        2 * expert * 2 + 6 * (D + 2048 + 1024 + D) * 2
    # 32 lanes: the state read and written once, 134 MB, and the inputs
    assert ARCH.kda_step_bytes(CONFIG, 32) == 32 * (
        8 * 32 * 128 * 128 + 32 * (3 * 128 * 2 + 128 * 4 + 4 + 128 * 4))


# ---- the readers ----------------------------------------------------------------------

def _read(name, res):
    return runner.read_metric(name, res)


class _Res:
    def __init__(self, trace, readings=None):
        self.trace, self.readings = trace, readings or {}


KIMI_READERS = ("kda_share.kimi", "kda_roofline.kimi", "moe_share.kimi",
                "expert_roofline.kimi", "latent_attn_share.kimi",
                "experts_touched.kimi")


def test_readers_read_synthetic_slices_and_none_without_spans():
    """Four launches at host 10, 30, 60 and 80 us (ids 1-4) putting device
    operations of 2, 3, 5 and 10 us on the stream; kda.attend covers the
    first two launches, kda.recur the second; mla.attend the third and
    moe.layer the fourth, moe.experts inside it."""
    from voicecraft_tpu_torch.utils import tracing
    tracing.clear()
    t0 = time.time_ns() // 1000
    host = [("cudaLaunchKernel", t0 + 10, t0 + 11),
            ("cudaGraphLaunch", t0 + 30, t0 + 31),
            ("cudaLaunchKernel", t0 + 60, t0 + 61),
            ("cudaLaunchKernel", t0 + 80, t0 + 81),
            ("aten::add", t0, t0 + 60_000_000)]
    dev = [("k1", t0 + 12, t0 + 14), ("kda_kernel", t0 + 32, t0 + 35),
           ("k3", t0 + 62, t0 + 67), ("k4", t0 + 82, t0 + 92)]
    tr = TraceSummary(dev, host, 0.02, steps=2,
                      correlation={"host": [1, 2, 3, 4, 0],
                                   "device": [1, 2, 3, 4]})
    cfg = {**CONFIG, common.ARCH_DIR: str(common.BENCH_DIR / "architectures")}
    res = _Res(tr, {"cfg": cfg, "lane_occupancy": 40.0})
    for name in KIMI_READERS:
        assert _read(name, res) is None, name
    assert _read("lane_occupancy.kimi", _Res(None)) is None
    S = tracing.Span
    for span in (S("kda.attend", (t0 + 5) * 1000, (t0 + 40) * 1000, 1, None),
                 S("kda.recur", (t0 + 25) * 1000, (t0 + 33) * 1000, 2, 1),
                 S("mla.attend", (t0 + 55) * 1000, (t0 + 65) * 1000, 3, None),
                 S("moe.layer", (t0 + 75) * 1000, (t0 + 85) * 1000, 4, None),
                 S("moe.experts", (t0 + 78) * 1000, (t0 + 84) * 1000, 5, 4)):
        tracing._spans.append(span)
    assert _read("kda_share.kimi", res) == pytest.approx(25.0)
    assert _read("latent_attn_share.kimi", res) == pytest.approx(25.0)
    assert _read("moe_share.kimi", res) == pytest.approx(50.0)
    assert _read("kda_roofline.kimi", res) is None       # no calls recorded
    assert _read("experts_touched.kimi", res) is None
    rows = torch.zeros((26, 64), dtype=torch.long)
    rows[:, 0], rows[:, 5], rows[0, 9] = 3, 1, 2
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tracing.record_expert_rows(rows)
        tracing.record_kda_call(32)
        tracing.record_kda_call(32)
    assert _read("experts_touched.kimi", res) == pytest.approx(
        (26 + 26 + 1) / 26)
    need = sum(ARCH.expert_product_bytes(cfg, r.tolist()) for r in rows)
    assert _read("expert_roofline.kimi", res) == pytest.approx(
        100.0 * need / common.PEAK_HBM_BYTES / 10e-6)
    assert _read("kda_roofline.kimi", res) == pytest.approx(
        100.0 * 2 * ARCH.kda_step_bytes(cfg, 32) / common.PEAK_HBM_BYTES
        / 3e-6)
    assert _read("step_device_ms.kimi", res) == pytest.approx(0.01)
    assert _read("idle_share.kimi", res) == pytest.approx(
        100.0 * (1 - 20e-6 / 0.02))
    assert _read("lane_occupancy.kimi", res) == 40.0
    assert _read("mfu.kimi", res) is None
    tracing.clear()


# ---- the reference against the port --------------------------------------------------

def test_reference_matches_the_port():
    """Every audio column's logits: the reference's full forward against
    the port's prefill of each prefix with text padding (f32 on the CPU;
    sums in another order, so to 1e-5)."""
    from voicecraft_tpu_torch.config import ModelConfig
    from voicecraft_tpu_torch.models.voicecraft import (VoiceCraft,
                                                        prefill_prompt)
    cfg = {**CONFIG, **_tiny()}
    state = ARCH.make_state(cfg, 4242, "cpu", torch.float32)
    model = VoiceCraft(ModelConfig.from_dict(cfg), "cpu")
    model.load_state_dict(state, strict=True)
    mod = common.load_file(common.BENCH_DIR / "reference" / "kimi_linear.py",
                           "t_ref_kimi")
    mod.exact_f32()
    ref = mod.Reference(cfg, state, "cpu")
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.integers(0, cfg["text_vocab_size"], 7))
    prompt = torch.as_tensor(rng.integers(0, cfg["audio_vocab_size"], (4, 12)))
    cols = ref.tts_columns(prompt, torch.zeros((0, 4), dtype=torch.long))
    full = ref.logits(x, cols)
    x_pad = 10
    xp = torch.full((1, x_pad), cfg["text_pad_token"])
    xp[0, :7] = x
    for s in (1, 5, cols.shape[1]):
        _, got, _ = prefill_prompt(model, xp, len(x), cols[None, :, :s], s,
                                   torch.full((1, s), -1),
                                   s_max=x_pad + s + 4)
        torch.testing.assert_close(full[s - 1], got[0], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="cache rounding"):
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
