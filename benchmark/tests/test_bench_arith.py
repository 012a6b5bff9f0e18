"""The yardstick's arithmetic: percentiles and rates over a window with a
stall, the trace reduction, and FLOP and byte counts against hand counts at
giga830M's shapes."""

import math

import numpy as np
import pytest

from harness import common, counts, readers
from harness.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, percentile
from harness.trace import TraceSummary

CFG = common.load_json(common.BENCH_DIR / "configs"
                       / "giga830M_TTSEnhanced.json")


def test_percentile_with_a_stall():
    """99 requests at 1 s/s and a stall of 10 s/s: the p90 stays 1, the
    p99 sees the stall, as numpy's linear percentile does; every request
    counts, and a failed one (inf) sits at the top."""
    rtf = [1.0] * 99 + [10.0]
    assert percentile(rtf, 90) == 1.0
    assert percentile(rtf, 99) == pytest.approx(np.percentile(rtf, 99))
    rs = np.random.default_rng(0).random(137) * 5
    for q in (50, 90, 95):
        assert percentile(rs, q) == pytest.approx(np.percentile(rs, q))
    assert percentile([1.0] * 9 + [math.inf], 95) == math.inf


def test_rate_over_a_window_with_a_stall():
    """A closed loop's rate is all the audio over all the wall: a 10 s stall
    in one request of 20 lowers it; a median of per-request rates would
    not see it."""
    audio = [5.0] * 20
    wall = [2.5] * 19 + [12.5]
    rate = sum(audio) / sum(wall)
    assert rate == pytest.approx(100.0 / 60.0)
    assert np.median([a / w for a, w in zip(audio, wall)]) == 2.0


def test_trace_busy_idle_and_gaps():
    ops = [("k1", 0.0, 100.0), ("k2", 50.0, 150.0), ("k1", 300.0, 400.0)]
    host = [("aten::mm", 140.0, 320.0), ("aten::relu", 200.0, 210.0)]
    tr = TraceSummary(ops, host, window_s=500e-6, steps=2)
    assert tr.busy_s() == pytest.approx(250e-6)
    assert tr.op_seconds() == pytest.approx(300e-6)
    assert tr.idle_gaps() == [(150.0, 300.0)]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(200e-6)]
    assert bd["idle_gaps"] == [["aten::mm", pytest.approx(150e-6)]]
    res = common.RunResult(attempted=1, failed=0, trace=tr)
    assert readers.ops_per_step(res) == 1.5
    assert readers.idle_share(res) == pytest.approx(50.0)
    assert readers.device_ms_per_step(res) == pytest.approx(0.15)


def test_fused_ffn_bytes_give_the_bound():
    """The bf16 FFN at one row: w1 and w2 of 2048 x 8192 are 67.1 MB, the
    0.0200 ms bound at 3.35 TB/s (PERF.md's kernel table)."""
    b = counts.fused_ffn_bytes(CFG, rows=1)
    assert 2 * 2048 * 8192 * 2 == 67_108_864
    assert b == 67_108_864 + (8192 + 2048) * 2 + 2 * 2048 * 2
    assert b / PEAK_HBM_BYTES * 1e3 == pytest.approx(0.0200, abs=5e-5)
    b8 = counts.fused_ffn_bytes(CFG, rows=1, weight_bytes=1)
    assert b8 / PEAK_HBM_BYTES * 1e3 == pytest.approx(0.0100, abs=5e-5)


def test_roofline_reader():
    cfg_bytes = counts.fused_ffn_bytes(CFG, rows=1)
    t = cfg_bytes / PEAK_HBM_BYTES * 2          # twice the bound
    tr = TraceSummary([("void ffn_sm90_kernel<bf16>", 0.0, t * 1e6)], [], 1.0,
                      steps=1)
    res = common.RunResult(attempted=1, failed=0, trace=tr,
                           readings={"cfg": CFG})
    assert readers.fused_ffn_roofline_bf16(res) == pytest.approx(50.0)
    res.trace = TraceSummary([("other", 0.0, 1.0)], [], 1.0, steps=1)
    assert readers.fused_ffn_roofline_bf16(res) is None


def test_decode_and_prefill_flops_by_hand():
    D, F, L, K = 2048, 8192, 16, 4
    per_layer = 4 * D * D + 2 * D * F                    # 50,331,648
    assert counts.layer_matmul_params(CFG) == per_layer == 50_331_648
    heads = K * (D * 1024 + 1024 * 2052)                 # 16,793,600
    assert counts.head_matmul_params(CFG) == heads == 16_793_600
    one = 2 * (L * per_layer + heads) + L * 4 * D * 500
    assert counts.decode_token_flops(CFG, 500) == one
    assert one == 1_709_735_936
    span = sum(counts.decode_token_flops(CFG, 500 + i) for i in range(7))
    assert counts.decode_span_flops(CFG, 500, 7) == pytest.approx(span)
    p = counts.prefill_flops(CFG, 10)
    assert p == 2 * 10 * L * per_layer + 2 * heads + L * 4 * D * 55
    # the whole window at 100 decode steps a second of one lane
    assert 100 * one / PEAK_BF16_FLOPS * 100 == pytest.approx(0.01729, rel=1e-3)

