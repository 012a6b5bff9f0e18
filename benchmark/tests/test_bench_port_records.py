"""The arithmetic of the readers of the port's spans and counters
(``harness/port_records.py``) on hand-built traced slices and records: the
slice's spans, the prefill's pairing of launch calls and device operations
by correlation id (eager, and beside a replayed CUDA graph), the engine's
rule (the
set-up's request 0 and everything the slice touched left out), and None
where there is nothing to read."""

import types

import pytest

from harness import port_records as pr
from harness.common import RunResult, percentile
from harness.trace import TraceSummary
from voicecraft_tpu_torch.utils.tracing import Burst, RequestMark, Span

US = 1_000_000_000_000.0        # the slice's clock origin, in us


def _res(device_ops, host_ops, window_s=1.0, correlation=None):
    return RunResult(attempted=1, failed=0,
                     trace=TraceSummary(device_ops, host_ops, window_s,
                                        correlation=correlation or {}))


def _span(name, s_us, e_us, i=0, parent=None):
    return Span(name, int(s_us * 1e3), int(e_us * 1e3), i, parent)


@pytest.fixture
def records(monkeypatch):
    """Replace the port's records by a test's own lists."""
    rec = types.SimpleNamespace(spans=[], marks=[], bursts=[])
    fake = types.SimpleNamespace(spans=lambda: list(rec.spans),
                                 request_marks=lambda: list(rec.marks),
                                 bursts=lambda: list(rec.bursts))
    monkeypatch.setattr(pr, "_tracing", lambda: fake)
    return rec


def _decode_slice():
    """One traced request: host events over [US, US + 100]; a prefill span
    [US + 10, US + 30] whose 3 launches and a copy run on the device until
    US + 45, then two steps of 30 us (one sync each).  Each launch call
    and its device operation share a correlation id (10 + k)."""
    launch = lambda t: ("cudaLaunchKernel", t, t + 1)
    host = [("aten::empty", US, US + 2), launch(US + 5),
            launch(US + 12), ("cudaMemcpyAsync", US + 20, US + 21),
            launch(US + 28), launch(US + 40), launch(US + 70),
            ("cudaStreamSynchronize", US + 95, US + 100)]
    host_corr = [3, 10, 11, 12, 13, 14, 15, 16]
    dev = [("k0", US + 6, US + 8), ("k1", US + 13, US + 25),
           ("Memcpy HtoD", US + 25, US + 26), ("k2", US + 29, US + 45),
           ("k3", US + 45, US + 50), ("k4", US + 71, US + 72)]
    dev_corr = [10, 11, 12, 13, 14, 15]
    spans = [_span("old.prefill", US - 500, US - 400),
             _span("decode.prefill", US + 10, US + 30, 1),
             _span("decode.step", US + 30, US + 60, 2),
             _span("decode.sync", US + 60, US + 62, 4),
             _span("decode.step", US + 62, US + 92, 5),
             _span("decode.sync", US + 92, US + 99, 7)]
    return _res(dev, host, correlation={"device": dev_corr,
                                        "host": host_corr}), spans


def test_decode_spans(records):
    res, records.spans = _decode_slice()
    # k2 is the operation of the last launch inside the prefill span
    assert pr.prefill_ms(res) == pytest.approx((45 - 10) / 1e3)
    assert pr.step_host_ms(res) == pytest.approx(30 / 1e3)
    assert pr.sync_wait_ms_per_step(res) == pytest.approx(9 / 2 / 1e3)
    # a span of an earlier profiled period is not the slice's
    assert pr.slice_spans(res, "old.prefill") == []


def test_prefill_needs_every_launch_paired(records):
    """The prefill's last launch call must pair with a device operation by
    its correlation id; a slice without the ids reads nothing."""
    res, records.spans = _decode_slice()
    k2 = res.trace.device_ops.index(("k2", US + 29, US + 45))
    res.trace.correlation["device"][k2] = 99
    assert pr.prefill_ms(res) is None
    res, _ = _decode_slice()
    res.trace.correlation = {}
    assert pr.prefill_ms(res) is None


def test_prefill_beside_a_replayed_graph(records):
    """The prefill, an eager step, then replayed steps: a graph launch puts
    several kernels on the device under its own id and no launch call of
    their own, so launch calls and device operations no longer match in
    number; the prefill still pairs by id."""
    launch = lambda t: ("cudaLaunchKernel", t, t + 1)
    host = [launch(US + 11), launch(US + 15), ("cudaMemsetAsync", US + 18, US + 19),
            launch(US + 40),
            ("cudaGraphLaunch", US + 60, US + 62),
            ("cudaGraphLaunch", US + 80, US + 82)]
    host_corr = [1, 2, 3, 4, 5, 6]
    dev = [("k0", US + 12, US + 14), ("k1", US + 16, US + 19),
           ("Memset", US + 19, US + 33), ("step", US + 41, US + 55)]
    dev_corr = [1, 2, 3, 4]
    for g, t0 in ((5, US + 63), (6, US + 83)):
        for j in range(4):
            dev.append((f"graph_k{j}", t0 + 2 * j, t0 + 2 * j + 1))
            dev_corr.append(g)
    records.spans = [_span("decode.prefill", US + 10, US + 20, 1),
                     _span("decode.step", US + 38, US + 58, 2),
                     _span("decode.step", US + 58, US + 78, 3),
                     _span("decode.step", US + 78, US + 98, 4)]
    res = _res(dev, host, correlation={"device": dev_corr, "host": host_corr})
    assert len(dev) != len(host)
    # the memset is the prefill's last operation, ending at US + 33
    assert pr.prefill_ms(res) == pytest.approx((33 - 10) / 1e3)


def test_optimizer_from_the_update_to_the_last_operation(records):
    host = [("aten::mm", US, US + 10), ("cudaLaunchKernel", US + 50, US + 51),
            ("aten::item", US + 60, US + 300)]
    dev = [("bwd", US + 1, US + 40), ("adam", US + 52, US + 250)]
    records.spans = [_span("train.update", US + 45, US + 120)]
    res = _res(dev, host)
    assert pr.optimizer_ms(res) == pytest.approx((250 - 45) / 1e3)


def _ns(us):
    return int((US + us) * 1e3)


def test_engine_counters_before_the_slice(records):
    """Request 0 (set-up) and its bursts, the slice's work and what was
    not retired before it are left out; only the last engine counts."""
    # the slice's host events start at US + 1000
    res = _res([("k", US + 1000, US + 1001)],
               [("aten::mm", US + 1000, US + 1500)])
    M = RequestMark
    records.marks = [
        M(1, 0, "admit", _ns(0)), M(1, 0, "first_rows", _ns(20)),
        M(1, 0, "retire", _ns(30)),
        M(2, 0, "admit", _ns(40)), M(2, 0, "first_rows", _ns(60)),
        M(2, 0, "retire", _ns(70)),
        M(2, 1, "admit", _ns(100)), M(2, 2, "admit", _ns(110)),
        M(2, 1, "first_rows", _ns(200)), M(2, 2, "first_rows", _ns(400)),
        M(2, 1, "retire", _ns(500)), M(2, 2, "retire", _ns(600)),
        M(2, 3, "admit", _ns(700)), M(2, 3, "first_rows", _ns(720)),
        M(2, 3, "retire", _ns(1100)),      # after the slice began
        M(2, 4, "admit", _ns(800)), M(2, 4, "first_rows", _ns(900)),
    ]
    B = lambda s, e, admit, wait, refills: Burst(
        2, _ns(s), _ns(e), int(admit * 1e3), int(wait * 1e3), refills)
    records.bursts = [
        Burst(1, _ns(0), _ns(50), 10_000, 0, 5),
        B(40, 70, 3, 20, 1),               # the set-up's, before opening
        B(95, 300, 20, 100, 2), B(300, 700, 10, 300, 1),
        B(700, 1050, 40, 100, 1),          # ends inside the slice
    ]
    assert pr.first_rows_p90_ms(res) == pytest.approx(
        percentile([100 / 1e3, 290 / 1e3], 90))
    assert pr.admit_ms_per_refill(res) == pytest.approx(30 / 3 / 1e3)
    assert pr.device_wait_share(res) == pytest.approx(100 * 400 / 605)


def test_nothing_to_read_is_none(records, monkeypatch):
    """No trace (the CPU), no records, or a program without the tracing
    module: every reader returns None and raises nothing."""
    readers = [pr.prefill_ms, pr.step_host_ms,
               pr.sync_wait_ms_per_step, pr.optimizer_ms,
               pr.first_rows_p90_ms, pr.admit_ms_per_refill,
               pr.device_wait_share]
    untraced = RunResult(attempted=1, failed=0)
    empty = _res([("k", US, US + 1)], [("aten::mm", US, US + 2)])
    for read in readers:
        assert read(untraced) is None
        assert read(empty) is None
    monkeypatch.setattr(pr, "_tracing", lambda: None)
    res, _ = _decode_slice()
    for read in readers:
        assert read(res) is None
