"""The readers of the decode step's CUDA graph (``metrics/
graph_step_share.single.py`` and ``metrics/graph_capture_ms.single.py``)
on hand-built traced slices and spans: the share of the steps that
replayed the graph, the capture's mean wall, and None where there is
nothing to read (no trace, no graph: an eager decode, or a program
without the tracing module)."""

import types

import pytest

from harness import port_records as pr
from harness import runner
from harness.common import RunResult
from harness.trace import TraceSummary
from voicecraft_tpu_torch.utils.tracing import Span

US = 1_000_000_000_000.0        # the slice's clock origin, in us


def _res():
    """One traced request: host events over [US, US + 1000]."""
    return RunResult(attempted=1, failed=0, trace=TraceSummary(
        [("k", US + 1, US + 2)],
        [("aten::mm", US, US + 10), ("cudaGraphLaunch", US + 990, US + 1000)],
        1.0))


def _span(name, s_us, e_us, i=0, parent=None):
    return Span(name, int(s_us * 1e3), int(e_us * 1e3), i, parent)


@pytest.fixture
def spans(monkeypatch):
    """Replace the port's spans by a test's own list."""
    rec = []
    fake = types.SimpleNamespace(spans=lambda: list(rec))
    monkeypatch.setattr(pr, "_tracing", lambda: fake)
    return rec


def _read(name, res):
    return runner.read_metric(name, res)


def _graphed_decode(n_steps, capture_us):
    """A prefill, an eager first step, a capture of ``capture_us`` before
    the second step, then n_steps - 1 replayed steps, a sync after each;
    and a capture of an earlier profiled period, outside the slice."""
    out = [_span("decode.capture", US - 900, US - 100, 1),
           _span("decode.prefill", US + 10, US + 30, 2),
           _span("decode.step", US + 30, US + 60, 3),
           _span("decode.sync", US + 60, US + 61, 4),
           _span("decode.capture", US + 61, US + 61 + capture_us, 5)]
    t, i = US + 61 + capture_us, 6
    for _ in range(n_steps - 1):
        out += [_span("decode.replay", t + 1, t + 3, i + 1, i),
                _span("decode.step", t, t + 4, i),
                _span("decode.sync", t + 4, t + 5, i + 2)]
        t, i = t + 5, i + 3
    return out


def test_share_of_replayed_steps(spans):
    spans += _graphed_decode(128, 20)
    assert _read("graph_step_share.single", _res()) == pytest.approx(
        100 * 127 / 128)


def test_capture_wall(spans):
    spans += _graphed_decode(4, 250)
    # the earlier period's 800 us capture lies outside the slice
    assert _read("graph_capture_ms.single", _res()) == pytest.approx(0.25)
    spans.append(_span("decode.capture", US + 500, US + 850, 99))
    assert _read("graph_capture_ms.single", _res()) == pytest.approx(0.3)


def test_nothing_to_read_is_none(spans, monkeypatch):
    """No trace (the CPU); an eager decode (steps, no replay or capture);
    a program without the tracing module: None, and nothing raises."""
    names = ("graph_step_share.single", "graph_capture_ms.single")
    untraced = RunResult(attempted=1, failed=0)
    spans += [_span("decode.prefill", US + 10, US + 30, 1),
              _span("decode.step", US + 30, US + 60, 2),
              _span("decode.sample", US + 31, US + 40, 3, 2),
              _span("decode.sync", US + 60, US + 61, 4)]
    for name in names:
        assert _read(name, untraced) is None
        assert _read(name, _res()) is None
    spans.clear()
    spans += _graphed_decode(8, 20)
    monkeypatch.setattr(pr, "_tracing", lambda: None)
    for name in names:
        assert _read(name, _res()) is None
