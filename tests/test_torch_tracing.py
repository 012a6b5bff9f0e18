"""The port's spans and counters (voicecraft_tpu_torch/utils/tracing.py) on
the CPU at tiny_test size: outputs bit-identical with tracing on and off
(TTS, the pipelined streaming engine, a training step), nothing recorded
while no profiler runs, spans nested with their parent on the profiler's
clock, the engine's counters, and the spans in the Chrome
trace that ``utils/profiling.py`` writes."""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voicecraft_tpu_torch.config import tiny_test
from voicecraft_tpu_torch.inference.engine import ContinuousBatcher
from voicecraft_tpu_torch.inference.tts import inference_tts
from voicecraft_tpu_torch.models.voicecraft import SamplingConfig, VoiceCraft
from voicecraft_tpu_torch.training.optim import ScaledAdam, stacked_leaves
from voicecraft_tpu_torch.training.step import make_train_step
from voicecraft_tpu_torch.training.synthetic import synthetic_batch
from voicecraft_tpu_torch.utils import tracing
from voicecraft_tpu_torch.utils.profiling import StepProfiler, device_trace
from tests.test_torch_spec import one_torch_thread  # noqa: F401 (autouse)

CFG = dataclasses.replace(tiny_test(), compute_dtype="float32")
SAMPLED = SamplingConfig(top_k=10, top_p=0.9, silence_tokens=(5, 7))


@pytest.fixture(autouse=True)
def fresh_records():
    tracing.clear()
    yield
    tracing.clear()


def _model(seed=3, trainable=False):
    gen = torch.Generator().manual_seed(seed)
    model = VoiceCraft(CFG, "cpu", trainable=trainable).init_weights(gen)
    return model.train() if trainable else model.eval()


def _requests(n, seed=11, text=6, step=2):
    """n requests: text ``text + step * i`` tokens, prompt 12 + 4i frames
    (the length cap, text x 10 frames, ends the short-text ones early)."""
    rng = np.random.default_rng(seed)
    K = CFG.n_codebooks
    return [(rng.integers(0, CFG.text_vocab_size,
                          text + step * i).astype(np.int32),
             rng.integers(0, CFG.audio_vocab_size,
                          (K, 12 + 4 * i)).astype(np.int32))
            for i in range(n)]


def _traced(fn):
    """fn() under a CPU torch profiler: (its result, the profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _names(spans):
    return [s.name for s in spans]


def test_nothing_is_recorded_without_a_profiler():
    """Off, a span is one shared no-op (nothing allocated, no clock read),
    and a whole decode records no span; the counters stay on."""
    assert tracing.span("a") is tracing.span("b")
    x, y = _requests(1)[0]
    inference_tts(_model(), x, y, SAMPLED, seed=5, gen_max=24)
    assert tracing.spans() == []
    eng = ContinuousBatcher(_model(), lanes=2, x_pad=32, y_pad=64,
                            gen_max=32, burst=8, scfg=SAMPLED)
    eng.submit(x, y)
    eng.run()
    assert tracing.spans() == []
    assert {m.event for m in tracing.request_marks()} == {"admit", "retire"}
    assert len(tracing.bursts()) >= 1


def test_spans_nest_with_parent_and_request_id():
    """A child names its parent's id; a span on another thread starts its
    own stack; each closes inside its parent.  A span carries no request
    id, as no caller of one serves a request among others: the engine's
    counters carry the request id (test_engine_streams_identical_...)."""
    seen = {}

    def worker():
        with tracing.span("other"):
            pass

    def body():
        with tracing.span("outer"):
            with tracing.span("inner"):
                th = threading.Thread(target=worker)
                th.start()
                th.join(timeout=30)
                seen["alive"] = th.is_alive()
            with tracing.span("second"):
                pass

    _traced(body)
    assert seen["alive"] is False
    by = {s.name: s for s in tracing.spans()}
    assert set(by) == {"outer", "inner", "other", "second"}
    outer = by["outer"]
    assert outer.parent is None and by["other"].parent is None
    assert by["inner"].parent == by["second"].parent == outer.id
    for name in ("inner", "second"):
        assert outer.start_ns <= by[name].start_ns <= by[name].end_ns \
            <= outer.end_ns
    assert by["inner"].end_ns <= by["second"].start_ns
    assert len({s.id for s in by.values()}) == 4


def test_counter_clock_is_monotonic_unix():
    """The counters' clock reads Unix ns (the spans' and the profiler's
    clock, to within the drift since import) and never steps back."""
    stamps = [tracing.counter_ns() for _ in range(1000)]
    assert all(a <= b for a, b in zip(stamps, stamps[1:]))
    assert abs(tracing.counter_ns() - time.time_ns()) < 50_000_000


def test_span_clock_encloses_the_profilers_events():
    """A span around torch.mm encloses the profiler's aten::mm event on
    the profiler's clock, and appears among its host events by name as a
    function range, not a user annotation (which kineto mirrors onto the
    GPU timeline)."""
    a = torch.randn(64, 64)

    def body():
        with tracing.span("t.mm"):
            torch.mm(a, a)

    _, prof = _traced(body)
    (sp,) = tracing.spans()
    events = list(prof.profiler.kineto_results.events())
    (mm,) = [e for e in events if e.name() == "aten::mm"]
    assert sp.start_ns <= mm.start_ns()
    assert mm.start_ns() + mm.duration_ns() <= sp.end_ns
    (own,) = [e for e in events if e.name() == "t.mm"]
    assert not own.is_user_annotation()
    assert own.device_type() == torch.autograd.DeviceType.CPU
    assert sp.start_ns <= own.start_ns()
    assert own.start_ns() + own.duration_ns() <= sp.end_ns


@pytest.mark.parametrize("steps_per_iter", [1, 3])
def test_tts_codes_identical_with_tracing_on_and_off(steps_per_iter):
    """inference_tts (sampled) gives the same codes traced and untraced;
    the traced decode records one prefill, one step span per forward and
    one sync per group of steps, none inside another."""
    model = _model()
    x, y = _requests(2)[1]
    kw = dict(seed=17, gen_max=40, steps_per_iter=steps_per_iter)
    st_off, st_on = {}, {}
    off = inference_tts(model, x, y, SAMPLED, stats=st_off, **kw)
    assert tracing.spans() == []
    on, _ = _traced(lambda: inference_tts(model, x, y, SAMPLED, stats=st_on,
                                          **kw))
    for a, b in zip(off, on):
        assert np.array_equal(a, b)
    assert st_on == st_off
    spans = tracing.spans()
    names = _names(spans)
    steps = [s for s in spans if s.name == "decode.step"]
    assert names.count("decode.prefill") == 1
    assert len(steps) == st_on["steps"]
    assert names.count("decode.sync") == -(-len(steps) // steps_per_iter)
    assert set(names) == {"decode.prefill", "decode.step", "decode.sync"}
    for s in spans:
        assert s.parent is None


def _serve(model, reqs, extra):
    """A pipelined streaming engine over 4 lanes with refills: each request
    streams; the first callback of request 0 submits ``extra`` from inside
    the engine's burst processing.  Returns (every on_rows payload in
    order, the results, the engine)."""
    eng = ContinuousBatcher(model, lanes=4, x_pad=32, y_pad=64, gen_max=48,
                            burst=8, scfg=SAMPLED, seed=5, pipeline=True)
    payloads = []

    def on_rows_of(i):
        def on_rows(rows):
            payloads.append((i, rows.copy()))
            if i == 0 and len(payloads) == 1:
                eng.submit(*extra, on_rows=on_rows_of(len(reqs)))
        return on_rows

    for i, (x, y) in enumerate(reqs):
        eng.submit(x, y, on_rows=on_rows_of(i))
    return payloads, eng.run(), eng


def test_engine_streams_identical_with_tracing_on_and_off():
    """Every on_rows payload and every result of the pipelined streaming
    engine, bit-identical traced and untraced; the counters mark each
    request's admission, first frame and retirement in that order, and
    count every refill and burst."""
    model = _model()
    reqs = _requests(7, text=3, step=1)
    extra = _requests(1, seed=99)[0]
    p_off, r_off, _ = _serve(model, reqs, extra)
    tracing.clear()
    (p_on, r_on, eng), _ = _traced(lambda: _serve(model, reqs, extra))
    assert len(p_off) == len(p_on) > len(reqs)
    for (i, a), (j, b) in zip(p_off, p_on):
        assert i == j and a.dtype == b.dtype and np.array_equal(a, b)
    assert set(r_off) == set(r_on) == set(range(len(reqs) + 1))
    for rid in r_off:
        for a, b in zip(r_off[rid], r_on[rid]):
            assert np.array_equal(a, b)
    assert tracing.spans() == []         # the engine keeps no spans
    marks = tracing.request_marks()
    assert {m.source for m in marks} == {eng._source}
    K = CFG.n_codebooks
    for rid in r_on:
        mine = [m for m in marks if m.rid == rid]
        assert [m.event for m in mine] == ["admit", "first_rows", "retire"]
        assert mine[0].t_ns <= mine[1].t_ns <= mine[2].t_ns
        rows = [p for i, p in p_on if i == rid]
        assert len(rows[-1]) >= K
    bursts = tracing.bursts()
    assert len(bursts) == eng.stats["bursts"]       # one a pass of the loop
    assert sum(b.refills for b in bursts) == eng.stats["refills"] > 0
    for b in bursts:
        assert min(b.admit_ns, b.wait_ns) >= 0
        assert b.admit_ns + b.wait_ns <= b.end_ns - b.start_ns


def _train(steps=2):
    """Two ScaledAdam steps of a trainable tiny model on synthetic batches:
    (losses, parameters after)."""
    model = _model(seed=8, trainable=True)
    opt = ScaledAdam(stacked_leaves(model), lr=0.02)
    step = make_train_step(model, opt)
    losses = []
    for i in range(steps):
        batch = synthetic_batch(CFG, B=2, Sx=8, y_len=24, seed=i,
                                device="cpu")
        losses.append(step(batch, 100 + i)["loss"].item())
    return losses, {n: p.detach().clone()
                    for n, p in model.named_parameters()}


def test_train_step_identical_with_tracing_on_and_off():
    """make_train_step's loss and updated parameters, bit-identical traced
    and untraced; each traced step records one train.update."""
    l_off, p_off = _train()
    assert tracing.spans() == []
    (l_on, p_on), _ = _traced(_train)
    assert l_off == l_on
    assert p_off.keys() == p_on.keys()
    for n in p_off:
        assert torch.equal(p_off[n], p_on[n]), n
    assert _names(tracing.spans()) == ["train.update"] * 2


def test_operator_trace_carries_the_spans(tmp_path):
    """The Chrome traces that StepProfiler (the trainer's --profile-dir)
    and device_trace write hold train.update among their events."""
    model = _model(seed=8, trainable=True)
    step = make_train_step(model, ScaledAdam(stacked_leaves(model), lr=0.02))
    prof = StepProfiler(str(tmp_path / "steps"), start=1, stop=2)
    for i in range(3):
        prof.step(i)
        step(synthetic_batch(CFG, B=2, Sx=8, y_len=24, seed=i, device="cpu"),
             i)
    prof.close()
    with device_trace(str(tmp_path / "region")):
        step(synthetic_batch(CFG, B=2, Sx=8, y_len=24, seed=5, device="cpu"),
             5)
    for d in ("steps", "region"):
        (trace,) = (tmp_path / d).glob("trace_*.json")
        events = json.loads(trace.read_text())["traceEvents"]
        updates = [e for e in events if e.get("name") == "train.update"]
        assert len(updates) == 1 and updates[0]["ph"] == "X"
    assert _names(tracing.spans()) == ["train.update"] * 2
