"""The single-stream decode loop's step (models/voicecraft.py:
make_decode_loop) on the CPU at tiny_test size in f32, where every step
runs eagerly: one function that updates the loop's state in place leaves
the outputs that the loop left before its step was that function (TTS
greedy and sampled, two- and three-span edits, steps_per_iter 3 and 4,
bench_mode), the result's logits are the last forward's heads, a CPU
decode records no ``decode.capture`` or ``decode.replay`` span, and the
fused FFN's launch counts move from a CUDA graph's capture to its replays
(ops/_native.py:GraphLaunches)."""

import collections
import dataclasses
import hashlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voicecraft_tpu_torch import config
from voicecraft_tpu_torch.data import spans
from voicecraft_tpu_torch.inference import tts
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops import _native, graphs
from voicecraft_tpu_torch.utils import tracing
from tests.test_torch_spec import one_torch_thread  # noqa: F401 (autouse)

CFG = dataclasses.replace(config.tiny_test(), compute_dtype="float32")
# added to codebook 0's eog logit: spans of these random weights then end
# by eog (as in test_torch_editing.py), so an edit crosses its transitions
EOG_BIAS = 0.05
GREEDY = vc.SamplingConfig(temperature=0.0, silence_tokens=())
SAMPLED = vc.SamplingConfig(top_k=10, top_p=0.9, temperature=1.0,
                            stop_repetition=3, silence_tokens=(5, 7))
EDIT2 = [(5, 12), (20, 25)]
EDIT3 = [(3, 7), (12, 16), (22, 26)]

# case: (make_decode_loop arguments, spans, seed, eog bias) and what the
# loop left before its step was one function: the first 16 hex digits of
# the sha256 of gen_buf and span_buf (int64), gen_cnt, spans_done,
# forwards and idle
CASES = {
    "tts-greedy-k1": (dict(scfg=GREEDY), None, 7, 0.0,
                      ["f75825c9658ffbec", 25, 1, 25, 0]),
    "tts-sampled-k1": (dict(scfg=SAMPLED), None, 7, 0.0,
                       ["12ca8b0b5dd8d2af", 48, 1, 48, 0]),
    "tts-sampled-k3": (dict(scfg=SAMPLED, steps_per_iter=3), None, 7, 0.0,
                       ["12ca8b0b5dd8d2af", 48, 1, 48, 0]),
    "tts-bench-k1": (dict(scfg=SAMPLED, bench_mode=True, gen_max=22), None,
                     7, 0.0, ["b4fbc8da143f465c", 22, 1, 22, 0]),
    "tts-bench-k3": (dict(scfg=SAMPLED, bench_mode=True, gen_max=22,
                          steps_per_iter=3), None, 7, 0.0,
                     ["b4fbc8da143f465c", 22, 1, 24, 2]),
    "edit2-sampled-k1": (dict(scfg=SAMPLED), EDIT2, 1, EOG_BIAS,
                         ["0a2f41355bd6a604", 44, 2, 46, 0]),
    "edit2-sampled-k3": (dict(scfg=SAMPLED, steps_per_iter=3), EDIT2, 1,
                         EOG_BIAS, ["157a5ed58cf5c713", 44, 2, 48, 2]),
    "edit3-greedy-k1": (dict(scfg=GREEDY, gen_max=37), EDIT3, 7, EOG_BIAS,
                        ["5e2e2f9926295d95", 37, 1, 37, 0]),
    "edit3-sampled-k4": (dict(scfg=SAMPLED, gen_max=37, steps_per_iter=4),
                         EDIT3, 5, EOG_BIAS,
                         ["32567b79174c9a76", 37, 3, 44, 3]),
}


@pytest.fixture(scope="module")
def setup():
    model = vc.VoiceCraft(CFG, "cpu").init_weights(
        torch.Generator().manual_seed(42)).eval()
    x = np.random.default_rng(0).integers(
        0, CFG.text_vocab_size, 12).astype(np.int32)
    y = np.random.default_rng(1).integers(
        0, CFG.audio_vocab_size, (CFG.n_codebooks, 30)).astype(np.int32)
    return model, x, y


@pytest.fixture(autouse=True)
def fresh_records():
    tracing.clear()
    yield
    tracing.clear()


def _decode(setup, kw, intervals, seed, bias):
    """The loop at x_pad 32, y_pad 64 (gen_max 48 unless ``kw`` says)."""
    model, x, y = setup
    if intervals is None:
        prefix, qids = spans.compose_tts_prefix(y, CFG), []
    else:
        prefix, qids = spans.compose_edit_prefix(y, intervals, CFG)
    xt, yt, mi, qm = tts.pad_inputs(CFG, x, prefix, 32, 64, "cpu", qids)
    loop = vc.make_decode_loop(CFG, is_tts=intervals is None, x_pad=32,
                               y_pad=64, **{"gen_max": 48, **kw})
    with torch.no_grad():
        model.heads.b2[0, CFG.eog] += bias
    try:
        return loop(model, xt, len(x), yt, prefix.length, mi, qm,
                    1 if intervals is None else len(intervals),
                    torch.Generator().manual_seed(seed))
    finally:
        with torch.no_grad():
            model.heads.b2[0, CFG.eog] -= bias


def _digest(res):
    h = hashlib.sha256()
    for buf in (res.gen_buf, res.span_buf):
        h.update(buf.numpy().astype(np.int64).tobytes())
    return [h.hexdigest()[:16], res.gen_cnt, res.spans_done, res.forwards,
            res.idle]


@pytest.mark.parametrize("case", list(CASES))
def test_the_step_leaves_what_the_loop_left(setup, case):
    kw, intervals, seed, bias, want = CASES[case]
    assert _digest(_decode(setup, kw, intervals, seed, bias)) == want


def test_the_result_holds_the_last_forwards_logits(setup, monkeypatch):
    heads = []
    apply_heads = vc.apply_heads

    def recording(*a, **kw):
        heads.append(apply_heads(*a, **kw).clone())
        return heads[-1]

    monkeypatch.setattr(vc, "apply_heads", recording)
    kw, intervals, seed, bias, _ = CASES["edit2-sampled-k3"]
    res = _decode(setup, kw, intervals, seed, bias)
    # the prefill's heads, then one per forward
    assert len(heads) == 1 + res.forwards
    assert res.logits.shape == (1, CFG.n_codebooks, CFG.card)
    assert torch.equal(res.logits, heads[-1])


@pytest.mark.parametrize("case", ["tts-sampled-k1", "edit2-sampled-k3"])
def test_a_cpu_decode_runs_every_step_eagerly(setup, case):
    """No graph on the CPU: every step is a decode.step, and nothing is
    captured or replayed."""
    model = setup[0]
    assert not graphs.step_graph_engages(model)
    kw, intervals, seed, bias, _ = CASES[case]
    with profile(activities=[ProfilerActivity.CPU]):
        res = _decode(setup, kw, intervals, seed, bias)
    names = collections.Counter(s.name for s in tracing.spans())
    assert names["decode.step"] == res.forwards
    assert names["decode.prefill"] == 1 and names["decode.sync"] >= 1
    assert names["decode.capture"] == names["decode.replay"] == 0


@pytest.fixture
def zero_launches():
    saved = _native.launch_counts()
    _native.reset_launch_counts()
    yield
    _native.reset_launch_counts()
    _native.add_launch_counts(saved)


def test_a_graphs_launches_are_counted_at_its_replays(zero_launches):
    _native.count_launch("flash_prefix_attention")    # before the capture
    with _native.GraphLaunches() as g:
        for _ in range(16):
            _native.count_launch("fused_ffn", "sm90/bf16")
    # the capture ran nothing
    assert _native.LAUNCHES == {"flash_prefix_attention": 1, "fused_ffn": 0,
                                "ring_decode_attention": 0,
                                "kda_recurrent": 0}
    assert sum(_native.ROUTE_LAUNCHES.values()) == 0
    assert g.per_replay == {"fused_ffn": 16, "fused_ffn:sm90/bf16": 16}
    for _ in range(3):
        g.replayed()
    assert _native.LAUNCHES == {"flash_prefix_attention": 1, "fused_ffn": 48,
                                "ring_decode_attention": 0,
                                "kda_recurrent": 0}
    assert _native.ROUTE_LAUNCHES == {"fused_ffn:sm90/bf16": 48}


def test_an_eager_step_then_replays_count_as_eager_steps(zero_launches):
    """A decode's eager first step, its capture and n - 1 replays leave
    the counts of n eager steps, on each route."""
    def step(route):
        for _ in range(4):
            _native.count_launch("fused_ffn", route)

    for route in ("sm90/bf16", "sm90/fp8"):
        step(route)
        with _native.GraphLaunches() as g:
            step(route)
        for _ in range(5):
            g.replayed()
    assert _native.LAUNCHES["fused_ffn"] == 2 * 6 * 4
    assert _native.ROUTE_LAUNCHES == {"fused_ffn:sm90/bf16": 24,
                                      "fused_ffn:sm90/fp8": 24}
    assert _native.launch_counts() == collections.Counter(
        {"fused_ffn": 48, "fused_ffn:sm90/bf16": 24, "fused_ffn:sm90/fp8": 24})
