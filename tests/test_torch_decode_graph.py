"""On a CUDA card: make_decode_loop replays its decode step from a CUDA
graph (ops/graphs.py:StepReplay) and leaves what a decode whose
every step runs eagerly leaves, bit for bit: the recorded samples and
span indices, the counts, the last forward's logits and the fused FFN's
launch counts.  giga830M widths at 2 layers and one tts830e.single
geometry (a 5 s prompt, 137 phones, 128 samples): one-span TTS and a
two-span edit, greedy (top-k 1 through the sampler, and argmax) and
top-k 40, steps_per_iter 1 and 3, bench_mode, the request's generator and
the default one.  Run on a card with
``python -m pytest tests/test_torch_decode_graph.py -q``; it skips
elsewhere."""

import numpy as np
import pytest
import torch

from voicecraft_tpu_torch.data import spans
from voicecraft_tpu_torch.inference import tts
from voicecraft_tpu_torch.inference.loader import load_model
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops import _native, graphs

LAYERS = 2
PROMPT_FRAMES, PHONES, GEN = 250, 137, 128       # tts830e.single's middle
EDIT_SPANS = [(60, 90), (150, 170)]
# tts830e.single's sampling (benchmark/traffic/tts_closed.json)
TOPK40 = vc.SamplingConfig(top_k=40, top_p=1.0, temperature=1.0,
                           stop_repetition=3, silence_tokens=(1388, 1898, 131))
TOPK1 = vc.SamplingConfig(top_k=1, top_p=1.0, temperature=1.0,
                          stop_repetition=3, silence_tokens=(1388, 1898, 131))
ARGMAX = vc.SamplingConfig(temperature=0.0, silence_tokens=())
SEED = 2718281828

# name: (task, sampling, steps_per_iter, bench_mode, fused FFN, generator)
CASES = {
    "tts-topk1-k1": ("tts", TOPK1, 1, False, True, "request"),
    "tts-argmax-k1": ("tts", ARGMAX, 1, False, True, "request"),
    "tts-topk40-k1": ("tts", TOPK40, 1, False, True, "request"),
    "tts-topk40-k3": ("tts", TOPK40, 3, False, True, "request"),
    "tts-topk40-default-generator": ("tts", TOPK40, 1, False, True,
                                     "default"),
    "tts-bench-k1": ("tts", TOPK40, 1, True, True, "request"),
    "tts-bench-k3": ("tts", TOPK40, 3, True, True, "request"),
    "edit2-topk1-k1": ("edit", TOPK1, 1, False, False, "request"),
    "edit2-topk40-k1": ("edit", TOPK40, 1, False, True, "request"),
    "edit2-topk40-k3": ("edit", TOPK40, 3, False, True, "request"),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured in a CUDA graph")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def models(card):
    """The TTS model (TTSEnhanced's token layout, codebook 0's eos bias
    lowered by 10 as the cell lowers it, so no request stops early) and the
    editing model, both at giga830M widths and LAYERS layers."""
    out = {}
    for task, preset in (("tts", "giga830M_TTSEnhanced"),
                         ("edit", "giga830M")):
        cfg, model, _ = load_model(preset, random_init=True, seed=5,
                                   device=card,
                                   overrides=dict(num_decoder_layers=LAYERS))
        if task == "tts":
            with torch.no_grad():
                model.heads.b2[0, cfg.eos] -= 10.0
        out[task] = model
    return out


def _inputs(model, task):
    """(loop arguments, call arguments): a 5 s prompt of random codes; an
    edit's text is short enough that the length cap (10 frames a phone)
    ends its first span ~20 samples in, and the second at its first."""
    cfg = model.cfg
    rng = np.random.default_rng(11)
    y = rng.integers(0, cfg.audio_vocab_size,
                     (cfg.n_codebooks, PROMPT_FRAMES)).astype(np.int32)
    if task == "tts":
        prefix, qids, n_spans = spans.compose_tts_prefix(y, cfg), [], 1
        x_len = PHONES
    else:
        prefix, qids = spans.compose_edit_prefix(y, EDIT_SPANS, cfg)
        n_spans = len(EDIT_SPANS)
        x_len = (prefix.length + 20) // 10
    x = rng.integers(0, cfg.text_vocab_size, x_len).astype(np.int32)
    x_pad, y_pad, gen_max = tts.decode_geometry(
        cfg, x_len, prefix.length, is_tts=task == "tts", n_spans=n_spans,
        gen_max=GEN)
    xt, yt, mi, qm = tts.pad_inputs(cfg, x, prefix, x_pad, y_pad,
                                    model.device, qids)
    return (dict(is_tts=task == "tts", x_pad=x_pad, y_pad=y_pad,
                 gen_max=gen_max),
            (xt, x_len, yt, prefix.length, mi, qm, n_spans))


def _decode(model, case):
    """One decode of ``case``: (result, fused FFN launches, replays)."""
    task, scfg, k, bench, fused, gen = CASES[case]
    loop_kw, args = _inputs(model, task)
    loop = vc.make_decode_loop(model.cfg, scfg=scfg, steps_per_iter=k,
                               bench_mode=bench, fused_ffn=fused, **loop_kw)
    if gen == "request":
        generator = torch.Generator(device=model.device).manual_seed(SEED)
    else:
        torch.cuda.manual_seed(SEED)
        generator = None
    replays = [0]
    replay = graphs.StepGraph.replay

    def counted(self):
        replays[0] += 1
        replay(self)

    _native.reset_launch_counts()
    graphs.StepGraph.replay = counted
    try:
        res = loop(model, *args, generator)
        torch.cuda.synchronize()
    finally:
        graphs.StepGraph.replay = replay
    return res, dict(_native.ROUTE_LAUNCHES), replays[0]


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_replayed_steps_equal_eager_steps(models, case, monkeypatch):
    task, *_, fused, _ = CASES[case]
    model = models[task]
    graphed, g_launches, g_replays = _decode(model, case)
    monkeypatch.setattr(graphs, "step_graph_engages", lambda model: False)
    eager, e_launches, e_replays = _decode(model, case)
    print(f"{case}: {graphed.forwards} forwards ({g_replays} replayed), "
          f"{graphed.gen_cnt} samples, {graphed.spans_done} spans, "
          f"{graphed.idle} idle; launches {g_launches}")
    assert g_replays == graphed.forwards - 1 and e_replays == 0
    assert graphed.forwards > 16
    assert ((graphed.gen_cnt, graphed.spans_done, graphed.forwards,
             graphed.idle)
            == (eager.gen_cnt, eager.spans_done, eager.forwards, eager.idle))
    assert torch.equal(graphed.gen_buf, eager.gen_buf)
    assert torch.equal(graphed.span_buf, eager.span_buf)
    assert torch.equal(graphed.logits, eager.logits)
    # the launch counts of an eager decode: one FFN launch a layer a forward
    want = ({"fused_ffn:sm90/bf16": LAYERS * eager.forwards} if fused
            else {})
    assert g_launches == e_launches == want
    if task == "edit":
        assert graphed.spans_done == len(EDIT_SPANS)
        assert graphed.forwards - graphed.idle > graphed.gen_cnt  # feeds
