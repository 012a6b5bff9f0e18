"""Kimi Linear's decoder block in the port (models/kimi_linear.py,
ops/kda.py, ops/moe.py's expert share) against the benchmark's plain
float32 reference (benchmark/reference/kimi_linear.py, loaded by path,
which imports nothing of the port), on the CPU at tiny_test_kimi's sizes
with seeded random weights (benchmark/architectures/kimi_linear.py's
``make_state``), all in f32: prefill and the single-stream decode loop,
the engine through a refill, the recurrence against its closed form, the
sigmoid router, the expert share against the uncut layer, and what the
block refuses.

Tolerances.  Port and reference are both f32 here and differ only in the
order of their sums (the recurrence's delta-rule order against the
reference's (I - beta k k^T) Diag(exp g) S product, the absorbed against
the unabsorbed latent attention): logits of magnitude ~10 agree to ~1e-6
at these widths.  LOGIT_TOL = 1e-5 is ten times that, and a KDA state
rounded to bf16 after every token (relative 2^-9 a value) moves the
logits past it (checked below, in the loop and in the engine).  The
recurrence's hand case and the router are held to 1e-6 (a few f32
roundings of values below 10); the expert share to 1e-5 (two shares'
sums against one, rows of magnitude ~1)."""

import dataclasses
import importlib.util
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from voicecraft_tpu_torch import config
from voicecraft_tpu_torch.data.spans import compose_tts_prefix
from voicecraft_tpu_torch.inference import engine as eng_mod
from voicecraft_tpu_torch.inference import tts
from voicecraft_tpu_torch.models import kimi_linear as kimi
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops import kda, moe
from voicecraft_tpu_torch.utils import tracing

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
LOGIT_TOL = 1e-5
GREEDY = vc.SamplingConfig(top_k=1, silence_tokens=())
EOS_BIAS = -10.0        # as the cell's traffic: requests run to their caps
ENGINE = dict(lanes=2, x_pad=24, y_pad=48, gen_max=40, burst=8)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ARCH = _load(BENCH / "architectures" / "kimi_linear.py", "t_kimi_arch")
REF = _load(BENCH / "reference" / "kimi_linear.py", "t_kimi_ref")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one thread each (see test_torch_spec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(config.tiny_test_kimi(), compute_dtype="float32")
    d = dataclasses.asdict(cfg)
    state = ARCH.make_state(d, 20260611, "cpu", torch.float32)
    state["heads.b2"][0, cfg.eos] += EOS_BIAS
    model = vc.VoiceCraft(cfg, "cpu")
    model.load_state_dict(state, strict=True)
    return cfg, model.eval(), REF.Reference(d, state, "cpu")


def _request(cfg, n_text, n_prompt, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.text_vocab_size, n_text),
            rng.integers(0, cfg.audio_vocab_size, (cfg.n_codebooks, n_prompt)))


def _ref_logits(ref, x, prompt, rows):
    """The reference's logits [n, K, card] predicting served rows [n, K]."""
    rows = torch.as_tensor(np.asarray(rows))
    prompt = torch.as_tensor(np.asarray(prompt))
    cols = ref.tts_columns(prompt, rows[:-1])
    return ref.logits(torch.as_tensor(np.asarray(x)), cols,
                      out_from=prompt.shape[1])


def _bf16_state(monkeypatch):
    """Round the KDA state to bf16 after every token of every recurrence."""
    inner = kda.kda_recurrent_plain

    def rounded(q, k, v, g, beta, state, lens):
        outs = []
        for t in range(q.shape[1]):
            one = slice(t, t + 1)
            outs.append(inner(q[:, one], k[:, one], v[:, one], g[:, one],
                              beta[:, one], state,
                              None if lens is None else lens - t))
            state.copy_(state.to(torch.bfloat16).float())
        return torch.cat(outs, 1)
    monkeypatch.setattr(kda, "kda_recurrent_plain", rounded)


# ---- prefill and the single-stream loop -------------------------------------------

def _loop_logits(model, x, prompt, gen_max, monkeypatch):
    """make_decode_loop's greedy rows and the logits each forward gave
    (the prefill's, then one a step)."""
    got = []
    heads = vc.apply_heads

    def recording(h_mod, h):
        out = heads(h_mod, h)
        got.append(out.clone())
        return out
    monkeypatch.setattr(vc, "apply_heads", recording)
    rows, _ = tts.run_decode(model, is_tts=True, x_tokens=x,
                             prefix=compose_tts_prefix(prompt, model.cfg),
                             n_spans=1, scfg=GREEDY, gen_max=gen_max,
                             return_raw=True)
    monkeypatch.setattr(vc, "apply_heads", heads)
    return rows, torch.cat(got)[:len(rows)]


def test_decode_loop_matches_reference(setup, monkeypatch):
    """Prefill (text padded: x_pad > x_len, the lane's real tokens packed),
    then every step of make_decode_loop through the hybrid cache, against
    the reference's full forward of the served sequence: every logit
    within LOGIT_TOL; with the KDA state rounded to bf16 the same
    comparison fails it."""
    cfg, model, ref = setup
    x, prompt = _request(cfg, 9, 21, 1)
    rows, logits = _loop_logits(model, x, prompt, 40, monkeypatch)
    assert len(rows) >= 30
    want = _ref_logits(ref, x, prompt, rows)
    assert float((logits - want).abs().max()) <= LOGIT_TOL

    _bf16_state(monkeypatch)
    rows_b, logits_b = _loop_logits(model, x, prompt, 40, monkeypatch)
    n = min(len(rows_b), len(rows))
    want_b = _ref_logits(ref, x, prompt, rows_b[:n])
    assert float((logits_b[:n] - want_b).abs().max()) > LOGIT_TOL


# ---- the engine -----------------------------------------------------------------------

def _engine_logits(model, reqs, monkeypatch, **kw):
    """Greedy engine results and, per request, the logits its lane's steps
    gave for rows 1.. ({request: {row: logits [K, card]}}), told apart by
    their (text, prompt) lengths."""
    steps = []
    step_fn, heads = eng_mod._lane_decode_step, eng_mod.apply_heads

    def lane_step(decoder, x_t, cache, x_lens, x_pad, prefix_lens, *a,
                  **kw):
        steps.append([x_lens.clone(), prefix_lens.clone(), a[-1].clone()])
        return step_fn(decoder, x_t, cache, x_lens, x_pad, prefix_lens, *a,
                       **kw)

    def lane_heads(h_mod, h):
        out = heads(h_mod, h)
        steps[-1].append(out.clone())
        return out
    monkeypatch.setattr(eng_mod, "_lane_decode_step", lane_step)
    monkeypatch.setattr(eng_mod, "apply_heads", lane_heads)
    eng = eng_mod.ContinuousBatcher(model, scfg=GREEDY, seed=0, **kw)
    ids = [eng.submit(x, y) for x, y in reqs]
    res = eng.run()
    monkeypatch.setattr(eng_mod, "_lane_decode_step", step_fn)
    monkeypatch.setattr(eng_mod, "apply_heads", heads)
    key = {(len(x), compose_tts_prefix(y, model.cfg).length): i
           for i, (x, y) in enumerate(reqs)}
    per = [dict() for _ in reqs]
    for xl, pl, t, logits in steps:
        for b in range(len(xl)):
            i = key.get((int(xl[b]), int(pl[b])))
            if i is not None:
                per[i].setdefault(int(t[b]) + 1, logits[b])
    return [res[i] for i in ids], per, eng


def gen_rows(cfg, gen):
    """The delayed-space rows of generated codes gen [K, Tg] up to the
    eog cascade's start (rows whose cells all come from the codes)."""
    K, Tg = gen.shape
    rows = np.full((Tg, K), cfg.empty_token, np.int64)
    for q in range(K):
        rows[q:, q] = gen[q, :Tg - q]
    return rows


def _engine_gaps(model, ref, reqs, monkeypatch):
    results, per, eng = _engine_logits(model, reqs, monkeypatch, **ENGINE)
    worst, compared = 0.0, 0
    for (x, y), (full, gen), logits in zip(reqs, results, per):
        rows = gen_rows(model.cfg, gen)
        want = _ref_logits(ref, x, y, rows)
        for r in range(1, len(rows)):
            worst = max(worst, float((logits[r] - want[r]).abs().max()))
            compared += 1
    return worst, compared, eng


def test_engine_serves_three_lanes_through_a_refill(setup, monkeypatch):
    """Three requests of different text and prompt lengths over two lanes
    (the third a mid-flight refill into a lane whose state the first left
    behind), greedy: every step's logits of every request against the
    reference's full forward of what it served (no text padding), within
    LOGIT_TOL; the cache holds its three parts; a KDA state rounded to
    bf16 fails the comparison."""
    cfg, model, ref = setup
    reqs = [_request(cfg, 7, 14, 2), _request(cfg, 12, 20, 3),
            _request(cfg, 5, 9, 4)]
    worst, compared, eng = _engine_gaps(model, ref, reqs, monkeypatch)
    assert eng.stats["refills"] >= 1
    c, dec = eng._cache, model.decoder
    s_max = 24 + 48 + 40 + 8
    assert c.slab.shape == (1, 2, s_max, dec.latent_dim)
    assert c.state.shape == (3, 2, 4, 16, 16)
    assert c.state.dtype == torch.float32
    assert c.conv.shape == (3, 2, 3, 3 * 4 * 16)
    assert compared > 60 and worst <= LOGIT_TOL
    _bf16_state(monkeypatch)
    worst_b, _, _ = _engine_gaps(model, ref, reqs, monkeypatch)
    assert worst_b > LOGIT_TOL


class _FakeGraph:
    """A stand-in for ops/graphs.py:StepGraph on the CPU (as
    tests/test_torch_engine.py's): the capture keeps the part, a replay
    runs it and writes what it returns into the first replay's tensors."""
    made = []

    def __init__(self, step, generators, device):
        self.step, self.out, self.replays = step, None, 0
        _FakeGraph.made.append(self)

    def replay(self):
        out = self.step()
        if self.replays == 0:
            self.out = out
        else:
            for a, b in zip(*((o,) if torch.is_tensor(o) else o
                              for o in (self.out, out))):
                a.copy_(b)
        self.replays += 1


def test_graphed_engine_replays_the_stack_part_by_part(setup, monkeypatch):
    """Where the engine's steps are graphed (step_graph_engages), Kimi
    Linear's stack runs part by part through deepseek_v2.StepGraphs: a
    KDA layer's inputs, recurrence and output, a latent layer's attention,
    a dense FFN or an expert layer's routing, products and combine, the
    final norm; each captured once for the batcher's life and replayed at
    every later step, the KDA and convolution states advanced in place by
    the replays, and the served rows equal an eager engine's."""
    from voicecraft_tpu_torch.ops import graphs
    import contextlib
    cfg, model, _ = setup
    reqs = [_request(cfg, 7, 14, 2), _request(cfg, 12, 20, 3),
            _request(cfg, 5, 9, 4)]

    def serve():
        eng = eng_mod.ContinuousBatcher(model, scfg=GREEDY, seed=0, **ENGINE)
        ids = [eng.submit(x, y) for x, y in reqs]
        res = eng.run()
        return [res[i] for i in ids], eng
    eager, _ = serve()
    _FakeGraph.made = []
    site = types.SimpleNamespace(running=contextlib.nullcontext)
    monkeypatch.setattr(graphs, "StepGraph", _FakeGraph)
    monkeypatch.setattr(graphs, "step_graph_engages", lambda model: True)
    monkeypatch.setattr(graphs, "CaptureSite",
                        types.SimpleNamespace(of=lambda device: site))
    graphed, eng = serve()
    dec, steps = model.decoder, eng.stats["steps"]
    n_dense = cfg.first_k_dense_replace
    parts = (3 * dec.n_kda_layers + dec.n_latent_layers + n_dense
             + 3 * dec.n_expert_layers + 1)
    assert len(_FakeGraph.made) == parts
    assert all(g.replays == steps - 1 for g in _FakeGraph.made)
    assert eng.stats["graph_steps"] == 0
    for (fa, ga), (fb, gb) in zip(eager, graphed):
        np.testing.assert_array_equal(ga, gb)
        np.testing.assert_array_equal(fa, fb)


# ---- the recurrence --------------------------------------------------------------------

def test_plain_recurrence_equals_the_closed_form_on_a_hand_case():
    """One head of dk = dv = 2, two tokens, from S = 0: S_1 = beta_1 k_1
    v_1^T; S_2 = (I - beta_2 k_2 k_2^T) Diag(exp g_2) S_1 + beta_2 k_2
    v_2^T; o_t = S_t^T q_t / sqrt(2).  A second lane of length 1 keeps S_1
    and reads 0 at its second token."""
    s = 1 / math.sqrt(2)
    q = torch.tensor([[[[1.0, 0.0]], [[s, s]]]]).repeat(2, 1, 1, 1)
    k = torch.tensor([[[[0.0, 1.0]], [[s, s]]]]).repeat(2, 1, 1, 1)
    v = torch.tensor([[[[2.0, -1.0]], [[0.5, 3.0]]]]).repeat(2, 1, 1, 1)
    g = torch.tensor([[[[0.0, 0.0]], [[-0.5, -1.0]]]]).repeat(2, 1, 1, 1)
    beta = torch.tensor([[[0.5], [0.25]]]).repeat(2, 1, 1)
    state = torch.zeros(2, 1, 2, 2)
    o = kda.kda_recurrent(q, k, v, g, beta, state, torch.tensor([2, 1]))
    S1 = 0.5 * torch.tensor([[0.0, 0.0], [2.0, -1.0]])
    k2, v2 = torch.tensor([s, s]), torch.tensor([0.5, 3.0])
    decayed = torch.diag(torch.exp(torch.tensor([-0.5, -1.0]))) @ S1
    S2 = ((torch.eye(2) - 0.25 * torch.outer(k2, k2)) @ decayed
          + 0.25 * torch.outer(k2, v2))
    tol = dict(rtol=0, atol=1e-6)
    torch.testing.assert_close(state[0, 0], S2, **tol)
    torch.testing.assert_close(state[1, 0], S1, **tol)
    torch.testing.assert_close(o[:, 0, 0], (S1.T @ q[0, 0, 0] * s).expand(2, 2),
                               **tol)
    torch.testing.assert_close(o[0, 1, 0], S2.T @ q[0, 1, 0] * s, **tol)
    assert torch.equal(o[1, 1], torch.zeros(1, 2))


# ---- the router and the expert share ----------------------------------------------------

def test_route_is_sigmoid_biased_renormalised_scaled():
    """The sigmoid scores in f32; the top k of score + bias, which the bias
    alone can reorder; weights the chosen scores over their sum, times the
    scale.  DeepSeek-V2's softmax routing is the default, unchanged."""
    g = torch.Generator().manual_seed(7)
    x, w = torch.randn(5, 16, generator=g), torch.randn(16, 12, generator=g)
    s = torch.sigmoid(x @ w)
    bias = torch.zeros(12)
    bias[3] = 2.0                      # expert 3 chosen for every row
    weights, experts = moe.route(x, w, 4, "sigmoid", bias, True, 2.446)
    assert (experts == 3).any(-1).all()
    assert torch.equal(experts, (s + bias).argsort(-1, descending=True)[:, :4])
    chosen = s.gather(1, experts)
    torch.testing.assert_close(weights, 2.446 * chosen / chosen.sum(-1,
                                                                keepdim=True),
                               rtol=0, atol=1e-6)
    p, e = moe.route(x, w, 4)
    assert torch.equal(e, torch.softmax(x @ w, -1).topk(4)[1])


def _routed_part(x, router, bias, w1, w2, n_held, cfg):
    """One share's routed experts (ops/moe.py) of rows x: the held experts'
    part of the layer, without the shared expert."""
    k = cfg.num_experts_per_tok
    weights, experts = moe.route(x, router, k, "sigmoid", bias, True,
                                 cfg.routed_scaling_factor)
    order, _, offs = moe.group_by_expert(experts, n_held)
    y = moe.expert_products(x.index_select(0, order // k), offs, w1, w2)
    return moe.combine(y, order, weights, offs[-1:])


def test_expert_share_parts_add_up_to_the_uncut_layer():
    """A 16-expert layer cut into 2 shares of 8 (the second holds experts
    8-15: its router's columns rolled so that they come first, which routes
    the same): the two routed parts plus the shared expert, counted once,
    equal the reference's whole layer (all 16 held).  The rows past the
    last held group hold NaN here and change nothing."""
    cfg = config.tiny_test_kimi()
    d = dict(dataclasses.asdict(cfg), n_routed_experts=16)
    g = torch.Generator().manual_seed(8)
    D, Ie, E = cfg.d_model, cfg.moe_intermediate_size, 16
    st = {"decoder.layers.1.router": torch.randn(D, E, generator=g) * 0.3,
          "decoder.layers.1.router_bias": torch.rand(E, generator=g) * 0.02,
          "decoder.layers.1.experts_w1": torch.randn(E, D, 2 * Ie,
                                                     generator=g) * 0.2,
          "decoder.layers.1.experts_w2": torch.randn(E, Ie, D,
                                                     generator=g) * 0.2,
          "decoder.layers.1.shared_w1": torch.randn(D, 2 * Ie,
                                                    generator=g) * 0.2,
          "decoder.layers.1.shared_w2": torch.randn(Ie, D, generator=g) * 0.2}
    x = torch.randn(13, D, generator=g)
    ref = REF.Reference.__new__(REF.Reference)
    ref.cfg, ref.weights, ref.state = d, "exact", st
    want = ref._ffn("decoder.layers.1.", 1, x)
    p = lambda n: st["decoder.layers.1." + n]
    real = moe.grouped_mm
    nan_tail = lambda a, w, offs: real(a, w, offs).index_fill_(
        0, torch.arange(int(offs[-1]), a.shape[0]), float("nan"))
    moe.grouped_mm = nan_tail
    try:
        first = _routed_part(x, p("router"), p("router_bias"),
                             p("experts_w1")[:8], p("experts_w2")[:8], 8, cfg)
        second = _routed_part(x, p("router").roll(-8, 1),
                              p("router_bias").roll(-8, 0),
                              p("experts_w1")[8:], p("experts_w2")[8:], 8,
                              cfg)
    finally:
        moe.grouped_mm = real
    shared = REF.swiglu(x, p("shared_w1"), p("shared_w2"))
    torch.testing.assert_close(first + second + shared, want, rtol=0,
                               atol=1e-5)
    assert first.isfinite().all() and second.isfinite().all()


# ---- the cache, the spans and the records -------------------------------------------------

def test_the_hybrid_cache_and_its_lane_writes(setup):
    cfg, model, _ = setup
    c = vc.new_kv_cache(model, 3, 50)
    assert isinstance(c, kimi.HybridCache) and vc.cache_slots(cfg, c) == 50
    assert c.slab.shape == (1, 3, 50, 40) and c.state.shape == (3, 3, 4, 16, 16)
    new = vc.new_kv_cache(model, 2, 20)
    for t in (new.slab, new.state, new.conv):
        t.fill_(1.0)
    vc.store_lanes(cfg, c, torch.tensor([2, 0]), new)
    assert c.slab[:, [0, 2], :20].eq(1).all() and c.slab[:, :, 20:].eq(0).all()
    assert c.slab[:, 1].eq(0).all() and c.state[:, 1].eq(0).all()
    assert c.state[:, [0, 2]].eq(1).all() and c.conv[:, [0, 2]].eq(1).all()
    with pytest.raises(ValueError, match="kimi_linear"):
        vc.new_kv_cache(model, 2, 20, kv_dtype="float8_e4m3fn")


def test_spans_and_records_while_a_profiler_records(setup):
    cfg, model, _ = setup
    dec = model.decoder
    tracing.clear()
    cache = vc.new_kv_cache(model, 3, 8)
    x_t = torch.randn(3, 1, cfg.d_model)
    step = lambda: kimi.decode_step(dec, x_t, cache, torch.tensor(2))
    step()
    assert tracing.expert_rows() is None and not tracing.spans()
    assert not tracing.kda_calls()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step()
        step()
    rows = tracing.expert_rows()
    assert rows.shape == (2, dec.n_expert_layers, cfg.n_routed_experts)
    assert (rows.sum(-1) <= 3 * cfg.num_experts_per_tok).all()
    names = [s.name for s in tracing.spans()]
    assert names.count("kda.attend") == 2 * dec.n_kda_layers
    assert names.count("kda.recur") == 2 * dec.n_kda_layers
    assert names.count("mla.attend") == 2 * dec.n_latent_layers
    assert names.count("moe.layer") == 2 * dec.n_expert_layers
    assert tracing.kda_calls() == [3] * (2 * dec.n_kda_layers)
    tracing.clear()


# ---- what the block refuses ----------------------------------------------------------------

def test_refusals_name_the_block(setup):
    cfg, model, _ = setup
    x, y = _request(cfg, 6, 12, 7)
    from voicecraft_tpu_torch.inference.serving import serve_tts_batch
    from voicecraft_tpu_torch.parallel.mesh import shard_params
    from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
    rest = {k: v for k, v in ENGINE.items() if k != "lanes"}
    calls = [
        lambda: quantize_decoder_fp8(model),
        lambda: tts.inference_tts(model, x, y, GREEDY, gen_max=8,
                                  fused_ffn=True),
        lambda: tts.inference_tts_spec(model, x, y, GREEDY, n_draft=3,
                                       gen_max=8),
        lambda: eng_mod.ContinuousBatcher(model, lanes=2, spec=3, **rest),
        lambda: shard_params(model, types.SimpleNamespace(n_model=2)),
        lambda: vc.forward_train(model, None),
        lambda: vc.VoiceCraft(cfg, "cpu", trainable=True),
        lambda: tts.inference_tts_batch(model, x, y, GREEDY, batch_size=2,
                                        gen_max=8),
        lambda: serve_tts_batch(model, [(x, y)], GREEDY),
        lambda: eng_mod.ContinuousBatcher(model, lanes=2,
                                          kv_dtype="float8_e4m3fn", **rest),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="kimi_linear"):
            call()


@pytest.mark.parametrize("field,value", [
    ("q_lora_rank", 64), ("n_group", 4), ("n_mtp", 3),
    ("mla_use_nope", False), ("scoring_func", "softmax")])
def test_config_refuses_what_is_not_implemented(field, value):
    with pytest.raises(ValueError, match=field):
        dataclasses.replace(config.tiny_test_kimi(), **{field: value})


@pytest.mark.parametrize("field,value", [
    ("kda_layers", (1, 2, 3, 4)), ("kda_layers", (3, 1)),
    ("router_experts", 4), ("num_experts_per_tok", 17)])
def test_config_refuses_an_inconsistent_stack(field, value):
    with pytest.raises(ValueError, match="kimi_linear"):
        dataclasses.replace(config.tiny_test_kimi(), **{field: value})


def test_deepseek_v2_refuses_kimi_linear_fields():
    for field, value in (("kda_layers", (1,)), ("mla_use_nope", True),
                         ("router_experts", 16), ("router_bias", True)):
        with pytest.raises(ValueError, match="deepseek_v2"):
            dataclasses.replace(config.tiny_test_dsv2(), **{field: value})


def test_published_preset_and_sizes():
    """kimi_linear_48b_a3b: 27 layers in the published KDA / latent order
    (latent attention at layers 4, 8, ..., 24 and 27), 32 KDA heads of 128
    with a short convolution of 4, NoPE latent attention 512 / 128 / 64 /
    128, 64 held experts of a 256-wide router with its bias, 1 shared; the
    held decoder's matrices are the architecture module's count."""
    cfg = config.kimi_linear_48b_a3b()
    model = vc.VoiceCraft(cfg, "meta")
    dec = model.decoder
    latent = [li + 1 for li, k in enumerate(dec.is_kda) if not k]
    assert len(dec.layers) == 27 and latent == [4, 8, 12, 16, 20, 24, 27]
    assert dec.layers[0].dense and isinstance(dec.layers[0], kimi.KDALayer)
    assert not any(layer.dense for layer in dec.layers[1:])
    kd, ml = dec.layers[1], dec.layers[3]
    assert kd.w_qkv.shape == (2304, 3 * 4096) and kd.conv_w.shape == (12288, 4)
    assert kd.A_log.shape == (32,) and kd.o_norm_g.shape == (128,)
    assert ml.wq.shape == (2304, 32 * 192) and ml.wkv_b.shape == (512, 32 * 256)
    assert dec.latent_dim == 576 and dec.cfg.mla_use_nope
    assert dec.scale == pytest.approx(192 ** -0.5)
    assert ml.router.shape == (2304, 256) and ml.router_bias.shape == (256,)
    assert ml.experts_w1.shape == (64, 2304, 2048)
    assert ml.shared_w1.shape == (2304, 2048)
    n = sum(p.numel() for n_, p in dec.named_parameters()
            if n_.rsplit(".", 1)[-1] not in (
                "dt_bias", "A_log", "b_gb", "router_bias")
            and not n_.endswith("_g"))
    assert n == ARCH.decoder_params(dataclasses.asdict(cfg)) == 13_034_668_032
