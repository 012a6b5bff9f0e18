"""DeepSeek-V2's decoder block in the port (models/deepseek_v2.py,
ops/moe.py) against the benchmark's plain float32 reference
(benchmark/reference/deepseek_v2.py, loaded by path, which imports nothing
of the port), on the CPU at tiny_test_dsv2's sizes with seeded random
weights (benchmark/architectures/deepseek_v2.py's ``make_state``), all in
f32: prefill and the single-stream decode loop, the engine through a
refill, the absorbed against the unabsorbed attention, the grouped experts
against a loop, the YaRN tables, and what the block refuses.

Tolerances.  Port and reference are both f32 here and differ only in the
order of their sums (and the absorbed decode's other association of
W_kvb): logits of magnitude ~10 agree to ~1e-6 at these widths.
LOGIT_TOL = 1e-5 is ten times that, and a latent slab rounded to bf16
(relative 2^-9 a value) moves the logits by ~9e-5, past it (checked
below, in the loop and in the engine)."""

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
from voicecraft_tpu_torch.models import deepseek_v2 as dsv2
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops import moe
from voicecraft_tpu_torch.utils import tracing

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
LOGIT_TOL = 1e-5
GREEDY = vc.SamplingConfig(top_k=1, silence_tokens=())
EOS_BIAS = -10.0        # as the cell's traffic: requests run to their caps


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ARCH = _load(BENCH / "architectures" / "deepseek_v2.py", "t_dsv2_arch")
REF = _load(BENCH / "reference" / "deepseek_v2.py", "t_dsv2_ref")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one thread each (see test_torch_spec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(config.tiny_test_dsv2(), compute_dtype="float32")
    d = dataclasses.asdict(cfg)
    state = ARCH.make_state(d, 20260521, "cpu", torch.float32)
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


def _bf16_slab(monkeypatch):
    """Round the latent slab to bf16 before every decode step reads it."""
    inner = dsv2._decode_stack

    def rounded(dec, x_t, cache, pos, attend):
        cache.copy_(cache.to(torch.bfloat16).to(cache.dtype))
        return inner(dec, x_t, cache, pos, attend)
    monkeypatch.setattr(dsv2, "_decode_stack", rounded)


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
    """Prefill, then every step of make_decode_loop through the latent slab
    (text padded: x_pad > x_len), against the reference's full forward of
    the served sequence: every logit within LOGIT_TOL; with the slab
    rounded to bf16 the same comparison fails it."""
    cfg, model, ref = setup
    x, prompt = _request(cfg, 9, 21, 1)
    rows, logits = _loop_logits(model, x, prompt, 40, monkeypatch)
    assert len(rows) >= 30
    want = _ref_logits(ref, x, prompt, rows)
    assert float((logits - want).abs().max()) <= LOGIT_TOL

    _bf16_slab(monkeypatch)
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


ENGINE = dict(lanes=2, x_pad=24, y_pad=48, gen_max=40, burst=8)


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


def gen_rows(cfg, gen):
    """The delayed-space rows of generated codes gen [K, Tg] up to the
    eog cascade's start (rows whose cells all come from the codes)."""
    K, Tg = gen.shape
    rows = np.full((Tg, K), cfg.empty_token, np.int64)
    for q in range(K):
        rows[q:, q] = gen[q, :Tg - q]
    return rows


def test_engine_serves_three_lanes_through_a_refill(setup, monkeypatch):
    """Three requests of different text and prompt lengths over two lanes
    (the third is a mid-flight refill), greedy: every step's
    logits of every request against the reference's full forward of what
    it served, within LOGIT_TOL; the slab is the latent one; a bf16 slab
    fails the comparison."""
    cfg, model, ref = setup
    reqs = [_request(cfg, 7, 14, 2), _request(cfg, 12, 20, 3),
            _request(cfg, 5, 9, 4)]
    worst, compared, eng = _engine_gaps(model, ref, reqs, monkeypatch)
    assert eng.stats["refills"] >= 1
    assert eng._cache.shape == (cfg.num_decoder_layers, 2,
                                24 + 48 + 40 + 8, model.decoder.latent_dim)
    assert compared > 60 and worst <= LOGIT_TOL
    _bf16_slab(monkeypatch)
    worst_b, _, _ = _engine_gaps(model, ref, reqs, monkeypatch)
    assert worst_b > LOGIT_TOL


# ---- absorbed against unabsorbed --------------------------------------------------------

def test_absorbed_step_equals_unabsorbed_prefill(setup):
    """A decode step (W_kvb absorbed: the query over the latent, (p.c)
    W_UV) after a prefill of S positions gives the hidden of the prefill
    of S + 1 positions (keys and values made from c), to f32 rounding."""
    cfg, model, _ = setup
    dec = model.decoder
    torch.manual_seed(0)
    S, x_pad = 17, 6
    x = torch.randn(2, S + 1, cfg.d_model)
    x_lens = torch.tensor([4, 6])
    prefix = torch.tensor([S - x_pad + 1, S - x_pad + 1])
    full, _ = dsv2.prefill(dec, x, x_lens, prefix, x_pad,
                           dsv2.init_latent_cache(cfg.num_decoder_layers, 2,
                                                  S + 1, dec.latent_dim,
                                                  torch.float32, "cpu"))
    cache = dsv2.init_latent_cache(cfg.num_decoder_layers, 2, S + 4,
                                   dec.latent_dim, torch.float32, "cpu")
    _, cache = dsv2.prefill(dec, x[:, :S], x_lens, prefix - 1, x_pad, cache)
    valid = torch.arange(S + 4)[None, :]
    valid = ((valid < x_lens[:, None]) | ((valid >= x_pad) & (valid < S)))
    h, new = dsv2._decode_stack(
        dec, x[:, S:], cache, x_lens + S - x_pad,
        lambda q, ks, vs, kn, vn: dsv2._attend_one(
            q, ks, vs, valid[:, None, None], kn, vn, dec.scale))
    torch.testing.assert_close(h[:, 0], full[:, S], rtol=0, atol=1e-5)
    assert new.shape == (cfg.num_decoder_layers, 2, 1, dec.latent_dim)


# ---- the experts ------------------------------------------------------------------------

def _looped(x, weights, experts, w1, w2):
    """The routed sum row by row and expert by expert."""
    out = torch.zeros(x.shape, dtype=torch.float32)
    for t in range(x.shape[0]):
        for j in range(experts.shape[1]):
            e = int(experts[t, j])
            h = moe.swiglu_hidden(x[t:t + 1] @ w1[e])
            out[t] += float(weights[t, j]) * (h @ w2[e])[0].float()
    return out


def test_grouped_experts_equal_a_loop():
    """The rows ordered by expert, the grouped products over them and the
    combine, against a row-by-row loop, and the rows per expert; expert 3
    gets no row.  The same inputs give the same bits again."""
    g = torch.Generator().manual_seed(5)
    T, D, I, E, k = 11, 16, 8, 6, 2
    x = torch.randn(T, D, generator=g)
    w1 = torch.randn(E, D, 2 * I, generator=g) * 0.3
    w2 = torch.randn(E, I, D, generator=g) * 0.3
    experts = torch.randint(0, E - 1, (T, k), generator=g)
    experts = torch.where(experts >= 3, experts + 1, experts)
    experts[:, 1] = torch.where(experts[:, 1] == experts[:, 0],
                                (experts[:, 0] + 1) % E, experts[:, 1])
    experts = torch.where(experts == 3, 4, experts)
    weights = torch.rand(T, k, generator=g)

    def grouped():
        order, counts, offs = moe.group_by_expert(experts, E)
        y = moe.expert_products(x.index_select(0, order // k), offs, w1, w2)
        return moe.combine(y, order, weights), counts
    got, counts = grouped()
    torch.testing.assert_close(got, _looped(x, weights, experts, w1, w2),
                               rtol=1e-5, atol=1e-5)
    assert counts.tolist() == torch.bincount(experts.reshape(-1),
                                             minlength=E).tolist()
    assert counts[3] == 0
    assert torch.equal(got, grouped()[0])


def test_route_is_the_f32_softmax_top_k():
    g = torch.Generator().manual_seed(6)
    x, w = torch.randn(5, 16, generator=g), torch.randn(16, 8, generator=g)
    weights, experts = moe.route(x, w, 3)
    p = torch.softmax(x @ w, -1)
    assert torch.equal(experts, p.argsort(-1, descending=True)[:, :3])
    torch.testing.assert_close(weights, p.gather(1, experts))
    assert (weights.sum(-1) < 1).all()          # not renormalised


# ---- YaRN -----------------------------------------------------------------------------

def test_yarn_tables_and_scale_match_the_closed_form():
    cfg = config.deepseek_v2_lite()
    theta, dr = 10000.0, 64
    for beta, want in ((32.0, 10), (1.0, 23)):
        at = dr * math.log(4096 / (beta * 2 * math.pi)) / (2 * math.log(theta))
        assert (math.floor(at) if beta == 32.0 else math.ceil(at)) == want
    i = np.arange(32)
    extra = theta ** (-2 * i / dr)
    r = np.clip((i - 10) / 13, 0, 1)
    want = extra / 40 * r + extra * (1 - r)
    np.testing.assert_allclose(dsv2.yarn_frequencies(cfg), want, rtol=1e-12)
    np.testing.assert_allclose(REF.rope_frequencies(dataclasses.asdict(cfg)),
                               want, rtol=1e-12)
    scale = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
    assert dsv2.softmax_scale(cfg) == pytest.approx(scale, rel=1e-12)
    assert scale == pytest.approx(0.11472, abs=1e-5)
    cos, sin = dsv2.rope_tables(cfg, 300)
    np.testing.assert_allclose(cos[299].numpy(), np.cos(299 * want), atol=1e-6)
    np.testing.assert_allclose(sin[7].numpy(), np.sin(7 * want), atol=1e-6)


# ---- the slab, the spans and the record ----------------------------------------------------

def test_one_slab_constructor_for_both_blocks(setup):
    cfg, model, _ = setup
    c = vc.new_kv_cache(model, 3, 50)
    assert c.shape == (3, 3, 50, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    vc_cfg = dataclasses.replace(config.tiny_test(), compute_dtype="float32")
    c = vc.new_kv_cache(vc.VoiceCraft(vc_cfg, "cpu"), 3, 50)
    assert c.shape == (2, 2, 3, 50, vc_cfg.nhead, vc_cfg.head_dim)


def test_spans_and_expert_rows_while_a_profiler_records(setup):
    cfg, model, _ = setup
    dec = model.decoder
    tracing.clear()
    cache = dsv2.init_latent_cache(cfg.num_decoder_layers, 3, 8,
                                   dec.latent_dim, torch.float32, "cpu")
    x_t = torch.randn(3, 1, cfg.d_model)
    step = lambda: dsv2.decode_step(dec, x_t, cache, torch.tensor(2),
                                    torch.tensor([2, 2, 2]))
    step()
    assert tracing.expert_rows() is None and not tracing.spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step()
        step()
    rows = tracing.expert_rows()
    assert rows.shape == (2, dec.n_expert_layers, cfg.n_routed_experts)
    assert (rows.sum(-1) == 3 * cfg.num_experts_per_tok).all()
    names = [s.name for s in tracing.spans()]
    assert names.count("mla.attend") == 2 * cfg.num_decoder_layers
    assert names.count("moe.layer") == 2 * dec.n_expert_layers
    assert names.count("moe.experts") == 2 * dec.n_expert_layers
    tracing.clear()


# ---- what the block refuses ----------------------------------------------------------------

def test_refusals_name_the_block(setup):
    cfg, model, _ = setup
    x, y = _request(cfg, 6, 12, 7)
    from voicecraft_tpu_torch.inference.serving import serve_tts_batch
    from voicecraft_tpu_torch.parallel.mesh import shard_params
    from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
    with pytest.raises(ValueError, match="deepseek_v2"):
        quantize_decoder_fp8(model)
    with pytest.raises(ValueError, match="deepseek_v2"):
        tts.inference_tts(model, x, y, GREEDY, gen_max=8, fused_ffn=True)
    with pytest.raises(ValueError, match="deepseek_v2"):
        tts.inference_tts_spec(model, x, y, GREEDY, n_draft=3, gen_max=8)
    with pytest.raises(ValueError, match="deepseek_v2"):
        eng_mod.ContinuousBatcher(model, lanes=2, spec=3, **{
            k: v for k, v in ENGINE.items() if k != "lanes"})
    with pytest.raises(ValueError, match="deepseek_v2"):
        shard_params(model, types.SimpleNamespace(n_model=2))
    with pytest.raises(ValueError, match="deepseek_v2"):
        vc.forward_train(model, None)
    with pytest.raises(ValueError, match="deepseek_v2"):
        vc.VoiceCraft(cfg, "cpu", trainable=True)
    with pytest.raises(ValueError, match="deepseek_v2"):
        tts.inference_tts_batch(model, x, y, GREEDY, batch_size=2, gen_max=8)
    with pytest.raises(ValueError, match="deepseek_v2"):
        serve_tts_batch(model, [(x, y)], GREEDY)
    with pytest.raises(ValueError, match="deepseek_v2"):
        eng_mod.ContinuousBatcher(model, lanes=2, kv_dtype="float8_e4m3fn",
                                  **{k: v for k, v in ENGINE.items()
                                     if k != "lanes"})


@pytest.mark.parametrize("field,value", [
    ("q_lora_rank", 64), ("scoring_func", "sigmoid"),
    ("topk_method", "group_limited_greedy"), ("n_group", 4),
    ("moe_layer_freq", 2), ("norm_topk_prob", True),
    ("routed_scaling_factor", 16.0), ("n_mtp", 3)])
def test_config_refuses_what_is_not_implemented(field, value):
    with pytest.raises(ValueError, match=field):
        dataclasses.replace(config.tiny_test_dsv2(), **{field: value})


def test_published_preset_and_sizes():
    cfg = config.deepseek_v2_lite()
    model = vc.VoiceCraft(cfg, "meta")
    dec = model.decoder
    assert len(dec.layers) == 27 and dec.layers[0].dense
    assert not any(layer.dense for layer in dec.layers[1:])
    assert dec.layers[1].experts_w1.shape == (64, 2048, 2 * 1408)
    assert dec.layers[1].shared_w1.shape == (2048, 2 * 2816)
    assert dec.latent_dim == 576
    n = sum(p.numel() for n_, p in dec.named_parameters()
            if not n_.endswith("_g"))
    assert n == 15_286_927_360
