"""Continuous batching in the port (inference/engine.py) against the JAX
package's engine and the port's own single-stream decode, on the CPU: the
ring attention, greedy requests through mid-flight refill, special_first,
the fp8 slab, wave against per-lane admission, and sampled output keyed on
the admission.  Both packages run tiny_test in f32 on the same weights."""

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicecraft_tpu.config import tiny_test
from voicecraft_tpu.inference import engine as jeng
from voicecraft_tpu.models import voicecraft as jvc
from voicecraft_tpu_torch import config
from voicecraft_tpu_torch.data.spans import compose_tts_prefix
from voicecraft_tpu_torch.inference import engine as eng_mod
from voicecraft_tpu_torch.inference.spec_common import (generator_seed,
                                                        seeded_generator)
from voicecraft_tpu_torch.inference.tts import inference_tts
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops import attention as attn
from voicecraft_tpu_torch.ops import graphs
from voicecraft_tpu_torch.utils import tracing
from voicecraft_tpu_torch.utils.convert import from_jax_params

F8 = "float8_e4m3fn"
GREEDY = dict(top_k=1, silence_tokens=(5, 7))
SAMPLED = dict(top_k=10, top_p=0.9, silence_tokens=(5, 7))
ARGMAX = dict(temperature=0.0, silence_tokens=(5, 7))
ENGINE = dict(x_pad=32, y_pad=64, gen_max=256, burst=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one thread each (see test_torch_spec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg, seed):
    params = jvc.init_params(cfg, jax.random.PRNGKey(seed))
    model = vc.VoiceCraft(cfg, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          cfg))
    return params, model.eval()


def _requests(cfg, n=5, seed=6, shift=0):
    """The JAX engine test's requests: text 6 + 2i, prompt 12 + 5i frames."""
    rng = np.random.default_rng(seed)
    K = cfg.n_codebooks
    reqs = []
    for i in range(n):
        x = rng.integers(0, cfg.text_vocab_size, 6 + 2 * i).astype(np.int32)
        y = rng.integers(0, cfg.audio_vocab_size - shift,
                         (K, 12 + 5 * i)).astype(np.int32)
        reqs.append((x, y))
    return reqs


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32")
    params, model = _pair(cfg, 7)
    return cfg, params, model, _requests(cfg)


def _run(model, reqs, scfg, **kw):
    eng = eng_mod.ContinuousBatcher(model, scfg=scfg, seed=0,
                                    **{**ENGINE, **kw})
    ids = [eng.submit(x, y) for x, y in reqs]
    res = eng.run()
    assert set(res) == set(ids)
    return [res[i] for i in ids], eng


# ---- the ring attention -------------------------------------------------------

@pytest.mark.parametrize("gstep", [0, 5, 17, 29, 52])
def test_decode_attention_ring_matches_jax(gstep):
    """Ring width 12: gstep 17 and 29 are past one and two wraps, 52 past
    four; lanes at t = 0 (nothing generated valid), mid-ring and at W."""
    B, H, Dh, x_pad, y_start, W = 4, 4, 16, 8, 20, 12
    S_max = y_start + W
    xl, pl = np.asarray([3, 8, 5, 1]), np.asarray([12, 4, 9, 1])
    t_lane = np.asarray([0, 4, min(gstep, W), 1])
    rng = np.random.default_rng(gstep)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kc, vc_, kn, vn = (r(B, 1, H * Dh), r(B, S_max, H, Dh),
                          r(B, S_max, H, Dh), r(B, 1, H, Dh), r(B, 1, H, Dh))
    got = attn.decode_attention_ring(
        *map(torch.from_numpy, (q, kc, vc_, kn, vn)), H, torch.from_numpy(xl),
        x_pad, torch.from_numpy(pl), y_start, W, torch.tensor(gstep),
        torch.from_numpy(t_lane))
    want = jeng._ring_attention(
        *map(jnp.asarray, (q, kc, vc_, kn, vn)), H, jnp.asarray(xl), x_pad,
        jnp.asarray(pl), y_start, W, jnp.asarray(gstep), jnp.asarray(t_lane))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ---- greedy requests through refill -------------------------------------------

def test_engine_matches_single_with_refill(setup):
    """5 requests into 2 lanes, burst 16 (at least 3 refills): each request
    equals the port's own inference_tts exactly, and the JAX engine's
    output (both f32, so the tie-aware rule holds in its strict form)."""
    cfg, params, model, reqs = setup
    scfg = vc.SamplingConfig(**GREEDY)
    outs, eng = _run(model, reqs, scfg, lanes=2)
    assert eng.stats["waves"] == 1 and eng.stats["refills"] >= 3
    jeng_ = jeng.ContinuousBatcher(params, cfg, lanes=2, scfg=jvc.SamplingConfig(
        **GREEDY), seed=0, **ENGINE)
    jids = [jeng_.submit(x, y) for x, y in reqs]
    jres = jeng_.run()
    for (full, gen), (x, y), jid in zip(outs, reqs, jids):
        f1, g1 = inference_tts(model, x, y, scfg, seed=0)
        assert gen.shape == g1.shape
        np.testing.assert_array_equal(gen, g1)
        np.testing.assert_array_equal(full, f1)
        np.testing.assert_array_equal(full[:, :y.shape[1]], y)
        np.testing.assert_array_equal(gen, jres[jid][1])
        np.testing.assert_array_equal(full, jres[jid][0])


def test_engine_special_first():
    """special_first: gen is unshifted before the raw prompt is prepended."""
    cfg = dataclasses.replace(tiny_test(), compute_dtype="float32",
                              special_first=1)
    _, model = _pair(cfg, 7)
    rng = np.random.default_rng(13)
    K = cfg.n_codebooks
    scfg = vc.SamplingConfig(**GREEDY)
    x = rng.integers(0, cfg.text_vocab_size, 8).astype(np.int32)
    y = rng.integers(0, cfg.audio_vocab_size - cfg.n_special,
                     (K, 14)).astype(np.int32)
    ((full, gen),), _ = _run(model, [(x, y)], scfg, lanes=2)
    f1, g1 = inference_tts(model, x, y, scfg, seed=0)
    np.testing.assert_array_equal(gen, g1)
    np.testing.assert_array_equal(full, f1)
    np.testing.assert_array_equal(full[:, :y.shape[1]], y)


def test_engine_fp8_kv_cache(setup):
    """The fp8 slab: deterministic over two runs, well-formed, and the
    logits after one burst within 0.25 (relative to the largest) of the f32
    slab's, but not equal (the slab really is fp8)."""
    cfg, _, model, reqs = setup
    scfg = vc.SamplingConfig(**GREEDY)
    K = cfg.n_codebooks
    a, _ = _run(model, reqs[:3], scfg, lanes=2, kv_dtype=F8)
    b, _ = _run(model, reqs[:3], scfg, lanes=2, kv_dtype=F8)
    for (fa, ga), (_, gb), (_, y) in zip(a, b, reqs):
        np.testing.assert_array_equal(ga, gb)
        np.testing.assert_array_equal(fa[:, :y.shape[1]], y)
        assert ga.shape[0] == K and 0 <= ga.shape[1] < ENGINE["gen_max"]
        assert (ga >= 0).all() and (ga < cfg.card).all()
    logits = {}
    for kv in (None, F8):
        eng = eng_mod.ContinuousBatcher(model, lanes=1, scfg=scfg, seed=0,
                                        kv_dtype=kv, **{**ENGINE, "burst": 8})
        eng.submit(*reqs[0])
        eng._admit()
        eng._dispatch_burst()
        logits[kv] = eng._lanes.logits[0].numpy()
    rel = (np.abs(logits[F8] - logits[None]).max()
           / max(np.abs(logits[None]).max(), 1e-6))
    assert 0 < rel < 0.25, rel


def test_wave_admission_equals_lane_refill(setup):
    """The wave prefill of lanes 0 and 2 leaves the same lane state and
    slab rows as two single-lane refills, and lane 1 untouched."""
    cfg, _, model, reqs = setup
    K, L, H, Dh = (cfg.n_codebooks, cfg.num_decoder_layers, cfg.nhead,
                   cfg.head_dim)
    x_pad, y_pad = ENGINE["x_pad"], ENGINE["y_pad"]
    s_max = x_pad + y_pad + 40
    rows = []
    for rid, (x, y) in zip((3, 8), reqs[1:3]):
        prefix = compose_tts_prefix(y, cfg)
        xt = np.full((1, x_pad), cfg.text_pad_token, np.int64)
        xt[0, :len(x)] = x
        yt = np.full((1, K, y_pad), cfg.empty_token, np.int64)
        yt[0, :, :prefix.length] = prefix.tokens
        rows.append((rid, xt, len(x), yt, prefix.length))
    states = []
    for wave in (True, False):
        cache = torch.zeros((L, 2, 3, s_max, H, Dh))
        s = eng_mod._empty_lanes(3, K, cfg.card, cfg.d_model, "cpu")
        if wave:
            fn = eng_mod.make_prefill_batch_fn(cfg, x_pad=x_pad, y_pad=y_pad)
            cache, s = fn(model, cache, s, [0, 2],
                          np.concatenate([r[1] for r in rows]),
                          [r[2] for r in rows],
                          np.concatenate([r[3] for r in rows]),
                          [r[4] for r in rows], [r[0] for r in rows])
        else:
            fn = eng_mod.make_prefill_lane_fn(cfg, x_pad=x_pad, y_pad=y_pad)
            for lane, (rid, xt, xl, yt, pl) in zip((0, 2), rows):
                cache, s = fn(model, cache, s, lane, xt, xl, yt, pl, rid)
        states.append((cache, s))
    (cw, sw), (cl, sl) = states
    for f in dataclasses.fields(sw):
        a, b = getattr(sw, f.name), getattr(sl, f.name)
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), f.name)
    np.testing.assert_allclose(cw.numpy(), cl.numpy(), rtol=0, atol=1e-5)
    assert sw.active.tolist() == [True, False, True]
    assert sw.admit_id.tolist() == [3, 0, 8]
    assert not cw[:, :, 1].any() and not cw[:, :, :, x_pad + y_pad:].any()


def test_sampled_output_independent_of_lane_and_wave(setup):
    """Sampled noise is keyed on the admission: each request draws the same
    rows whether the requests share one wave (3 lanes), ride 2 lanes with
    refills, or one lane in turn."""
    _, _, model, reqs = setup
    scfg = vc.SamplingConfig(**SAMPLED)
    outs = [_run(model, reqs[:3], scfg, lanes=n)[0] for n in (3, 2, 1)]
    for other in outs[1:]:
        for (fa, ga), (fb, gb) in zip(outs[0], other):
            np.testing.assert_array_equal(ga, gb)
            np.testing.assert_array_equal(fa, fb)
    # and the draws are real samples: another seed, other rows
    eng = eng_mod.ContinuousBatcher(model, lanes=3, scfg=scfg, seed=1,
                                    **ENGINE)
    ids = [eng.submit(x, y) for x, y in reqs[:3]]
    res = eng.run()
    assert any(res[i][1].shape != g.shape or not np.array_equal(res[i][1], g)
               for i, (_, g) in zip(ids, outs[0]))


def test_engine_refuses_mesh(setup):
    """A mesh whose data axis does not divide the lanes is refused (the
    mesh runs: tests/test_torch_mesh_serving.py)."""
    _, _, model, _ = setup
    mesh = types.SimpleNamespace(n_data=3, data_rank=0)
    with pytest.raises(ValueError, match="shard over data=3"):
        eng_mod.ContinuousBatcher(model, lanes=2, mesh=mesh)


# ---- the in-place step the engine's CUDA graph replays ------------------------

def _state_ptrs(eng):
    return ({f.name: getattr(eng._lanes, f.name).data_ptr()
             for f in dataclasses.fields(eng._lanes)},
            eng._cache.data_ptr(), eng._gen_buf.data_ptr())


def test_burst_updates_state_in_place(setup):
    """Bursts through mid-flight refills (those of
    test_engine_matches_single_with_refill, whose outputs it checks) keep
    the storage of every LaneState tensor, the slab and the row buffer (a
    CUDA graph of the step replays on those addresses), return the very
    objects they were given, and keep the lane generators."""
    _, _, model, reqs = setup
    eng = eng_mod.ContinuousBatcher(model, lanes=2, seed=0,
                                    scfg=vc.SamplingConfig(**SAMPLED),
                                    **ENGINE)
    for x, y in reqs:
        eng.submit(x, y)
    before, gens = _state_ptrs(eng), list(eng._gens)
    lanes, cache, gen_buf = eng._lanes, eng._cache, eng._gen_buf
    assert len(eng.run()) == len(reqs)
    assert eng.stats["refills"] >= 3
    assert _state_ptrs(eng) == before
    assert all(a is b for a, b in zip(
        (eng._lanes, eng._cache, eng._gen_buf, *eng._gens),
        (lanes, cache, gen_buf, *gens)))
    assert eng.stats["graph_steps"] == 0          # the CPU steps eagerly


def test_lane_generator_reseeded_in_place_draws_as_fresh(setup):
    """At admission lane b's generator is re-seeded in place from (seed,
    rid): its draws are those of a fresh seeded_generator((seed, rid)),
    whatever it drew before."""
    _, _, model, reqs = setup
    g = torch.Generator().manual_seed(5)
    torch.rand(7, generator=g)
    g.manual_seed(generator_seed((3, 11)))
    np.testing.assert_array_equal(
        torch.rand((4, 50), generator=g).numpy(),
        torch.rand((4, 50), generator=seeded_generator((3, 11), "cpu")).numpy())
    scfg = vc.SamplingConfig(**SAMPLED)
    eng = eng_mod.ContinuousBatcher(model, lanes=2, scfg=scfg, seed=3,
                                    **ENGINE)
    first = list(eng._gens)
    for x, y in reqs[:3]:
        eng.submit(x, y)
    eng._admit()
    eng._dispatch_burst()                         # lanes 0 and 1 draw
    eng._lane_req[1] = None                       # free lane 1: rid 2 next
    eng._admit()
    assert eng._lane_req[1] == 2 and eng._gens[1] is first[1]
    np.testing.assert_array_equal(
        torch.rand((4, 50), generator=eng._gens[1]).numpy(),
        torch.rand((4, 50), generator=seeded_generator((3, 2), "cpu")).numpy())


def test_sampled_rows_independent_of_lane_and_refill_time(setup):
    """A sampled request (rid 1) draws the same rows in lane 1 of the
    start-up wave as refilled mid-flight into lane 0 after rid 0 retires,
    and as refilled into lane 1 one burst after rid 0 began."""
    _, _, model, reqs = setup
    scfg = vc.SamplingConfig(**SAMPLED)
    runs = []
    for lanes, stagger in ((3, False), (1, False), (2, True)):
        eng = eng_mod.ContinuousBatcher(model, lanes=lanes, scfg=scfg,
                                        seed=0, **ENGINE)
        admitted = {}
        admit = eng._admit

        def recording_admit(eng=eng, admit=admit, admitted=admitted):
            admit()
            for b, rid in enumerate(eng._lane_req):
                if rid is not None and rid not in admitted:
                    admitted[rid] = (b, int(eng._lanes.gstep))
        eng._admit = recording_admit
        eng.submit(*reqs[0])
        if stagger:
            eng._admit()
            eng._process_burst(eng._dispatch_burst())
        rid = eng.submit(*reqs[1])
        res = eng.run()
        runs.append((admitted[rid], res[rid]))
    (where, (full, gen)), *others = runs
    assert where == (1, 0)
    assert [w for w, _ in others] == [
        (0, others[0][0][1]), (1, ENGINE["burst"])]
    assert others[0][0][1] > 0                    # after rid 0's bursts
    for _, (f, g) in others:
        np.testing.assert_array_equal(g, gen)
        np.testing.assert_array_equal(f, full)


class _FakeGraph:
    """A stand-in for ops/graphs.py:StepGraph on the CPU: the capture keeps
    the step and the registered generators, a replay runs the step and
    writes what it returns into ``out`` (the first replay's tensors, in
    place after that, as a replay refills the captured outputs)."""
    made = []

    def __init__(self, step, generators, device):
        self.step, self.generators = step, list(generators)
        self.out, self.replays = None, 0
        _FakeGraph.made.append(self)

    def replay(self):
        out = self.step()
        if self.replays == 0:
            self.out = out
        elif out is not None:
            for a, b in zip(*((o,) if torch.is_tensor(o) else o
                              for o in (self.out, out))):
                a.copy_(b)
        self.replays += 1


@pytest.fixture(scope="module")
def setup_dsv2():
    """tiny_test_dsv2 in f32 with random weights, and _requests'."""
    cfg = dataclasses.replace(config.tiny_test_dsv2(),
                              compute_dtype="float32")
    model = vc.VoiceCraft(cfg, "cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    return model.eval(), _requests(cfg)


@pytest.mark.parametrize("block", ["voicecraft", "deepseek_v2"])
@pytest.mark.parametrize("sampling", ["top-k 1", "sampled", "argmax"])
def test_graphed_engine_control_flow(request, monkeypatch, sampling, block):
    """Where the step is graphed: the batcher's first step runs eagerly,
    the second captures and every later step replays, and the rows equal
    an eager engine's.  VoiceCraft's block captures its whole step once for
    the batcher's life (every lane's generator registered unless greedy
    draws nothing), as the counters say.  DeepSeek-V2's steps eagerly
    around its stack's parts, each captured once for the batcher's life
    and replayed at every later step, and counts no replayed step."""
    if block == "voicecraft":
        _, _, model, reqs = request.getfixturevalue("setup")
    else:
        model, reqs = request.getfixturevalue("setup_dsv2")
    scfg = vc.SamplingConfig(**{"top-k 1": GREEDY, "sampled": SAMPLED,
                                "argmax": ARGMAX}[sampling])
    eager, _ = _run(model, reqs, scfg, lanes=2)
    _FakeGraph.made = []
    site = types.SimpleNamespace(running=contextlib.nullcontext)
    monkeypatch.setattr(graphs, "StepGraph", _FakeGraph)
    monkeypatch.setattr(graphs, "step_graph_engages", lambda model: True)
    monkeypatch.setattr(graphs, "CaptureSite",
                        types.SimpleNamespace(of=lambda device: site))
    tracing.clear()
    graphed, eng = _run(model, reqs, scfg, lanes=2)
    steps = eng.stats["steps"]
    if block == "voicecraft":
        assert len(_FakeGraph.made) == 1
        want = eng._gens if scfg.temperature > 0 else []
        assert len(_FakeGraph.made[0].generators) == len(want)
        assert all(a is b for a, b in zip(_FakeGraph.made[0].generators,
                                          want))
        assert eng.stats["graph_steps"] == steps - 1
    else:
        cfg = model.cfg
        n_dense = cfg.first_k_dense_replace
        # per layer its attention, then a dense FFN or routing, routed
        # products and combine; then the final norm
        parts = cfg.num_decoder_layers + n_dense + 3 * (
            cfg.num_decoder_layers - n_dense) + 1
        assert len(_FakeGraph.made) == parts
        assert all(g.generators == [] for g in _FakeGraph.made)
        assert all(g.replays == steps - 1 for g in _FakeGraph.made)
        assert eng.stats["graph_steps"] == 0
    bursts = tracing.bursts()
    assert sum(b.steps for b in bursts) == steps
    assert sum(b.graph_steps for b in bursts) == eng.stats["graph_steps"]
    for (fa, ga), (fb, gb) in zip(eager, graphed):
        np.testing.assert_array_equal(ga, gb)
        np.testing.assert_array_equal(fa, fb)
