"""On a CUDA card: the continuous-batching engine replays its step from a
CUDA graph (inference/engine.py:make_burst_fn) and serves what an engine
whose every step runs eagerly serves, bit for bit.  giga830M widths at 2
layers and tts830e.stream32's pads and bursts, 8 lanes: requests submitted
from the streaming callbacks as bursts go by, so refills land mid-flight.
bf16, and fp8 weights with packed qkv and the fp8 slab; top-k 1 (the
cell's) and top-k 40, both at temperature 1, so the lanes' generators are
live.  DeepSeek-V2's block at tiny_test_dsv2 replays its stack part by
part (models/deepseek_v2.py:StepGraphs) and serves what an eager engine
serves, bit for bit, too.  Run on a card with
``python -m pytest tests/test_torch_engine_graph.py -q``; it skips
elsewhere."""

import numpy as np
import pytest
import torch

from voicecraft_tpu_torch.inference import engine as eng_mod
from voicecraft_tpu_torch.inference.loader import load_model
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops import graphs
from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8

LAYERS = 2
F8 = "float8_e4m3fn"
# tts830e.stream32's geometry (benchmark/traffic/stream_poisson32.json),
# a shorter generated region
ENGINE = dict(lanes=8, x_pad=96, y_pad=448, gen_max=256, burst=48)
SILENCE = (1388, 1898, 131)
SAMPLINGS = {
    "topk1": vc.SamplingConfig(top_k=1, top_p=1.0, temperature=1.0,
                               stop_repetition=3, silence_tokens=SILENCE),
    "topk40": vc.SamplingConfig(top_k=40, top_p=1.0, temperature=1.0,
                                stop_repetition=3, silence_tokens=SILENCE),
}
SEED = 2718281828
N_REQUESTS, AT_START, PER_BURST = 16, 6, 2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured in a CUDA graph")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def models(card):
    """TTSEnhanced's token layout at giga830M widths and LAYERS layers,
    codebook 0's eos bias lowered by 10 as the cell lowers it (the length
    cap ends every request): bf16, and its fp8 twin (packed qkv)."""
    _, model, _ = load_model("giga830M_TTSEnhanced", random_init=True,
                             seed=5, device=card,
                             overrides=dict(num_decoder_layers=LAYERS))
    with torch.no_grad():
        model.heads.b2[0, model.cfg.eos] -= 10.0
    return {"bf16": (model, None),
            "fp8": (quantize_decoder_fp8(model, pack_qkv=True), F8)}


def _requests(cfg):
    """Prompts of 150-400 frames, 40-150 generated frames each (phones =
    (prompt + generated) / 10 + 1: the length cap ends them)."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(N_REQUESTS):
        frames = int(rng.integers(150, 401))
        gen = int(rng.integers(40, 151))
        phones = (frames + gen) // 10 + 1
        out.append((rng.integers(0, cfg.text_vocab_size, phones)
                    .astype(np.int32),
                    rng.integers(0, cfg.audio_vocab_size, (cfg.n_codebooks,
                                                           frames))
                    .astype(np.int32)))
    return out


def _serve(model, kv_dtype, scfg, engine=ENGINE):
    """AT_START requests at once (a wave), then PER_BURST more from the
    streaming callbacks after each burst: (rows by request, batcher)."""
    eng = eng_mod.ContinuousBatcher(model, scfg=scfg, seed=SEED,
                                    kv_dtype=kv_dtype, **engine)
    reqs = _requests(model.cfg)
    rids, seen = [], set()

    def submit(n):
        for _ in range(min(n, len(reqs) - len(rids))):
            rids.append(eng.submit(*reqs[len(rids)], on_rows=on_rows))

    def on_rows(rows):
        if eng.stats["bursts"] not in seen:       # once a burst
            seen.add(eng.stats["bursts"])
            submit(PER_BURST)

    submit(AT_START)
    res = eng.run()
    torch.cuda.synchronize()
    assert len(rids) == len(reqs) and set(res) == set(rids)
    return [res[r][1] for r in rids], eng


@pytest.mark.card
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("weights", ["bf16", "fp8"])
def test_graphed_engine_equals_eager_engine(models, weights, sampling,
                                            monkeypatch):
    model, kv_dtype = models[weights]
    scfg = SAMPLINGS[sampling]
    graphed, g_eng = _serve(model, kv_dtype, scfg)
    with monkeypatch.context() as m:
        m.setattr(graphs, "step_graph_engages", lambda model: False)
        eager, e_eng = _serve(model, kv_dtype, scfg)
    print(f"{weights} {sampling}: {g_eng.stats}; generated "
          f"{[g.shape[1] for g in graphed]}")
    assert g_eng.stats["refills"] >= N_REQUESTS - AT_START
    # step 0 runs eagerly, step 1 is captured and replayed, as is every
    # later one
    assert g_eng.stats["graph_steps"] == g_eng.stats["steps"] - 1
    assert e_eng.stats["graph_steps"] == 0
    assert g_eng.stats == {**e_eng.stats,
                           "graph_steps": g_eng.stats["graph_steps"]}
    assert all(g.shape[1] > 0 for g in graphed)
    for g, e in zip(graphed, eager):
        np.testing.assert_array_equal(g, e)


@pytest.mark.card
@pytest.mark.parametrize("graphed", [True, False])
def test_burst_has_no_host_sync(models, graphed, monkeypatch):
    """A burst after the capture (or an eager one) enqueues with no host
    sync: it runs under set_sync_debug_mode("error") without raising."""
    model, kv_dtype = models["fp8"]
    if not graphed:
        monkeypatch.setattr(graphs, "step_graph_engages",
                            lambda model: False)
    eng = eng_mod.ContinuousBatcher(model, scfg=SAMPLINGS["topk1"],
                                    seed=SEED, kv_dtype=kv_dtype, **ENGINE)
    for x, y in _requests(model.cfg)[:3]:
        eng.submit(x, y)
    eng._admit()
    eng._process_burst(eng._dispatch_burst())     # eager step 0, capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        snap = eng._dispatch_burst()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eng._process_burst(snap)
    steps = 2 * ENGINE["burst"]
    assert eng.stats["graph_steps"] == (steps - 1 if graphed else 0)


# for tiny_test_dsv2: _requests' texts fit x_pad and its prompts y_pad
DSV2_ENGINE = dict(lanes=8, x_pad=64, y_pad=448, gen_max=160, burst=16)


@pytest.mark.card
@pytest.mark.parametrize("top_k", [1, 40])
def test_dsv2_parts_replayed_equal_eager_engine(card, top_k, monkeypatch):
    """tiny_test_dsv2 in bf16: the engine steps eagerly around its stack's
    parts, each captured once for the batcher's life and replayed at every
    later step, and the rows equal an eager engine's bit for bit."""
    _, model, _ = load_model("tiny_test_dsv2", random_init=True, seed=5,
                             device=card)
    scfg = vc.SamplingConfig(top_k=top_k, top_p=1.0, temperature=1.0,
                             stop_repetition=3, silence_tokens=(5, 7))
    made, replays = [], [0]
    capture, replay = graphs.StepGraph.__init__, graphs.StepGraph.replay

    def counted_capture(g, *a, **kw):
        made.append(g)
        capture(g, *a, **kw)

    def counted_replay(g):
        replays[0] += 1
        replay(g)

    with monkeypatch.context() as m:
        m.setattr(graphs.StepGraph, "__init__", counted_capture)
        m.setattr(graphs.StepGraph, "replay", counted_replay)
        graphed, g_eng = _serve(model, None, scfg, DSV2_ENGINE)
    with monkeypatch.context() as m:
        m.setattr(graphs, "step_graph_engages", lambda model: False)
        eager, e_eng = _serve(model, None, scfg, DSV2_ENGINE)
    cfg = model.cfg
    n_dense = cfg.first_k_dense_replace
    parts = cfg.num_decoder_layers + n_dense + 3 * (
        cfg.num_decoder_layers - n_dense) + 1
    print(f"tiny_test_dsv2 top-k {top_k}: {g_eng.stats}; {len(made)} "
          f"parts, {replays[0]} replays; generated "
          f"{[g.shape[1] for g in graphed]}")
    assert g_eng.stats["refills"] >= N_REQUESTS - AT_START
    assert len(made) == parts
    assert replays[0] == parts * (g_eng.stats["steps"] - 1)
    assert g_eng.stats == e_eng.stats
    assert g_eng.stats["graph_steps"] == 0
    assert all(g.shape[1] > 0 for g in graphed)
    for g, e in zip(graphed, eager):
        np.testing.assert_array_equal(g, e)
