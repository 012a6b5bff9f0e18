"""The engine's ring decode attention over an fp8 slab
(ops/ring_attention.py): on the CPU, the wrapper's plain version against
the engine's arithmetic before the kernel (the layer's slab upcast by
transformer._layer_slab, then _attend_one under _ring_valid's mask) bit
for bit, and against a float64 loop over each lane's history; the engine's
routing of an fp8 slab.  On a CUDA card (marked ``card``; run with
``python -m pytest tests/test_torch_ring_attention.py -q``), the kernel of
csrc/ring_decode_attention.cu against its plain version, at
tts830e.stream32's step shape and at small head dims, and a graphed engine
through the kernel against an eager engine on the plain path."""

import dataclasses

import numpy as np
import pytest
import torch

from voicecraft_tpu_torch import config
from voicecraft_tpu_torch.inference import engine as eng_mod
from voicecraft_tpu_torch.models import transformer as trm
from voicecraft_tpu_torch.models import voicecraft as vc
from voicecraft_tpu_torch.ops import _native, graphs
from voicecraft_tpu_torch.ops.attention import _attend_one, _ring_valid
from voicecraft_tpu_torch.ops.ring_attention import (
    ring_decode_attention, ring_decode_attention_plain)

F8 = torch.float8_e4m3fn


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one thread each (see test_torch_spec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring_inputs(B, H, Dh, x_pad, y_start, W, gstep, x_lens, prefix_lens,
                 t_lane, dtype, device="cpu", seed=0):
    """Random q / k_new / v_new in ``dtype``, a one-layer fp8 slab [1, 2, B,
    y_start + W, H, Dh] (a ring of W slots after y_start) and the lanes'
    int64 geometry, all on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    S = y_start + W
    r = lambda *s: torch.randn(s, generator=g, device=device)
    cache = (2.0 * r(1, 2, B, S, H, Dh)).to(F8)
    long = lambda v: torch.as_tensor(v, dtype=torch.long, device=device)
    return dict(q=r(B, 1, H * Dh).to(dtype), cache=cache,
                k_new=r(B, 1, H, Dh).to(dtype), v_new=r(B, 1, H, Dh).to(dtype),
                x_lens=long(x_lens), prefix_lens=long(prefix_lens),
                t_lane=long(t_lane), gstep=long(gstep), x_pad=x_pad,
                y_start=y_start, W=W)


def _wrapper_args(a):
    return (a["q"], a["cache"][0, 0], a["cache"][0, 1], a["k_new"],
            a["v_new"], a["x_lens"], a["x_pad"], a["prefix_lens"],
            a["y_start"], a["W"], a["gstep"], a["t_lane"])


X_PAD, Y_START, W = 8, 32, 20
# lanes: empty (as the engine leaves one: x_len 1, prefix 1, t 0), just
# admitted (t = 0), text filling x_pad mid-ring, frozen at the row cap
# (t = W - 1 while the clock runs on)
LANES = dict(x_lens=[1, 5, X_PAD, 3], prefix_lens=[1, 17, 9, Y_START - X_PAD],
             t_lane=lambda g: [0, 0, min(g, 7), min(g, W - 1)])
RING_CASES = [
    # H, Dh, gstep
    (16, 128, 3 * W + 5),      # a ring that has wrapped three times
    (8, 64, W // 2),           # not yet wrapped
    (8, 16, W + 1),            # just wrapped
    (16, 64, 0),               # the first step: nothing generated valid
]


def _history_reference(a):
    """A float64 loop over each lane's keys as its history lists them:
    text [0, x_len), prompt [x_pad, x_pad + prefix_len), and the ring slot
    y_start + (s mod W) of each of its last t steps s < gstep."""
    q, cache = a["q"].double(), a["cache"].double()
    kn, vn = a["k_new"].double(), a["v_new"].double()
    B, S, H, Dh = cache.shape[2:]
    g = int(a["gstep"])
    out = torch.zeros((B, 1, H * Dh), dtype=torch.float64)
    for b in range(B):
        xl, pl, t = (int(a[n][b]) for n in ("x_lens", "prefix_lens",
                                            "t_lane"))
        keys = (list(range(xl)) + list(range(X_PAD, X_PAD + pl))
                + [Y_START + s % W for s in range(max(0, g - t), g)])
        for h in range(H):
            qh = q[b, 0, h * Dh:(h + 1) * Dh]
            k = torch.cat([cache[0, 0, b, keys, h], kn[b, 0, h][None]])
            v = torch.cat([cache[0, 1, b, keys, h], vn[b, 0, h][None]])
            p = torch.softmax(k @ qh / Dh ** 0.5, dim=0)
            out[b, 0, h * Dh:(h + 1) * Dh] = p @ v
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Dh,gstep", RING_CASES)
def test_plain_equals_upcast_then_attend_one(H, Dh, gstep, dtype):
    """The wrapper on CPU tensors (its plain version) computes what the
    engine computed before the kernel, bit for bit, and what each lane's
    history says it attends (float64 loop: f32 within 1e-5, bf16 within
    its rounding points)."""
    a = _ring_inputs(4, H, Dh, X_PAD, Y_START, W, gstep,
                     LANES["x_lens"], LANES["prefix_lens"],
                     LANES["t_lane"](gstep), dtype, seed=H + Dh + gstep)
    got = ring_decode_attention(*_wrapper_args(a))
    k, v = trm._layer_slab(a["cache"], 0, a["q"].dtype)
    valid = _ring_valid(Y_START + W, a["x_lens"], X_PAD, a["prefix_lens"],
                        Y_START, W, a["gstep"], a["t_lane"], "cpu")
    want = _attend_one(a["q"], k, v, valid, a["k_new"], a["v_new"])
    assert got.dtype == dtype and got.shape == (4, 1, H * Dh)
    assert torch.equal(got, want)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(got.double().numpy(),
                               _history_reference(a).numpy(), rtol=tol,
                               atol=tol)


def test_wrapper_takes_plain_version_only_on_cpu():
    a = _ring_inputs(2, 4, 16, X_PAD, Y_START, W, 9, [3, 8], [5, 12], [4, 0],
                     torch.float32)
    args = _wrapper_args(a)
    assert torch.equal(ring_decode_attention(*args),
                       ring_decode_attention_plain(*args))
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in args]
    with pytest.raises(ValueError, match="CUDA"):
        ring_decode_attention(*meta)


ENGINE = dict(lanes=2, x_pad=32, y_pad=64, gen_max=64, burst=8)


def _tiny_requests(cfg, n=3):
    rng = np.random.default_rng(4)
    return [(rng.integers(0, cfg.text_vocab_size, 6 + 2 * i).astype(np.int32),
             rng.integers(0, cfg.audio_vocab_size,
                          (cfg.n_codebooks, 12 + 5 * i)).astype(np.int32))
            for i in range(n)]


def _serve(model, reqs, scfg, engine):
    eng = eng_mod.ContinuousBatcher(model, scfg=scfg, seed=0,
                                    kv_dtype="float8_e4m3fn", **engine)
    ids = [eng.submit(x, y) for x, y in reqs]
    res = eng.run()
    return [res[i] for i in ids], eng


def test_engine_routes_fp8_slab_through_ring_attention(monkeypatch):
    """An fp8 engine on the CPU hands each layer's raw fp8 views to
    ring_decode_attention (L calls a step), launches no kernel, and serves
    the rows the engine's arithmetic before the kernel serves (the slab
    upcast by _layer_slab, then _attend_one)."""
    cfg = dataclasses.replace(config.tiny_test(), compute_dtype="float32")
    model = vc.VoiceCraft(cfg, "cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    model.eval()
    reqs = _tiny_requests(cfg)
    scfg = vc.SamplingConfig(top_k=1, silence_tokens=(5, 7))
    calls = []

    def spy(q, ks, vs, *rest):
        assert ks.dtype == F8 and vs.dtype == F8
        assert ks.data_ptr() != vs.data_ptr()
        calls.append(ks.shape)
        return ring_decode_attention(q, ks, vs, *rest)

    _native.reset_launch_counts()
    with monkeypatch.context() as m:
        m.setattr(eng_mod, "ring_decode_attention", spy)
        routed, eng = _serve(model, reqs, scfg, ENGINE)
    assert len(calls) == cfg.num_decoder_layers * eng.stats["steps"] > 0
    assert _native.LAUNCHES["ring_decode_attention"] == 0
    with monkeypatch.context() as m:
        m.setattr(eng_mod, "reads_fp8_slab", lambda cache: False)
        upcast, _ = _serve(model, reqs, scfg, ENGINE)
    for (fa, ga), (fb, gb) in zip(routed, upcast):
        np.testing.assert_array_equal(ga, gb)
        np.testing.assert_array_equal(fa, fb)


# ---- on a CUDA card ------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++")
    return torch.device("cuda")


# tts830e.stream32's step (benchmark/traffic/stream_poisson32.json): 32
# lanes, x_pad 96, y_pad 448, a ring of gen_max 448 + burst 48 slots
CELL = dict(B=32, x_pad=96, y_start=96 + 448, W=448 + 48)
CARD_CASES = [
    # name, H, Dh, dtype
    ("cell", 16, 128, torch.bfloat16),
    ("h8 dh64", 8, 64, torch.bfloat16),
    ("h8 dh16", 8, 16, torch.bfloat16),
    ("f32 h16 dh32", 16, 32, torch.float32),
]
# the kernel sums the logits, the softmax and p . v in another order than
# cuBLAS and PyTorch's softmax, so an f32 result may fall on the other side
# of a bf16 rounding: one ulp at the output, and a probability rounded the
# other way moves it by at most 2^-8 of that key's share; 2 ulps of
# max(|plain|, 1) hold both.  f32 outputs differ by the orders alone.
CARD_BF16_ULPS, CARD_F32_TOL = 2.0, 1e-5


def _cell_lanes(B, x_pad, y_start, W, rng):
    """Random ring geometry as the engine makes it: texts 1..x_pad, prompts
    150-400, t up to gen_max - 1; two empty lanes and two at t = 0; a clock
    far past many wraps."""
    gen_max = W - 48
    x = rng.integers(1, x_pad + 1, B)
    p = rng.integers(150, min(401, y_start - x_pad + 1), B)
    t = rng.integers(0, gen_max, B)
    x[:2], p[:2], t[:2] = 1, 1, 0
    t[2:4] = 0
    x[4] = x_pad
    return x, p, t, int(rng.integers(10 ** 6, 10 ** 7))


@pytest.mark.card
@pytest.mark.parametrize("name,H,Dh,dtype", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_kernel_matches_plain_on_card(card, name, H, Dh, dtype):
    rng = np.random.default_rng(H * Dh)
    x, p, t, gstep = _cell_lanes(CELL["B"], CELL["x_pad"], CELL["y_start"],
                                 CELL["W"], rng)
    a = _ring_inputs(CELL["B"], H, Dh, CELL["x_pad"], CELL["y_start"],
                     CELL["W"], gstep, x, p, t, dtype, device=card, seed=Dh)
    args = _wrapper_args(a)
    _native.reset_launch_counts()
    got = ring_decode_attention(*args)
    again = ring_decode_attention(*args)
    want = ring_decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["ring_decode_attention"] == 2
    assert torch.equal(got, again)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp(min=1.0))) - 7)
        worst = (diff / ulp).max().item()
        print(f"{name}: max abs err {diff.max().item():.3e}, {worst:.2f} "
              f"bf16 ulps of max(|plain|, 1)")
        assert worst <= CARD_BF16_ULPS
    else:
        print(f"{name}: max abs err {diff.max().item():.3e}")
        assert diff.max().item() <= CARD_F32_TOL
    # a packed qkv product's views: lanes 3 * H * Dh elements apart
    qkv = torch.cat([a["q"], a["k_new"].flatten(2), a["v_new"].flatten(2)],
                    dim=-1)
    q, kn, vn = qkv.chunk(3, dim=-1)
    B = CELL["B"]
    packed = ring_decode_attention(
        q, args[1], args[2], kn.reshape(B, 1, H, Dh), vn.reshape(B, 1, H, Dh),
        *args[5:])
    assert torch.equal(packed, got)


ENGINE_CARD = dict(lanes=8, x_pad=96, y_pad=448, gen_max=96, burst=16)
# the kernel path's logits against the plain path's on the same prefix:
# chip_smoke.py's TOL_LOGITS (the paths round to bf16 at other places)
TOL_LOGITS = 0.05


def _eager_rows(model, reqs, scfg, monkeypatch, plain):
    """An eager engine's raw rows by lane [t_b, K] (one wave: request i in
    lane i) and the logits each step fed the next ([B, K, card] a step),
    through the kernel or, with ``plain``, the upcast path."""
    logits = []
    heads = eng_mod.apply_heads

    def recorded(h, x):
        out = heads(h, x)
        logits.append(out.float().cpu())
        return out

    with monkeypatch.context() as m:
        m.setattr(graphs, "step_graph_engages", lambda model: False)
        m.setattr(eng_mod, "apply_heads", recorded)
        if plain:
            m.setattr(eng_mod, "reads_fp8_slab", lambda cache: False)
        res, eng = _serve(model, reqs, scfg, ENGINE_CARD)
    lens = [eng._lanes.t[b].item() for b in range(len(reqs))]
    rows = [eng._gen_buf[b, :n].cpu().numpy() for b, n in enumerate(lens)]
    return res, eng, rows, logits


@pytest.mark.card
def test_graphed_engine_through_kernel_equals_eager_plain(card, monkeypatch):
    """giga830M widths at 2 layers, fp8 weights (packed qkv) and slab, top-k
    1: the graphed engine through the kernel launches it L times an engine
    step and emits the codes of an eager engine through the kernel; that
    engine's rows equal an eager engine's on the plain path (the slab
    upcast, _attend_one) up to a near-tie: at the first row that differs,
    both paths' logits (on the same prefix) agree within TOL_LOGITS, and
    the plain path's margin between the two tokens chosen is under twice
    their largest difference, which the paths' other f32 summation orders
    can flip (random weights put the heads' top logits ~0.05 apart)."""
    from voicecraft_tpu_torch.inference.loader import load_model
    from voicecraft_tpu_torch.utils.quantize import quantize_decoder_fp8
    _, model, _ = load_model("giga830M_TTSEnhanced", random_init=True,
                             seed=5, device=card,
                             overrides=dict(num_decoder_layers=2))
    with torch.no_grad():
        model.heads.b2[0, model.cfg.eos] -= 10.0
    model = quantize_decoder_fp8(model, pack_qkv=True)
    cfg = model.cfg
    rng = np.random.default_rng(11)
    reqs = []
    for _ in range(6):
        frames, gen = int(rng.integers(150, 401)), int(rng.integers(30, 61))
        reqs.append((rng.integers(0, cfg.text_vocab_size,
                                  (frames + gen) // 10 + 1).astype(np.int32),
                     rng.integers(0, cfg.audio_vocab_size,
                                  (cfg.n_codebooks, frames)).astype(np.int32)))
    # no silence tokens: a sampled row is the argmax of the heads' logits
    scfg = vc.SamplingConfig(top_k=1, top_p=1.0, temperature=1.0,
                             silence_tokens=())
    L = cfg.num_decoder_layers
    _native.reset_launch_counts()
    graphed, g_eng = _serve(model, reqs, scfg, ENGINE_CARD)
    torch.cuda.synchronize()
    launches = _native.LAUNCHES["ring_decode_attention"]
    kernel, k_eng, k_rows, k_logits = _eager_rows(model, reqs, scfg,
                                                  monkeypatch, plain=False)
    eager_launches = _native.LAUNCHES["ring_decode_attention"] - launches
    plain, p_eng, p_rows, p_logits = _eager_rows(model, reqs, scfg,
                                                 monkeypatch, plain=True)
    torch.cuda.synchronize()
    print(f"graphed {g_eng.stats}, eager {k_eng.stats}, plain {p_eng.stats}; "
          f"ring launches {launches} graphed, {eager_launches} eager")
    assert g_eng.stats["graph_steps"] == g_eng.stats["steps"] - 1 > 0
    assert g_eng.stats["refills"] == 0
    assert launches == L * g_eng.stats["steps"]
    assert eager_launches == L * k_eng.stats["steps"]
    assert _native.LAUNCHES["ring_decode_attention"] == \
        launches + eager_launches
    assert all(g.shape[1] > 0 for _, g in graphed)
    for (fg, gg), (fk, gk) in zip(graphed, kernel):
        np.testing.assert_array_equal(gg, gk)
        np.testing.assert_array_equal(fg, fk)
    for b, (kr, pr) in enumerate(zip(k_rows, p_rows)):
        # row j was drawn from the logits of step j - 1 (row 0 from the
        # prefill's, which both paths share)
        diff = [0.0] + [(k_logits[j - 1][b] - p_logits[j - 1][b]).abs()
                        .max().item() for j in range(1, min(len(kr),
                                                            len(pr)))]
        for j in range(min(len(kr), len(pr))):
            if np.array_equal(kr[j], pr[j]):
                continue
            ks = np.nonzero(kr[j] != pr[j])[0]
            lg = p_logits[j - 1][b]
            margin = max(lg[k, pr[j, k]].item() - lg[k, kr[j, k]].item()
                         for k in ks)
            print(f"lane {b}: the first {j} rows equal, then a near-tie: "
                  f"margin {margin:.4f}, logits differ by {diff[j]:.4f} "
                  f"there (at most {max(diff[:j + 1]):.4f} before)")
            assert j > 0 and max(diff[:j + 1]) <= TOL_LOGITS
            assert margin <= 2 * diff[j]
            break
        else:
            print(f"lane {b}: all {len(kr)} rows equal; logits within "
                  f"{max(diff):.4f}")
            assert len(kr) == len(pr)
            np.testing.assert_array_equal(kernel[b][1], plain[b][1])
