#!/usr/bin/env python3
"""Smoke run of the PyTorch port (voicecraft_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device   the card's name and power limit; TF32 off in matmuls and cuDNN
  2. build    the CUDA kernels from voicecraft_tpu_torch/csrc (nvcc, sm_90a)
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes: max abs error against a stated
              tolerance, and both times from CUDA events
  4. slice    giga830M in bf16 and the 16 kHz EnCodec, random weights from a
              seed, serving three zero-shot TTS requests through the
              functions tts_torch_cli.py calls: (a) a ~17 s prompt, whose
              prefill goes through the attention kernel, sampled, with the
              fused FFN kernel; (b) the same greedy; (c) the 4.3 s demo
              prompt, dense prefill, greedy, unfused FFN.  Checks the launch
              counts and that every wav is finite; then the logits of the
              kernel path against the plain path after prefill and after 16
              teacher-forced decode steps.

The last three lines are the card (as nvidia-smi reports it), one JSON
object with each kernel's result, and {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0
GEN_MAX = 256
PROMPT = "the sound of birds over the river at dawn"
TARGET = "the river runs past the old mill in the morning light"
LONG_TILES = 4                       # demo.wav (4.32 s) tiled to 17.28 s

# kernel vs plain tolerances (both accumulate in f32; they differ in
# summation order, and in bf16 by at most one or two ulps of the rounded
# output, whose magnitudes here stay below ~2)
TOL_FLASH_BF16 = 2e-2
TOL_FLASH_F32 = 1e-4
TOL_FFN = 2e-2
# kernel path vs plain path logits of giga830M in bf16: the two paths round
# to bf16 at different places (the fused FFN rounds x@w1 once with its bias,
# the unfused one twice; the attention kernel rounds its f32 output once),
# and those bf16 ulps (0.4% relative) pass through 16 residual layers and
# the heads; random-weight logits stay below ~1.5, so 0.05 is a few percent
TOL_LOGITS = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check(name: str, err: float, tol: float) -> None:
    log(f"  {name}: max abs err {err:.3e} (tolerance {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")


# ---- phase 3 -----------------------------------------------------------------

def flash_phase(geom_long):
    import torch
    from voicecraft_tpu_torch.ops.flash_attention import (
        flash_prefix_attention, flash_prefix_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def case(B, S, D, H, x_pad, x_lens, y_lens, dtype):
        q, k, v = (torch.randn((B, S, D), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        xl = torch.tensor(x_lens, dtype=torch.int32, device="cuda")
        yl = torch.tensor(y_lens, dtype=torch.int32, device="cuda")
        args = (q, k, v, xl, yl, x_pad, H)
        got = flash_prefix_attention(*args).float()
        want = flash_prefix_attention_plain(*args).float()
        torch.cuda.synchronize()
        rows = torch.zeros((B, S), dtype=torch.bool, device="cuda")
        for b in range(B):
            rows[b, :x_lens[b]] = True
            rows[b, x_pad:x_pad + y_lens[b]] = True
        err = (got - want)[rows].abs().max().item()
        return err, args

    x_len, x_pad, y_len, y_pad = geom_long
    S = x_pad + y_pad
    log(f"flash_prefix_attention, bf16, B=1 S={S} D=2048 H=16 "
        f"(x_len {x_len}, x_pad {x_pad}, y_len {y_len}):")
    err, args = case(1, S, 2048, 16, x_pad, [x_len], [y_len], torch.bfloat16)
    check("bf16 main-path shape", err, TOL_FLASH_BF16)
    ms = cuda_ms(lambda: flash_prefix_attention(*args))
    plain_ms = cuda_ms(lambda: flash_prefix_attention_plain(*args))
    log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call")
    for B, S2, D, H, xp, xl, yl in ((2, 200, 256, 4, 48, [30, 48], [100, 152]),
                                    (2, 130, 128, 8, 32, [7, 32], [98, 50]),
                                    (1, 333, 256, 8, 64, [50], [250]),
                                    (1, 300, 512, 4, 64, [64], [236])):
        e, _ = case(B, S2, D, H, xp, xl, yl, torch.float32)
        check(f"f32 B={B} S={S2} Dh={D // H}", e, TOL_FLASH_F32)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def quantize_fp8(w):
    """[in, out] -> {'q': e4m3 [in, out], 'scale': bf16 [1, out]}, the
    per-output-channel layout of voicecraft_tpu/utils/quantize.py."""
    import torch
    scale = (w.float().abs().amax(dim=0, keepdim=True) / 448.0).clamp(min=1e-12)
    return {"q": (w.float() / scale).to(torch.float8_e4m3fn),
            "scale": scale.to(torch.bfloat16)}


def ffn_phase():
    import torch
    from voicecraft_tpu_torch.ops.fused_decode import fused_ffn, fused_ffn_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    D, F = 2048, 8192
    bf = torch.bfloat16

    def uni(shape, bound):
        return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                * bound).to(bf)
    w1, b1 = uni((D, F), D ** -0.5), uni((F,), D ** -0.5)
    w2, b2 = uni((F, D), F ** -0.5), uni((D,), F ** -0.5)
    q1, q2 = quantize_fp8(w1), quantize_fp8(w2)
    result = None
    for B in (1, 4):
        x = torch.randn((B, D), generator=gen, device="cuda").to(bf)
        for label, a1, a2 in (("bf16", w1, w2), ("fp8", q1, q2)):
            args = (x, a1, b1, a2, b2)
            err = (fused_ffn(*args).float()
                   - fused_ffn_plain(*args).float()).abs().max().item()
            log(f"fused_ffn, B={B} D={D} F={F}, {label} weights:")
            check(f"B={B} {label}", err, TOL_FFN)
            ms = cuda_ms(lambda: fused_ffn(*args))
            plain_ms = cuda_ms(lambda: fused_ffn_plain(*args))
            log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call")
            if B == 1 and label == "bf16":          # the main path's shape
                unfused_ms = cuda_ms(
                    lambda: torch.relu(x @ w1 + b1) @ w2 + b2)
                log(f"  unfused bf16 torch FFN (the default decode path) "
                    f"{unfused_ms:.4f} ms per call")
                result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return result


# ---- phase 4 -----------------------------------------------------------------

class Request:
    def __init__(self, name, wav, transcript, scfg, fused_ffn):
        self.name, self.wav, self.transcript = name, wav, transcript
        self.scfg, self.fused_ffn = scfg, fused_ffn


def teacher_forced_logits(model, x, codes, plain: bool):
    """Logits after prefill and after each of 16 teacher-forced decode steps
    of the long request, through the kernels (plain=False) or through
    their plain versions and the unfused FFN (plain=True)."""
    import torch
    from voicecraft_tpu_torch.data.spans import compose_tts_prefix
    from voicecraft_tpu_torch.inference.tts import decode_geometry, pad_inputs
    from voicecraft_tpu_torch.models import transformer as trm
    from voicecraft_tpu_torch.models.voicecraft import (apply_heads,
                                                        embed_prefix, embed_step)
    from voicecraft_tpu_torch.ops.flash_attention import (
        flash_prefix_attention_plain, prefill_attention)
    cfg = model.cfg
    prefix = compose_tts_prefix(codes, cfg)
    x_pad, y_pad, _ = decode_geometry(cfg, len(x), prefix.length, gen_max=16)
    xt, yt, mi = pad_inputs(cfg, x, prefix, x_pad, y_pad, "cuda")
    xl = torch.tensor([len(x)], dtype=torch.int32, device="cuda")
    yl = torch.tensor([prefix.length], dtype=torch.int32, device="cuda")
    if plain:
        attn = lambda q, k, v: flash_prefix_attention_plain(q, k, v, xl, yl,
                                                            x_pad, cfg.nhead)
    else:
        attn = prefill_attention(xl, yl, x_pad, cfg.nhead, x_pad + y_pad)
    cache = trm.init_kv_cache(cfg.num_decoder_layers, 1, x_pad + y_pad + 16,
                              cfg.nhead, cfg.head_dim, model.dtype, "cuda")
    tokens = torch.randint(0, cfg.audio_vocab_size, (16, cfg.n_codebooks),
                           generator=torch.Generator(device="cuda").manual_seed(7),
                           device="cuda")
    out = []
    with torch.inference_mode():
        h, cache = trm.prefill(model.decoder, embed_prefix(model, xt, yt, mi),
                               attn, cache)
        out.append(apply_heads(model.heads, h[:, x_pad + prefix.length - 1]))
        pos = torch.tensor(x_pad + prefix.length, device="cuda")
        y_pos = torch.tensor(prefix.length, device="cuda")
        x_len = torch.tensor(len(x), device="cuda")
        for i in range(16):
            h, cache = trm.decode_step_fast(
                model.decoder, embed_step(model, tokens[i], y_pos), cache, pos,
                x_len=x_len, x_pad=x_pad, fused_ffn=not plain)
            out.append(apply_heads(model.heads, h[:, 0]))
            pos += 1
            y_pos += 1
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from voicecraft_tpu.config import PRESETS
    from voicecraft_tpu.data.phonemes import (build_vocab, make_text_tokenizer,
                                              phones_to_ids)
    from voicecraft_tpu.utils import audio as au
    from voicecraft_tpu_torch.inference.loader import load_codec, load_model
    from voicecraft_tpu_torch.inference.tts import decode_geometry, inference_tts
    from voicecraft_tpu_torch.models import encodec as ec
    from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
    from voicecraft_tpu_torch.ops import _native

    # ---- 1. device ----
    card = card_line()
    log(f"[1 device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----
    t0 = time.time()
    lib_path, build_log = _native.build()
    _native.lib()
    log(f"[2 build] {lib_path.relative_to(REPO)} in {time.time() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())

    # the requests' inputs, as tts_torch_cli.py makes them
    tok = make_text_tokenizer("en-us", "grapheme")
    demo = au.load_audio(str(REPO / "demo" / "demo.wav"), 16000)
    long_wav = np.tile(demo, (1, LONG_TILES))
    long_text = " ".join([PROMPT] * LONG_TILES)
    sampled = SamplingConfig(top_k=40, top_p=1.0, temperature=1.0)
    greedy = SamplingConfig(top_k=40, top_p=1.0, temperature=0.0)
    requests = [Request("a", long_wav, long_text, sampled, True),
                Request("b", long_wav, long_text, greedy, True),
                Request("c", demo, PROMPT, greedy, False)]
    for r in requests:
        r.phones = tok.phonemize(r.transcript + " " + TARGET)
    vocab = build_vocab([r.phones for r in requests])
    for r in requests:
        r.x = np.asarray(phones_to_ids(r.phones, vocab), np.int32)
    long_frames = -(-long_wav.shape[1] // 320)
    x_pad, y_pad, _ = decode_geometry(PRESETS["giga830M"](), len(requests[0].x),
                                      long_frames + 1, gen_max=GEN_MAX)
    if x_pad + y_pad < 1024:
        raise AssertionError(f"long prompt prefill {x_pad + y_pad} < 1024")

    # ---- 3. kernels vs plain ----
    log("[3 kernels]")
    flash = flash_phase((len(requests[0].x), x_pad, long_frames + 1, y_pad))
    ffn = ffn_phase()

    # ---- 4. the slice ----
    t0 = time.time()
    cfg, model, _ = load_model("giga830M", random_init=True, seed=SEED,
                               device="cuda")
    ccfg, codec = load_codec(None, random_init=True, seed=SEED, device="cuda",
                             codebook_size=cfg.audio_vocab_size)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[4 slice] giga830M {model.dtype} ({n_params / 1e6:.1f}M params) and "
        f"codec built in {time.time() - t0:.1f} s")

    _native.reset_launch_counts()
    for r in requests:
        before = dict(_native.LAUNCHES)
        t0 = time.time()
        codes = ec.encode_bucketed(codec, r.wav)[0]
        t_enc = time.time() - t0
        stats = {}
        t0 = time.time()
        full, gen = inference_tts(model, r.x, codes, r.scfg, seed=SEED,
                                  gen_max=GEN_MAX, fused_ffn=r.fused_ffn,
                                  stats=stats)
        wall = time.time() - t0
        t0 = time.time()
        wav = ec.decode_bucketed(codec, full[None])[0]
        t_dec = time.time() - t0
        d_flash = _native.LAUNCHES["flash_prefix_attention"] - before["flash_prefix_attention"]
        d_ffn = _native.LAUNCHES["fused_ffn"] - before["fused_ffn"]
        Sp, steps = stats["prefill_len"], stats["steps"]
        log(f"  request ({r.name}): prompt {r.wav.shape[1] / 16000:.2f} s = "
            f"{codes.shape[1]} frames, x_len {len(r.x)}, Sp {Sp}, "
            f"{'sampled' if r.scfg.temperature > 0 else 'greedy'}, "
            f"fused_ffn {r.fused_ffn}: {steps} decode steps, {gen.shape[1]} "
            f"frames in {wall:.3f} s = {gen.shape[1] / wall:.1f} frames/s "
            f"({steps / wall:.1f} steps/s); encode {t_enc:.3f} s, "
            f"decode {t_dec:.3f} s; launches flash {d_flash}, ffn {d_ffn}")
        L = cfg.num_decoder_layers
        want_flash = L if Sp >= 1024 else 0
        want_ffn = L * steps if r.fused_ffn else 0
        if d_flash != want_flash or d_ffn != want_ffn:
            raise AssertionError(f"request ({r.name}): launches flash {d_flash} "
                                 f"(want {want_flash}), ffn {d_ffn} "
                                 f"(want {want_ffn})")
        if not (np.array_equal(full[:, :codes.shape[1]], codes)
                and full.shape == (cfg.n_codebooks, codes.shape[1] + gen.shape[1])
                and wav.shape == (full.shape[1] * ccfg.hop_length,)
                and np.isfinite(wav).all()):
            raise AssertionError(f"request ({r.name}): bad output: full "
                                 f"{full.shape}, wav {wav.shape}, finite "
                                 f"{np.isfinite(wav).all()}")
    launches = dict(_native.LAUNCHES)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched by the slice")

    long_codes = ec.encode_bucketed(codec, long_wav)[0]
    k_path = teacher_forced_logits(model, requests[0].x, long_codes, plain=False)
    p_path = teacher_forced_logits(model, requests[0].x, long_codes, plain=True)
    scale = max(t.abs().max().item() for t in p_path)
    errs = [(a - b).abs().max().item() for a, b in zip(k_path, p_path)]
    log(f"  logits, kernel path vs plain path (max |logit| {scale:.3f}):")
    check("after prefill", errs[0], TOL_LOGITS)
    check("after 16 teacher-forced decode steps", max(errs[1:]), TOL_LOGITS)

    kernels = [
        dict(name="flash_prefix_attention", route="cuda",
             source="voicecraft_tpu_torch/csrc/flash_prefix_attention.cu",
             replaces="voicecraft_tpu/ops/flash_attention.py:82",
             launches=launches["flash_prefix_attention"], **flash),
        dict(name="fused_ffn", route="cuda",
             source="voicecraft_tpu_torch/csrc/fused_ffn.cu",
             replaces="voicecraft_tpu/ops/fused_decode.py:58",
             launches=launches["fused_ffn"], **ffn),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
