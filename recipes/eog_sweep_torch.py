#!/usr/bin/env python3
"""Sweep of codebook 0's eog bias over chip_smoke.py's greedy and
speculative edit checks (phase 6 (i), phase 7 (l) and (m), phase 14 (D)),
on giga830M at full width cut to L layers, random weights from
chip_smoke's seed, on one CUDA card.  For each depth and bias it prints
each check's spans done and span frames, and ok when every span ends
(non-empty where chip_smoke requires it) within its budget:

    python3 recipes/eog_sweep_torch.py 4:0.3,0.36,0.4 2:0.3

chip_smoke.py's EOG_BIAS and PATH_DEPTH come from such a sweep."""
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np
import torch

import chip_smoke as cs
from voicecraft_tpu_torch.inference import serving as sv
from voicecraft_tpu_torch.inference.editing import inference_edit
from voicecraft_tpu_torch.inference.loader import load_codec, load_model
from voicecraft_tpu_torch.models import encodec as ec
from voicecraft_tpu_torch.models.voicecraft import SamplingConfig, init_mtp_heads

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
greedy = SamplingConfig(top_k=40, top_p=1.0, temperature=0.0)
t00 = time.time()
for arg in sys.argv[1:]:
    layers, biases = arg.split(":")
    layers, biases = int(layers), [float(b) for b in biases.split(",")]
    cfg, model, _ = load_model("giga830M", random_init=True, seed=cs.SEED,
                               device="cuda",
                               overrides=dict(num_decoder_layers=layers))
    ccfg, codec = load_codec(None, random_init=True, seed=cs.SEED,
                             device="cuda", codebook_size=cfg.audio_vocab_size)
    d, e = cs.edit_requests(model, codec)
    dd_codes = ec.encode_bucketed(codec, np.tile(e.wav, (1, 2)))[0]
    src = {"d": (d.x, d.codes), "e": (e.x, e.codes),
           "dd": (d.x[:2 * len(e.x) + 1], dd_codes)}
    lanes = [(*src[k], iv) for k, iv in cs.EDIT_SERVE]
    lpads0, _ = sv.edit_wave_inputs(model, lanes)
    mtp = init_mtp_heads(dataclasses.replace(cfg, n_mtp=cs.N_MTP),
                         torch.Generator(device="cuda").manual_seed(cs.SEED + 4),
                         "cuda")
    for bias in biases:
        cs.EOG_BIAS = bias
        t0 = time.time()
        row = {}
        with cs.raised_eog_bias(model):
            st = {}
            sv.serve_edit_batch(model, lanes, greedy, seed=cs.SEED,
                                pads=lpads0[:2] + (cs.EDIT_GEN_MAX,), stats=st)
            row["l_greedy"] = (st["done"], st["span_frames"])
            st = {}
            inference_edit(model, d.x, d.codes, d.intervals, greedy,
                           seed=cs.SEED, gen_max=cs.EDIT_GEN_MAX, stats=st)
            row["D"] = (st["spans_done"], st["span_frames"])
            model.mtp_heads = mtp
            st = {}
            inference_edit(model, d.x, d.codes, d.intervals, d.scfg,
                           seed=cs.SEED, gen_max=cs.SPEC_EDIT_GEN_MAX,
                           stats=st, spec=cs.TAU)
            row["i"] = (st["spans_done"], st["span_frames"])
            st = {}
            sv.serve_edit_batch(model, lanes, greedy, seed=cs.SEED,
                                pads=lpads0[:2] + (cs.SPEC_EDIT_GEN_MAX,),
                                spec=cs.TAU, stats=st)
            row["m_edit"] = (st["done"], st["span_frames"])
            del model.mtp_heads
        ok = (all(row["l_greedy"][0]) and min(min(s) for s in row["l_greedy"][1]) > 0
              and row["D"][0] == 3 and min(row["D"][1]) > 0
              and row["i"][0] == 3 and min(row["i"][1]) > 0
              and all(row["m_edit"][0]))
        print(f"L={layers} bias={bias} ok={ok} {row} ({time.time() - t0:.1f} s)",
              flush=True)
    del model, codec
    torch.cuda.empty_cache()
print(f"total {time.time() - t00:.1f} s")
