"""Lockstep multi-lane serving: N distinct requests decoded in one wave
(PyTorch port of voicecraft_tpu/inference/serving.py).

Each lane carries its own text, prompt, lengths, seed and stopping state;
one forward per step (or per speculative pass) serves every lane, so a step
reads the weights once for all of them.  The wave is prefilled once, [B,
x_pad + y_pad, D] through ops.flash_attention.prefill_attention with each
lane's own text and prompt lengths (the attention kernel at B = lanes from
1024 columns).

Slab layout per lane b ([L, 2, B, S_max, H, Dh], the compute dtype or
float8_e4m3fn with ``kv_dtype``):

    [ text 0..x_len_b | pad .. x_pad | prompt 0..prefix_len_b | pad .. y_pad |
      generated ... ]

Per-lane validity masks carve out the pads (ops.attention.
decode_attention_multi / _multi_block).  The plain loops write at a uniform
pointer y_start + t; the speculative loops write each lane's block at its
own offset y_start + t_b.  A finished (frozen) lane keeps writing past its
own valid region, which only its own attention reads and never admits; its
recorded rows never change again.

Every write lies inside the slab (a torch index out of range raises, where
JAX's scatter would drop it):

- plain TTS: pointer < y_start + gen_max = S_max (the loop stops at
  gen_max steps);
- plain editing: pointer < y_start + gen_max + 2 (max_spans - 1) = S_max
  (the loop stops at t_max = gen_max + 2 (max_spans - 1) steps);
- speculative TTS: a lane accepts token i only while t_b + i < gen_max, so
  t_b <= gen_max and its block [y_start + t_b, + tau) ends before
  y_start + gen_max + tau = S_max;
- speculative editing: t_b = recorded rows + 2 per feed pass <= gen_max +
  2 (n_spans - 1), so the block ends before y_start + gen_max + tau + 2
  (max_spans - 1) = S_max.

All state lives on the device; each loop syncs with the host once per step
or pass.  The FFN is the unfused one, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..data import spans
from ..models import transformer as trm
from ..models.voicecraft import (SamplingConfig, VoiceCraft, _adjust_and_sample,
                                 apply_heads, check_mtp_heads,
                                 column_embedding, embed_audio_tokens,
                                 lookup, prefill_lanes)
from ..ops import patterns
from ..parallel.mesh import data_slice, gather_objects
from .spec_common import (lane_generators, lane_seeds, make_lane_sampler,
                          spec_verify_pass, token_generators)
from .tts import check_codes


@dataclasses.dataclass
class ServingResult:
    """What one wave leaves: the recorded rows of every lane and, from the
    last host sync, the counts."""
    gen_buf: torch.Tensor            # [rows, B, K] delayed-space samples
    span_buf: Optional[torch.Tensor]  # [rows, B] span index of each row (edits)
    n_rows: List[int]                # recorded rows per lane
    steps: int                       # forwards (speculative: block passes)
    done: List[bool]                 # lanes that finished (else at budget)


def _wave_on_mesh(loop, model: VoiceCraft, args: tuple, mesh
                  ) -> ServingResult:
    """Run ``loop`` (a serving loop's decode, built for this rank's lanes)
    over this data rank's lanes of the wave ``args`` (the per-lane inputs,
    the seeds last); every rank gets the whole wave's ServingResult.

    Lanes are sharded over the mesh's 'data' axis (the wave's B % n_data ==
    0, as the JAX package asserts); each keeps its wave index b as the key
    of its noise, so a lane draws what it draws in a one-device wave.  A
    data row decodes its lanes on its own (only the model axis's
    collectives run in a step) and stops when its lanes are done; the rows
    recorded are then gathered, with the counts: steps is the longest
    row's."""
    if mesh is None or mesh.n_data == 1:
        return loop(model, *args)
    sl = data_slice(len(args[-1]), mesh)
    res = loop(model, *(a[sl] for a in args),
               lane_ids=range(sl.start, sl.stop))
    parts = gather_objects((res.gen_buf.cpu().numpy(),
                            None if res.span_buf is None
                            else res.span_buf.cpu().numpy(),
                            res.n_rows, res.steps, res.done), mesh)
    cat = lambda i: torch.from_numpy(np.concatenate([p[i] for p in parts],
                                                    axis=1))
    return ServingResult(cat(0), None if res.span_buf is None else cat(1),
                         [n for p in parts for n in p[2]],
                         max(p[3] for p in parts),
                         [d for p in parts for d in p[4]])


def _lane_state(B: int, K: int, dev):
    """Per-lane sampling state: (eog [B, K], cur_num_gen, consec, prev)."""
    z = lambda: torch.zeros((B,), dtype=torch.long, device=dev)
    return (torch.zeros((B, K), dtype=torch.bool, device=dev), z(), z(),
            torch.full((B,), -1, dtype=torch.long, device=dev))


def _lane_inputs(model: VoiceCraft, x_lens, prefix_lens):
    """x_lens / prefix_lens as the prefill wants them (int32 on the
    device) and as the sampler wants them (long)."""
    dev = model.device
    xl = torch.as_tensor(x_lens, device=dev).to(torch.int32)
    pl = torch.as_tensor(prefix_lens, device=dev).to(torch.int32)
    return xl, pl, xl.long(), pl.long()


def _step_feed(model: VoiceCraft, emb: torch.Tensor,
               y_pos: torch.Tensor) -> torch.Tensor:
    """Step input [B, 1, D]: embeddings [B, D] (compute dtype) plus each
    lane's alpha-scaled positional term at audio position y_pos [B]."""
    dtype = model.dtype
    pe = model.pe.index_select(0, y_pos).to(dtype)
    return (emb + model.alpha_audio.to(dtype) * pe)[:, None]


def make_serving_tts_loop(cfg: ModelConfig, *, batch_size: int, x_pad: int,
                          y_pad: int, gen_max: int, scfg: SamplingConfig,
                          kv_dtype: Optional[str] = None):
    """Lockstep TTS over ``batch_size`` distinct requests.

    Each step samples every lane at once (the vectorised sampler; each
    lane's noise from its own generator, keyed on (seed_b, b): a wave can
    mix seeds, and same-seed requests in different lanes draw
    independently), then runs one decode_step_multi for the wave.  A lane
    whose eog cascade completes freezes: it emits empty rows and keeps its
    state.  ``kv_dtype`` (``"float8_e4m3fn"``) stores the slab in fp8.

    Returns decode(model, x_tokens [B, x_pad], x_lens [B], y_prefix [B, K,
    y_pad], prefix_lens [B], seeds [B]) -> ServingResult (n_rows: the row
    of each lane's cascade completion + 1, or gen_max).
    """
    K, B = cfg.n_codebooks, batch_size
    cap_mult = cfg.encodec_sr // 5
    y_start = x_pad + y_pad
    s_max = y_start + gen_max
    sample_lanes = make_lane_sampler(cfg, scfg, cap_mult)

    @torch.inference_mode()
    def decode(model: VoiceCraft, x_tokens, x_lens, y_prefix, prefix_lens,
               seeds: Sequence[int],
               lane_ids: Optional[Sequence[int]] = None) -> ServingResult:
        dev, dtype = model.device, model.dtype
        ltype = torch.long
        x_lens, prefix_lens, xl, pl = _lane_inputs(model, x_lens, prefix_lens)
        no_mask = torch.full((1, y_pad), -1, dtype=ltype, device=dev)
        _, logits, cache = prefill_lanes(model, x_tokens, x_lens, y_prefix,
                                         prefix_lens, no_mask, s_max, kv_dtype)
        gens = (lane_generators(seeds, dev, B, lane_ids)
                if scfg.temperature > 0
                else None)
        eog, _, consec, prev = _lane_state(B, K, dev)
        gen_buf = torch.zeros((gen_max, B, K), dtype=ltype, device=dev)
        finish = torch.full((B,), -1, dtype=ltype, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        empty = torch.full((B, K), cfg.empty_token, dtype=ltype, device=dev)
        t_dev = torch.zeros((), dtype=ltype, device=dev)
        pos = torch.tensor(y_start, device=dev)
        t = 0
        while True:
            y_pos = pl + t_dev
            samples, new_eog, consec, prev = sample_lanes(
                gens, logits, eog, t_dev.expand(B), consec, prev, y_pos, xl)
            # a frozen lane emits empty rows and keeps eog all-True
            samples = torch.where(done[:, None], empty, samples)
            new_eog = torch.where(done[:, None], eog, new_eog)
            complete = new_eog.all(dim=1) & ~done
            finish = torch.where(complete, t_dev, finish)
            done = done | complete
            eog = new_eog
            gen_buf[t] = samples
            emb = embed_audio_tokens(model.audio_emb,
                                     samples[:, :, None])[:, 0].to(dtype)
            h, cache = trm.decode_step_multi(
                model.decoder, _step_feed(model, emb, y_pos), cache, pos,
                x_lens, x_pad, prefix_lens, y_start)
            logits = apply_heads(model.heads, h[:, 0])
            pos += 1
            t_dev += 1
            t += 1
            if bool(done.all()) or t >= gen_max:
                break
        fin = finish.tolist()
        return ServingResult(gen_buf, None,
                             [f + 1 if f >= 0 else t for f in fin], t,
                             [f >= 0 for f in fin])

    return decode


def make_spec_serving_loop(cfg: ModelConfig, *, batch_size: int, n_draft: int,
                           x_pad: int, y_pad: int, gen_max: int,
                           scfg: SamplingConfig,
                           kv_dtype: Optional[str] = None,
                           bench_mode: bool = False,
                           force_accept: bool = False):
    """Speculative lockstep TTS: tau = ``n_draft`` tokens per lane per
    verified pass (inference/spec_common.spec_verify_pass over all lanes).
    Lanes accept different counts, so each writes its block at its own
    compact slab offset (trm.decode_step_multi_block).  Greedy lanes equal
    the plain serving loop's (exactly in f32); sampled draws are keyed per
    (lane, token index), so sampled output is the same for every tau.
    ``force_accept`` / ``bench_mode`` (measurement) as in
    models.voicecraft.make_spec_decode_loop.  One host sync per pass.

    Returns decode(model, x_tokens [B, x_pad], x_lens [B], y_prefix [B, K,
    y_pad], prefix_lens [B], seeds [B]) -> ServingResult (gen_buf [gen_max
    + tau, B, K]; steps = passes).
    """
    if n_draft < 1:
        raise ValueError(f"n_draft must be >= 1, got {n_draft}")
    K, B, tau = cfg.n_codebooks, batch_size, n_draft
    cap_mult = cfg.encodec_sr // 5
    y_start = x_pad + y_pad
    s_max = y_start + gen_max + tau
    sample_lanes = make_lane_sampler(cfg, scfg, cap_mult)

    @torch.inference_mode()
    def decode(model: VoiceCraft, x_tokens, x_lens, y_prefix, prefix_lens,
               seeds: Sequence[int],
               lane_ids: Optional[Sequence[int]] = None) -> ServingResult:
        check_mtp_heads(model, tau)
        dev = model.device
        ltype = torch.long
        x_lens, prefix_lens, xl, pl = _lane_inputs(model, x_lens, prefix_lens)
        no_mask = torch.full((1, y_pad), -1, dtype=ltype, device=dev)
        h, logits, cache = prefill_lanes(model, x_tokens, x_lens, y_prefix,
                                         prefix_lens, no_mask, s_max, kv_dtype)
        h = h.float()
        gens = token_generators(scfg, seeds, dev, lanes=B, lane_ids=lane_ids)
        eog, cng, consec, prev = _lane_state(B, K, dev)
        t = torch.zeros((B,), dtype=ltype, device=dev)
        gen_buf = torch.zeros((gen_max + tau, B, K), dtype=ltype, device=dev)
        pending = torch.zeros((B, K), dtype=ltype, device=dev)
        has_pending = torch.zeros((B,), dtype=torch.bool, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        lanes = torch.arange(B, device=dev)[:, None]
        slots = torch.arange(tau, device=dev)[None, :]
        t_host, passes = [0] * B, 0
        while True:
            active = ~done

            def forward(feed, t=t):
                return trm.decode_step_multi_block(
                    model.decoder, feed, cache, y_start + t, x_lens, x_pad,
                    prefix_lens, y_start, gen_lens=t)[0]

            out = spec_verify_pass(
                model, cfg, sample_lanes, tau=tau, gate=active,
                tok_gen=lambda i, salt, th=t_host: gens([n + i for n in th],
                                                        salt),
                y_pos0=pl + t, x_lens=xl, logits=logits, h=h, eog=eog,
                cng=cng, consec=consec, prev=prev, t=t, accept_cap=gen_max,
                forward=forward, bench_mode=bench_mode,
                force_accept=force_accept, scfg=scfg, is_tts=True,
                cap_mult=cap_mult, pending=pending, has_pending=has_pending)
            # rows at n_acc or beyond are overwritten later or never read
            gen_buf[t[:, None] + slots, lanes] = out["blk"]
            t = t + out["n_acc"]
            done = done | (active & out["eog"].all(dim=1)) | (t >= gen_max)
            eog, cng, consec, prev = (out["eog"], out["cng"], out["consec"],
                                      out["prev"])
            logits, h = out["logits_next"], out["h_next"]
            pending, has_pending = out["pending"], out["has_pending"]
            passes += 1
            sync = torch.cat([t, done.long(), eog.all(dim=1).long()]).tolist()
            t_host = sync[:B]
            if all(sync[B:2 * B]):
                break
        return ServingResult(gen_buf, None, t_host, passes,
                             [bool(e) for e in sync[2 * B:]])

    return decode


def make_serving_edit_loop(cfg: ModelConfig, *, batch_size: int, x_pad: int,
                           y_pad: int, gen_max: int, scfg: SamplingConfig,
                           max_spans: Optional[int] = None,
                           kv_dtype: Optional[str] = None,
                           bench_mode: bool = False):
    """Lockstep multi-span editing over ``batch_size`` distinct requests.

    The single-stream edit loop (models.voicecraft.make_decode_loop,
    is_tts=False) vectorised over lanes: each lane has its own [2, D] feed
    queue ([B, 2, D]) of [mask embedding of its next span, empty column]
    and its own span index.  Every step, feed or sample, writes one slab
    row, so the pointer y_start + t stays uniform; each lane records its
    samples at its own compact row gen_cnt_b (feeds record nothing).  A
    lane freezes when its last span completes or its ``gen_max`` rows are
    recorded: its state updates are gated off (``active``) and its recorded
    prefix is final.  ``bench_mode`` (measurement) never completes a span.

    Returns decode(model, x_tokens [B, x_pad], x_lens [B], y_prefix [B, K,
    y_pad], prefix_lens [B], mask_emb_idx [B, y_pad], queue_mask_ids [B,
    max_spans], n_spans [B], seeds [B]) -> ServingResult (n_rows: gen_cnt).
    """
    K, D, B = cfg.n_codebooks, cfg.d_model, batch_size
    cap_mult = 10
    max_spans = max_spans or cfg.max_n_spans
    y_start = x_pad + y_pad
    t_max = gen_max + 2 * (max_spans - 1)
    s_max = y_start + t_max

    @torch.inference_mode()
    def decode(model: VoiceCraft, x_tokens, x_lens, y_prefix, prefix_lens,
               mask_emb_idx, queue_mask_ids, n_spans,
               seeds: Sequence[int],
               lane_ids: Optional[Sequence[int]] = None) -> ServingResult:
        dev, dtype = model.device, model.dtype
        ltype = torch.long
        x_lens, prefix_lens, xl, pl = _lane_inputs(model, x_lens, prefix_lens)
        _, logits, cache = prefill_lanes(model, x_tokens, x_lens, y_prefix,
                                         prefix_lens, mask_emb_idx, s_max,
                                         kv_dtype)
        gens = (lane_generators(seeds, dev, B, lane_ids)
                if scfg.temperature > 0
                else None)
        n_spans = torch.as_tensor(n_spans, device=dev).long()
        queue_mask_ids = torch.as_tensor(queue_mask_ids, device=dev).long()
        empty_emb = column_embedding(
            model, torch.full((K,), cfg.empty_token, dtype=ltype, device=dev))
        eog, cng, consec, prev = _lane_state(B, K, dev)
        zeros = lambda: torch.zeros((B,), dtype=ltype, device=dev)
        gen_buf = torch.zeros((gen_max, B, K), dtype=ltype, device=dev)
        span_buf = torch.zeros((gen_max, B), dtype=ltype, device=dev)
        gen_cnt, span_idx, queue_len = zeros(), zeros(), zeros()
        queue = torch.zeros((B, 2, D), dtype=dtype, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        lanes = torch.arange(B, device=dev)
        t_dev = torch.zeros((), dtype=ltype, device=dev)
        pos = torch.tensor(y_start, device=dev)
        t = 0
        while True:
            active = ~done & (gen_cnt < gen_max)
            feeding = queue_len > 0
            y_pos = pl + t_dev
            samples, new_eog, new_consec, new_prev = _adjust_and_sample(
                cfg, scfg, False, cap_mult, gens, logits, eog, cng, consec,
                prev, y_pos, xl, bench_mode=bench_mode)
            span_complete = new_eog.all(dim=1) & ~feeding & active
            record = ~feeding & active

            # per-lane compact recording (a frozen lane at its budget
            # rewrites its last row with itself)
            w_idx = gen_cnt.clamp(max=gen_max - 1)
            gen_buf[w_idx, lanes] = torch.where(record[:, None], samples,
                                                gen_buf[w_idx, lanes])
            span_buf[w_idx, lanes] = torch.where(record, span_idx,
                                                 span_buf[w_idx, lanes])
            gen_cnt = gen_cnt + record.long()

            sample_emb = embed_audio_tokens(
                model.audio_emb, samples[:, :, None])[:, 0].to(dtype)
            emb = torch.where(feeding[:, None], queue[:, 0], sample_emb)

            # on a span's completion with spans left, queue [mask embedding
            # of the lane's next span, empty column]; a feed step pops
            more = span_idx + 1 < n_spans
            start_next = span_complete & more
            next_id = queue_mask_ids[lanes, (span_idx + 1).clamp(
                max=max_spans - 1)]
            new_queue = torch.stack(
                [lookup(model.mask_emb, next_id).to(dtype),
                 empty_emb.expand(B, D)], dim=1)
            consume = feeding & active
            queue = torch.where(
                start_next[:, None, None], new_queue,
                torch.where(consume[:, None, None],
                            queue[:, 1:2].expand(B, 2, D), queue))
            queue_len = torch.where(start_next, 2,
                                    torch.where(consume, queue_len - 1,
                                                queue_len))
            done = done | (span_complete & ~more)
            span_idx = span_idx + start_next.long()

            # per-span resets; feeding and frozen lanes keep their state
            keep = feeding | ~active
            eog = torch.where(span_complete[:, None], False,
                              torch.where(keep[:, None], eog, new_eog))
            cng = torch.where(span_complete, 0,
                              torch.where(keep, cng, cng + 1))
            consec = torch.where(span_complete, 0,
                                 torch.where(keep, consec, new_consec))
            prev = torch.where(span_complete, -1,
                               torch.where(keep, prev, new_prev))

            h, cache = trm.decode_step_multi(
                model.decoder, _step_feed(model, emb, y_pos), cache, pos,
                x_lens, x_pad, prefix_lens, y_start)
            logits = apply_heads(model.heads, h[:, 0])
            pos += 1
            t_dev += 1
            t += 1
            # a lane that is done or at its budget never records again
            if not bool((~done & (gen_cnt < gen_max)).any()) or t >= t_max:
                break
        return ServingResult(gen_buf, span_buf, gen_cnt.tolist(), t,
                             [bool(d) for d in done.tolist()])

    return decode


def make_spec_serving_edit_loop(cfg: ModelConfig, *, batch_size: int,
                                n_draft: int, x_pad: int, y_pad: int,
                                gen_max: int, scfg: SamplingConfig,
                                max_spans: Optional[int] = None,
                                kv_dtype: Optional[str] = None,
                                bench_mode: bool = False):
    """Speculative lockstep multi-span editing: tau = ``n_draft`` tokens
    per lane per verified pass.

    Lanes can be in different modes within one pass: a sampling lane
    verifies its drafts and advances by what it accepts, while a lane at a
    span transition runs a FEED pass, its two queued embeddings riding
    slots 0-1 of the same block (``mix_emb``), its verify core gated off,
    advancing by exactly 2 (slots 2.. are masked garbage).  Each lane
    writes at its own slab offset y_start + t_b (t_b counts feeds and
    accepted rows), and a feed lane's next pass starts from the block's raw
    outputs at slot 1 (the empty column's).  Greedy lanes equal the plain
    edit serving loop's and make_spec_edit_loop's (exactly in f32); sampled
    draws are keyed per (lane, recorded row index).  ``n_draft`` >= 2.

    Returns decode(model, x_tokens, x_lens, y_prefix, prefix_lens,
    mask_emb_idx, queue_mask_ids, n_spans, seeds) as make_serving_edit_loop
    -> ServingResult (gen_buf / span_buf [gen_max + tau, B, ...]; steps =
    passes).
    """
    if n_draft < 2:
        raise ValueError("speculative editing needs n_draft >= 2 (a feed "
                         "pass carries two embeddings)")
    K, D, B, tau = cfg.n_codebooks, cfg.d_model, batch_size, n_draft
    cap_mult = 10
    max_spans = max_spans or cfg.max_n_spans
    y_start = x_pad + y_pad
    s_max = y_start + gen_max + tau + 2 * (max_spans - 1)
    sample_lanes = make_lane_sampler(cfg, scfg, cap_mult, is_tts=False)

    @torch.inference_mode()
    def decode(model: VoiceCraft, x_tokens, x_lens, y_prefix, prefix_lens,
               mask_emb_idx, queue_mask_ids, n_spans,
               seeds: Sequence[int],
               lane_ids: Optional[Sequence[int]] = None) -> ServingResult:
        check_mtp_heads(model, tau)
        dev, dtype = model.device, model.dtype
        ltype = torch.long
        x_lens, prefix_lens, xl, pl = _lane_inputs(model, x_lens, prefix_lens)
        h, logits, cache = prefill_lanes(model, x_tokens, x_lens, y_prefix,
                                         prefix_lens, mask_emb_idx, s_max,
                                         kv_dtype)
        h = h.float()
        gens = token_generators(scfg, seeds, dev, lanes=B, lane_ids=lane_ids)
        n_spans = torch.as_tensor(n_spans, device=dev).long()
        queue_mask_ids = torch.as_tensor(queue_mask_ids, device=dev).long()
        empty_emb = column_embedding(
            model, torch.full((K,), cfg.empty_token, dtype=ltype, device=dev))
        eog, cng, consec, prev = _lane_state(B, K, dev)
        zeros = lambda: torch.zeros((B,), dtype=ltype, device=dev)
        t, gen_cnt, span_idx, queue_len = zeros(), zeros(), zeros(), zeros()
        gen_buf = torch.zeros((gen_max + tau, B, K), dtype=ltype, device=dev)
        span_buf = torch.zeros((gen_max + tau, B), dtype=ltype, device=dev)
        queue = torch.zeros((B, 2, D), dtype=dtype, device=dev)
        tail = torch.zeros((B, tau - 2, D), dtype=dtype, device=dev)
        pending = torch.zeros((B, K), dtype=ltype, device=dev)
        has_pending = torch.zeros((B,), dtype=torch.bool, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        finished = torch.zeros((B,), dtype=torch.bool, device=dev)
        lanes = torch.arange(B, device=dev)
        slots = torch.arange(tau, device=dev)[None, :]
        cnt_host, passes = [0] * B, 0
        while True:
            active = ~done & (gen_cnt < gen_max)
            feeding = (queue_len > 0) & active
            gate = active & ~feeding
            feed_emb = torch.cat([queue, tail], dim=1)

            def forward(feed, t=t):
                return trm.decode_step_multi_block(
                    model.decoder, feed, cache, y_start + t, x_lens, x_pad,
                    prefix_lens, y_start, gen_lens=t)[0]

            out = spec_verify_pass(
                model, cfg, sample_lanes, tau=tau, gate=gate,
                tok_gen=lambda i, salt, ch=cnt_host: gens(
                    [n + i for n in ch], salt),
                y_pos0=pl + t, x_lens=xl, logits=logits, h=h, eog=eog,
                cng=cng, consec=consec, prev=prev, t=gen_cnt,
                accept_cap=gen_max, forward=forward,
                mix_emb=lambda e, fe=feed_emb, fd=feeding: torch.where(
                    fd[:, None, None], fe, e),
                bench_mode=bench_mode, scfg=scfg, is_tts=False,
                cap_mult=cap_mult, pending=pending, has_pending=has_pending)

            # accepted rows at each lane's compact offset; rows at n_acc or
            # beyond are overwritten later or never read
            rows = gen_cnt[:, None] + slots
            gen_buf[rows, lanes[:, None]] = out["blk"]
            span_buf[rows, lanes[:, None]] = span_idx[:, None].expand(B, tau)
            gen_cnt = gen_cnt + out["n_acc"]

            # span transitions: every accepted slot of a pass shares the
            # lane's span (the verify core kills slots after an all-eog one)
            eog_f = out["eog"]
            span_complete = gate & eog_f.all(dim=1)
            more = span_idx + 1 < n_spans
            start_next = span_complete & more
            next_id = queue_mask_ids[lanes, (span_idx + 1).clamp(
                max=max_spans - 1)]
            new_queue = torch.stack(
                [lookup(model.mask_emb, next_id).to(dtype),
                 empty_emb.expand(B, D)], dim=1)
            # a feed pass consumes both queued embeddings
            queue = torch.where(start_next[:, None, None], new_queue, queue)
            queue_len = torch.where(start_next, 2,
                                    torch.where(feeding, 0, queue_len))
            finished = finished | (span_complete & ~more)
            done = done | finished | (gen_cnt >= gen_max)
            span_idx = span_idx + start_next.long()

            # per-span resets (feeding and frozen lanes' state is already
            # held by the gated verify core)
            eog = torch.where(span_complete[:, None], False, eog_f)
            cng = torch.where(span_complete, 0, out["cng"])
            consec = torch.where(span_complete, 0, out["consec"])
            prev = torch.where(span_complete, -1, out["prev"])
            pending, has_pending = out["pending"], out["has_pending"]

            # a feed lane advances 2 and hands over the second feed's raw
            # outputs (the empty column's logits open its next span)
            t = t + torch.where(feeding, 2, out["n_acc"])
            logits = torch.where(feeding[:, None, None],
                                 out["logits_blk"][:, 1], out["logits_next"])
            h = torch.where(feeding[:, None], out["h_blk"][:, 1].float(),
                            out["h_next"])
            passes += 1
            sync = torch.cat([gen_cnt, done.long(), finished.long()]).tolist()
            cnt_host = sync[:B]
            if all(sync[B:2 * B]):
                break
        return ServingResult(gen_buf, span_buf, cnt_host, passes,
                             [bool(f) for f in sync[2 * B:]])

    return decode


# ---- the batch entry points ------------------------------------------------------

def _ceil(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _seeds(seed: int, seeds: Optional[Sequence[int]], B: int) -> List[int]:
    return lane_seeds(seed if seeds is None else seeds, B)


def tts_wave_inputs(model: VoiceCraft,
                    requests: Sequence[Tuple[np.ndarray, np.ndarray]],
                    pads: Optional[Tuple[int, int, int]] = None):
    """The padded wave of (x_tokens, y_codes) TTS requests, as
    serve_tts_batch builds it: ((x_pad, y_pad, gen_max), (x_tokens [B,
    x_pad], x_lens [B], y_prefix [B, K, y_pad], prefix_lens [B])), the
    tensors on the model's device; make_serving_tts_loop's decode and
    make_spec_serving_loop's take these, then the seeds."""
    cfg = model.cfg
    K, B = cfg.n_codebooks, len(requests)
    for _, y in requests:
        check_codes(cfg, y)
    shift = cfg.n_special if cfg.special_first else 0
    prefixes = [spans.compose_tts_prefix(y + shift, cfg) for _, y in requests]
    x_lens = np.asarray([len(x) for x, _ in requests], np.int64)
    p_lens = np.asarray([p.length for p in prefixes], np.int64)
    cap = cfg.encodec_sr // 5
    if pads is None:
        pads = (_ceil(int(x_lens.max()), 32), _ceil(int(p_lens.max()), 64),
                _ceil(int((x_lens * cap - p_lens).max()) + K + 8, 128))
    x_pad, y_pad, _ = pads
    xt = np.full((B, x_pad), cfg.text_pad_token, np.int64)
    yt = np.full((B, K, y_pad), cfg.empty_token, np.int64)
    for b, ((x, _), p) in enumerate(zip(requests, prefixes)):
        xt[b, :len(x)] = x
        yt[b, :, :p.length] = p.tokens
    dev = model.device
    return pads, (torch.from_numpy(xt).to(dev), x_lens,
                  torch.from_numpy(yt).to(dev), p_lens)


def serve_tts_batch(model: VoiceCraft,
                    requests: Sequence[Tuple[np.ndarray, np.ndarray]],
                    scfg: SamplingConfig = SamplingConfig(), seed: int = 1,
                    pads: Optional[Tuple[int, int, int]] = None,
                    kv_dtype: Optional[str] = None, spec: int = 0,
                    mesh=None, seeds: Optional[Sequence[int]] = None,
                    stats: Optional[dict] = None
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Decode (x_tokens [Lx], y_codes [K, T]) TTS requests in one lockstep
    wave on the model's device.

    ``seeds``: one seed per request (lane b keyed on (seeds[b], b)), else
    ``seed`` for all.  ``pads`` = (x_pad, y_pad, gen_max) fixes the
    geometry; by default x_pad and y_pad round the longest text and prompt
    up to 32 and 64, and gen_max the longest length cap up to 128.
    ``kv_dtype="float8_e4m3fn"`` stores the slab in fp8.  ``spec`` = tau
    > 1 decodes speculatively (make_spec_serving_loop; the model needs tau
    - 1 MTP head groups).  ``mesh`` (parallel.mesh.Mesh; every rank of it
    makes the same call, with a model sharded by ``shard_params`` or a
    replicated one) shards the lanes over its 'data' axis (B % n_data ==
    0) and, with a sharded model, each lane's heads and FFN columns over
    'model'; every rank returns the whole wave's results.  ``stats``
    receives frames (rows recorded over all lanes),
    seconds (the wave's wall time through the host readback), spec,
    tok_per_pass (speculative: mean rows per lane per pass), steps
    (forwards or passes) and done (per lane: finished, else stopped by the
    budget).

    Returns [(full_codes [K, T + Tg], generated [K, Tg])] per request, as
    inference_tts returns them.
    """
    cfg = model.cfg
    K, B = cfg.n_codebooks, len(requests)
    shift = cfg.n_special if cfg.special_first else 0
    (x_pad, y_pad, gen_max), args = tts_wave_inputs(model, requests, pads)
    args += (_seeds(seed, seeds, B),)
    Bl = len(range(B)[data_slice(B, mesh)])

    t0 = time.perf_counter()
    if spec > 1:
        check_mtp_heads(model, spec, scfg)
        loop = make_spec_serving_loop(cfg, batch_size=Bl, n_draft=spec,
                                      x_pad=x_pad, y_pad=y_pad,
                                      gen_max=gen_max, scfg=scfg,
                                      kv_dtype=kv_dtype)
    else:
        loop = make_serving_tts_loop(cfg, batch_size=Bl, x_pad=x_pad,
                                     y_pad=y_pad, gen_max=gen_max, scfg=scfg,
                                     kv_dtype=kv_dtype)
    res = _wave_on_mesh(loop, model, args, mesh)
    gen_buf = res.gen_buf.cpu().numpy()
    if stats is not None:
        stats.update(frames=int(sum(res.n_rows)),
                     seconds=time.perf_counter() - t0, spec=spec,
                     tok_per_pass=(float(np.mean(res.n_rows)) / res.steps
                                   if spec > 1 else None),
                     steps=res.steps, done=res.done)

    out = []
    for b, (_, y) in enumerate(requests):
        rows = gen_buf[:res.n_rows[b], b]                          # [n, K]
        gen = (np.zeros((K, 0), np.int32) if rows.shape[0] <= K
               else patterns.unshift_span(rows.T).astype(np.int32))
        # the model samples in the +n_special space when special_first
        gen = gen - shift
        out.append((np.concatenate([y, gen], axis=1), gen))
    return out


def edit_wave_inputs(model: VoiceCraft,
                     requests: Sequence[Tuple[np.ndarray, np.ndarray,
                                              Sequence[Tuple[int, int]]]],
                     pads: Optional[Tuple[int, int, int]] = None):
    """The padded wave of (x_tokens, y_codes, mask_intervals) editing
    requests, as serve_edit_batch builds it: ((x_pad, y_pad, gen_max),
    (x_tokens [B, x_pad], x_lens [B], y_prefix [B, K, y_pad], prefix_lens
    [B], mask_emb_idx [B, y_pad], queue_mask_ids [B, max_n_spans], n_spans
    [B])), the tensors on the model's device; make_serving_edit_loop's
    decode and make_spec_serving_edit_loop's take these, then the seeds."""
    cfg = model.cfg
    K, B = cfg.n_codebooks, len(requests)
    shift = cfg.n_special if cfg.special_first else 0
    comps, queue_ids_l, n_spans = [], [], []
    for x, y, intervals in requests:
        if len(intervals) < 1:
            raise ValueError("editing needs at least one mask span")
        check_codes(cfg, y)
        iv = sorted((int(s), int(e)) for s, e in intervals)
        prefix, qids = spans.compose_edit_prefix(y + shift, iv, cfg)
        comps.append(prefix)
        queue_ids_l.append(qids)
        n_spans.append(len(iv))
    x_lens = np.asarray([len(x) for x, _, _ in requests], np.int64)
    p_lens = np.asarray([c.length for c in comps], np.int64)
    n_spans = np.asarray(n_spans, np.int64)
    max_spans = cfg.max_n_spans
    if n_spans.max() > max_spans:
        raise ValueError(f"a request has {int(n_spans.max())} spans, more "
                         f"than max_n_spans {max_spans}")
    if pads is None:
        caps = [max(int(xl) * 10 - int(pl) + K + 8, 2 * K + 8)
                + 3 * (int(m) - 1)
                for xl, pl, m in zip(x_lens, p_lens, n_spans)]
        pads = (_ceil(int(x_lens.max()), 32), _ceil(int(p_lens.max()), 64),
                _ceil(max(caps), 128))
    x_pad, y_pad, _ = pads
    xt = np.full((B, x_pad), cfg.text_pad_token, np.int64)
    yt = np.full((B, K, y_pad), cfg.empty_token, np.int64)
    mi = np.full((B, y_pad), -1, np.int64)
    qm = np.zeros((B, max_spans), np.int64)
    for b, ((x, _, _), c, qids) in enumerate(zip(requests, comps,
                                                 queue_ids_l)):
        xt[b, :len(x)] = x
        yt[b, :, :c.length] = c.tokens
        mi[b, :c.length] = c.mask_emb_idx
        qm[b, :len(qids[:max_spans])] = qids[:max_spans]
    to = lambda a: torch.from_numpy(a).to(model.device)
    return pads, (to(xt), x_lens, to(yt), p_lens, to(mi), to(qm), n_spans)


def serve_edit_batch(model: VoiceCraft,
                     requests: Sequence[Tuple[np.ndarray, np.ndarray,
                                              Sequence[Tuple[int, int]]]],
                     scfg: SamplingConfig = SamplingConfig(), seed: int = 1,
                     pads: Optional[Tuple[int, int, int]] = None,
                     kv_dtype: Optional[str] = None, spec: int = 0,
                     mesh=None, seeds: Optional[Sequence[int]] = None,
                     stats: Optional[dict] = None) -> List[np.ndarray]:
    """Decode (x_tokens [Lx], y_codes [K, T], mask_intervals) editing
    requests in one lockstep wave on the model's device: each request has
    its own transcript, codes and 1 to max_n_spans spans.

    Each result has inference_edit's semantics: the kept frames verbatim,
    the generated spans spliced between them.  ``seeds`` / ``pads`` /
    ``kv_dtype`` / ``mesh`` / ``stats`` as in serve_tts_batch (the default
    gen_max is the longest per-request budget of run_decode's formula;
    ``stats`` also receives span_frames, each lane's generated frames per
    span, and its seconds include the splice);
    ``spec`` = tau >= 2 decodes speculatively
    (make_spec_serving_edit_loop).

    Returns [spliced_codes [K, T']] per request.
    """
    cfg = model.cfg
    K, B = cfg.n_codebooks, len(requests)
    shift = cfg.n_special if cfg.special_first else 0
    max_spans = cfg.max_n_spans
    (x_pad, y_pad, gen_max), args = edit_wave_inputs(model, requests, pads)
    args += (_seeds(seed, seeds, B),)
    Bl = len(range(B)[data_slice(B, mesh)])
    intervals_l = [sorted((int(s), int(e)) for s, e in iv)
                   for _, _, iv in requests]

    t0 = time.perf_counter()
    if spec > 1:
        check_mtp_heads(model, spec, scfg)
        loop = make_spec_serving_edit_loop(
            cfg, batch_size=Bl, n_draft=spec, x_pad=x_pad, y_pad=y_pad,
            gen_max=gen_max, scfg=scfg, max_spans=max_spans,
            kv_dtype=kv_dtype)
    else:
        loop = make_serving_edit_loop(cfg, batch_size=Bl, x_pad=x_pad,
                                      y_pad=y_pad, gen_max=gen_max, scfg=scfg,
                                      max_spans=max_spans, kv_dtype=kv_dtype)
    res = _wave_on_mesh(loop, model, args, mesh)
    gen_buf = res.gen_buf.cpu().numpy()
    span_buf = res.span_buf.cpu().numpy()
    out, span_frames = [], []
    for b, ((_, y, _), iv) in enumerate(zip(requests, intervals_l)):
        y = y + shift
        n = res.n_rows[b]
        rows, span_of = gen_buf[:n, b], span_buf[:n, b]
        gen_spans = []
        for j in range(len(iv)):
            rj = rows[span_of == j]
            gen_spans.append(np.zeros((K, 0), np.int32) if rj.shape[0] <= K
                             else patterns.unshift_span(rj.T).astype(np.int32))
        span_frames.append([g.shape[1] for g in gen_spans])
        # splice: kept segments verbatim, generated spans between them
        starts = [s for s, _ in iv]
        ends = [e for _, e in iv]
        non_mask = list(zip([0] + ends, starts + [y.shape[1]]))
        parts = []
        for j, (lo, hi) in enumerate(non_mask[:-1]):
            parts += [y[:, lo:hi], gen_spans[j]]
        lo, hi = non_mask[-1]
        parts.append(y[:, lo:hi])
        out.append(np.concatenate(parts, axis=1) - shift)
    if stats is not None:
        stats.update(frames=int(sum(res.n_rows)),
                     seconds=time.perf_counter() - t0, spec=spec,
                     tok_per_pass=(float(np.mean(res.n_rows)) / res.steps
                                   if spec > 1 else None),
                     steps=res.steps, done=res.done, span_frames=span_frames)
    return out
