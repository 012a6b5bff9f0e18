"""Continuous-batching TTS engine: lanes retire and refill mid-flight
(PyTorch port of voicecraft_tpu/inference/engine.py).

Lockstep serving (inference/serving.py) decodes a fixed wave: a long
request holds every lane.  This engine runs the decoder in bursts of
``burst`` steps; between bursts, finished lanes retire and queued requests
are prefilled into the freed lanes.

Lanes carry their own step counters, but the KV slab's generated region is
a RING indexed by one global step clock: every lane writes its token's k/v
at ring slot (gstep mod W) of its own batch row, so a step writes the slab
once, at one uniform index, as lockstep serving does, and each lane's
history is index arithmetic (ops.attention.decode_attention_ring: slot age
<= the lane's step count; an fp8 slab is read in place by the kernel of
ops/ring_attention.py).  Per-lane slab layout:

    [ text 0..x_len_b | pad .. x_pad | prompt 0..prefix_len_b | pad .. y_pad |
      ring of W generated slots, valid where age <= t_b ]

A burst enqueues its steps with no host sync; the host reads one [B, 4]
status (active, t, finish_t, all-eog) and the recorded rows per burst, and
with the status the caller's cancel flag (``cancel``), so that every rank
of a mesh stops at the same burst.  The
speculative engine (``spec`` = tau) keeps each lane's accepted tokens
COMPACT at its own offset instead of a ring (transformer.
decode_step_multi_block), and runs burst // tau verified passes a burst.

Sampled noise is keyed on the admission, not the lane: the plain engine's
lane b draws from its generator, re-seeded at admission from (seed, admit
id of its request); the speculative engine's draws of token i from (seed,
admit id, i, salt) (spec_common.token_generators).  A request's sampled
output is then independent of its lane, of refill timing, of the drain
policy and (speculative) of tau.

Every write lies inside the slab and the row buffer (a torch index out of
range raises, where JAX drops it): the ring slot is y_start + (gstep mod W)
< S_max; the plain engine's t stays <= gen_max - 1 < W; a speculative lane
accepts token i only while t_b + i < gen_max - 1, so its block [t_b, t_b +
tau) ends before gen_max + tau, the slab's generated slots and the row
buffer's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..data import spans
from ..models import deepseek_v2 as dsv2
from ..models import kimi_linear as kimi
from ..models import transformer as trm
from ..models.voicecraft import (MAX_POS, SamplingConfig, VoiceCraft,
                                 apply_heads, cache_slots, check_mtp_heads,
                                 embed_audio_tokens, new_kv_cache,
                                 prefill_lanes, store_lanes)
from ..ops import graphs, patterns
from ..ops.attention import _attend_one, _ring_valid
from ..ops.ring_attention import ring_decode_attention
from ..parallel.mesh import all_gather_data, data_slice, stack_ranks
from ..utils import tracing
from .serving import _step_feed
from .spec_common import (generator_seed, make_lane_sampler,
                          spec_verify_pass, token_generators)


@dataclasses.dataclass
class LaneState:
    """The engine's per-lane state, device tensors ([B] unless noted)."""
    active: torch.Tensor        # bool: the lane holds a request
    t: torch.Tensor             # generated steps so far (rows recorded)
    x_lens: torch.Tensor
    prefix_lens: torch.Tensor
    codebook_eog: torch.Tensor  # [B, K] bool
    consec: torch.Tensor
    prev: torch.Tensor
    finish_t: torch.Tensor      # -1 until the eog cascade completes
    logits: torch.Tensor        # [B, K, card] f32: next-slot predictions
    h: torch.Tensor             # [B, D] f32: last hidden (MTP drafts)
    admit_id: torch.Tensor      # the request id that keys the lane's noise
    pending: torch.Tensor       # [B, K] stochastic-spec corrected token
    has_pending: torch.Tensor   # bool
    gstep: torch.Tensor         # 0-d: global steps taken (the ring clock)


def _empty_lanes(B: int, K: int, card: int, D: int, device) -> LaneState:
    long = lambda v: torch.full((B,), v, dtype=torch.long, device=device)
    false = lambda *s: torch.zeros((B, *s), dtype=torch.bool, device=device)
    return LaneState(
        active=false(), t=long(0), x_lens=long(1), prefix_lens=long(1),
        codebook_eog=false(K), consec=long(0), prev=long(-1),
        finish_t=long(-1),
        logits=torch.zeros((B, K, card), dtype=torch.float32, device=device),
        h=torch.zeros((B, D), dtype=torch.float32, device=device),
        admit_id=long(0),
        pending=torch.zeros((B, K), dtype=torch.long, device=device),
        has_pending=false(),
        gstep=torch.zeros((), dtype=torch.long, device=device))


def _status(s: LaneState) -> torch.Tensor:
    """[B, 4]: active, t, finish_t, all codebooks at eog."""
    return torch.stack([s.active.long(), s.t, s.finish_t,
                        s.codebook_eog.all(dim=1).long()], dim=1)


def reads_fp8_slab(cache: torch.Tensor) -> bool:
    """Whether the plain engine's step for VoiceCraft's block reads its
    slab through the ring kernel (ops/ring_attention.py): an fp8 slab."""
    return cache.dtype == torch.float8_e4m3fn


def _lane_decode_step(decoder: trm.Decoder, x_t: torch.Tensor,
                      cache: torch.Tensor, x_lens, x_pad: int, prefix_lens,
                      y_start: int, W: int, gstep, t_lane,
                      parts: Optional[dsv2.StepGraphs] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One burst step against the ring slab: the decoder's layer stack
    (transformer._layer_stack, unfused FFN) reading the slab read-only
    through the ring attention, then ONE write of every layer's k/v at ring
    slot y_start + (gstep mod W).  An fp8 slab (:func:`reads_fp8_slab`)
    goes to ops/ring_attention.py:ring_decode_attention as the layer's
    views, which the kernel reads in place (its plain version on the CPU);
    any other slab reaches ``_attend_one`` in q's dtype, under a ring mask
    built once a step (the same in every layer).  A DeepSeek-V2 decoder
    takes its own step on its latent slab (models/deepseek_v2.py:
    lane_decode_step, through ``parts``), a Kimi Linear decoder its own on
    its hybrid cache (models/kimi_linear.py:lane_decode_step, likewise),
    chosen once for the whole stack.  Returns (final-normed hidden [B, 1,
    D], cache)."""
    if isinstance(decoder, dsv2.Decoder):
        return dsv2.lane_decode_step(decoder, x_t, cache, x_lens, x_pad,
                                     prefix_lens, y_start, W, gstep, t_lane,
                                     parts)
    if isinstance(decoder, kimi.Decoder):
        return kimi.lane_decode_step(decoder, x_t, cache, x_lens, x_pad,
                                     prefix_lens, y_start, W, gstep, t_lane,
                                     parts)
    if reads_fp8_slab(cache):
        h, kv = trm._layer_stack(
            decoder, x_t, cache,
            lambda q, ks, vs, kn, vn: ring_decode_attention(
                q, ks, vs, kn, vn, x_lens, x_pad, prefix_lens, y_start, W,
                gstep, t_lane), raw_slab=True)
    else:
        valid = _ring_valid(cache.shape[3], x_lens, x_pad, prefix_lens,
                            y_start, W, gstep, t_lane, x_t.device)
        h, kv = trm._layer_stack(
            decoder, x_t, cache,
            lambda q, ks, vs, kn, vn: _attend_one(q, ks, vs, valid, kn, vn))
    trm._store_kv(cache, 3, (y_start + torch.remainder(gstep, W)).view(1), kv)
    return h, cache


def make_burst_fn(cfg: ModelConfig, *, batch_size: int, x_pad: int,
                  y_pad: int, gen_max: int, burst: int,
                  scfg: SamplingConfig):
    """``burst`` decode steps for all lanes, enqueued with no host sync.

    Each step samples every lane (the vectorised sampler; lane b's noise
    from gens[b]), gates the lanes that are empty or finished (they emit
    empty rows and keep their state), records each live lane's row at its
    own count t_b (below the gen_max - 1 cap), feeds the samples through one
    _lane_decode_step and advances live lanes' t to min(t + 1, gen_max -
    1).  A frozen lane keeps writing its ring slot; only its own row reads
    it, and its samples and logits are discarded.  A step writes the
    lanes' tensors, the slab and the row buffer in place.

    Where ops/graphs.py:step_graph_engages (a CUDA model, its decoder not
    split over 'model') and the block is VoiceCraft's, the step runs
    through one ops/graphs.py:StepReplay for the function's life: the
    first step runs eagerly, the second is captured, with every lane's
    generator registered, and replayed, and every later step of every
    burst replays it.  So the function is bound to the model and state of
    its first call (the slab, the lanes' tensors, the row buffer and the
    generators: one batcher's, fixed for its life).  DeepSeek-V2's and
    Kimi Linear's blocks step eagerly around their stack's per-part
    replays (deepseek_v2.StepGraphs, held as long: a capture cannot hold
    those graphs, and the parts' spans would go).

    Returns fn(model, cache, lanes, gen_buf [B, gen_max, K], gens) -> (cache,
    lanes, gen_buf, status [B, 4], steps replayed from the graph), the
    first three updated in place; gens: one generator per lane, or None
    when greedy.
    """
    K, B = cfg.n_codebooks, batch_size
    cap_mult = cfg.encodec_sr // 5
    y_start = x_pad + y_pad
    sample_lanes = make_lane_sampler(cfg, scfg, cap_mult)
    bound = {}      # made at the first call, kept for the function's life

    def step(model: VoiceCraft, cache: torch.Tensor, s: LaneState,
             gen_buf: torch.Tensor, gens, lanes, empty, parts) -> None:
        W = cache_slots(cfg, cache) - y_start   # ring width (> gen_max - 1)
        y_pos = s.prefix_lens + s.t
        samples, new_eog, consec, prev = sample_lanes(
            gens, s.logits, s.codebook_eog, s.t, s.consec, s.prev, y_pos,
            s.x_lens)
        live = s.active & ~s.codebook_eog.all(dim=1)
        samples = torch.where(live[:, None], samples, empty)
        new_eog = torch.where(live[:, None], new_eog, s.codebook_eog)
        s.consec.copy_(torch.where(live, consec, s.consec))
        s.prev.copy_(torch.where(live, prev, s.prev))
        s.finish_t.copy_(torch.where(new_eog.all(dim=1) & live, s.t,
                                     s.finish_t))
        s.codebook_eog.copy_(new_eog)
        # a live lane's row t; at the cap t stops advancing and the row is
        # not kept (the JAX burst's flush keep-mask)
        row = s.t.clamp(max=gen_max - 1)
        keep = live & (s.t < gen_max - 1)
        gen_buf[lanes, row] = torch.where(keep[:, None], samples,
                                          gen_buf[lanes, row])
        emb = embed_audio_tokens(model.audio_emb,
                                 samples[:, :, None])[:, 0].to(model.dtype)
        h, _ = _lane_decode_step(
            model.decoder,
            _step_feed(model, emb, y_pos.clamp(max=MAX_POS - 1)), cache,
            s.x_lens, x_pad, s.prefix_lens, y_start, W, s.gstep, s.t,
            parts=parts)
        logits = apply_heads(model.heads, h[:, 0])
        s.logits.copy_(torch.where(live[:, None, None], logits, s.logits))
        s.t.copy_(torch.where(live, (s.t + 1).clamp(max=gen_max - 1), s.t))
        s.gstep.add_(1)

    @torch.inference_mode()
    def burst_fn(model: VoiceCraft, cache: torch.Tensor, s: LaneState,
                 gen_buf: torch.Tensor, gens):
        dev = model.device
        if not bound:
            engaged = graphs.step_graph_engages(model)
            per_part = engaged and isinstance(model.decoder,
                                              (dsv2.Decoder, kimi.Decoder))
            bound.update(
                lanes=torch.arange(B, device=dev),
                empty=torch.full((B, K), cfg.empty_token, dtype=torch.long,
                                 device=dev),
                replay=graphs.StepReplay(dev, gens or (),
                                         engaged=engaged and not per_part),
                parts=dsv2.StepGraphs() if per_part else None)
        replay = bound["replay"]
        run = lambda: step(model, cache, s, gen_buf, gens, bound["lanes"],
                           bound["empty"], bound["parts"])
        replayed = 0
        for _ in range(burst):
            replay(run)
            replayed += replay.graph is not None
        return cache, s, gen_buf, _status(s), replayed

    return burst_fn


def make_spec_burst_fn(cfg: ModelConfig, *, batch_size: int, n_draft: int,
                       x_pad: int, y_pad: int, gen_max: int, burst: int,
                       scfg: SamplingConfig, force_accept: bool = False):
    """The speculative burst: burst // tau verified tau-token passes for
    all lanes (spec_common.spec_verify_pass over decode_step_multi_block,
    each lane's block at its own compact offset y_start + t_b).  A lane
    takes part while it is active, not finished and under the gen_max - 1
    row cap, so capped lanes retire with the plain engine's row counts.
    Greedy passes enqueue with no host sync; sampled ones read the lanes'
    token counts once a pass (the draws of token t_b + i are keyed on it).

    Returns fn(model, cache, lanes, gen_buf [B, gen_max + tau, K], gens) ->
    (cache, lanes, gen_buf, status [B, 4], 0: no pass is replayed from a
    graph); gens: the token generators (spec_common.token_generators keyed
    on the lanes' admissions).
    """
    tau, B = n_draft, batch_size
    cap_mult = cfg.encodec_sr // 5
    y_start = x_pad + y_pad
    passes = max(1, burst // tau)
    sample_lanes = make_lane_sampler(cfg, scfg, cap_mult)

    @torch.inference_mode()
    def burst_fn(model: VoiceCraft, cache: torch.Tensor, s: LaneState,
                 gen_buf: torch.Tensor, gens):
        dev = model.device
        lanes = torch.arange(B, device=dev)[:, None]
        slots = torch.arange(tau, device=dev)[None, :]
        for _ in range(passes):
            live = (s.active & ~s.codebook_eog.all(dim=1)
                    & (s.t < gen_max - 1))
            t_host = s.t.tolist() if scfg.temperature > 0 else [0] * B

            def forward(feed, t=s.t):
                return trm.decode_step_multi_block(
                    model.decoder, feed, cache, y_start + t, s.x_lens, x_pad,
                    s.prefix_lens, y_start, gen_lens=t)[0]

            out = spec_verify_pass(
                model, cfg, sample_lanes, tau=tau, gate=live,
                tok_gen=lambda i, salt, th=t_host: gens([n + i for n in th],
                                                        salt),
                y_pos0=(s.prefix_lens + s.t).clamp(max=MAX_POS - tau - 1),
                x_lens=s.x_lens, logits=s.logits, h=s.h, eog=s.codebook_eog,
                cng=s.t, consec=s.consec, prev=s.prev, t=s.t,
                accept_cap=gen_max - 1, forward=forward,
                force_accept=force_accept, scfg=scfg, is_tts=True,
                cap_mult=cap_mult, pending=s.pending,
                has_pending=s.has_pending)
            # frozen lanes write their (empty) block at rows >= t, which
            # retirement and streaming never read
            gen_buf[lanes, s.t[:, None] + slots] = out["blk"]
            t_new = s.t + out["n_acc"]
            s.finish_t = torch.where(live & out["eog"].all(dim=1), t_new - 1,
                                     s.finish_t)
            s.t = t_new
            s.codebook_eog, s.consec, s.prev = (out["eog"], out["consec"],
                                                out["prev"])
            s.logits, s.h = out["logits_next"], out["h_next"]
            s.pending, s.has_pending = out["pending"], out["has_pending"]
            s.gstep = s.gstep + 1
        return cache, s, gen_buf, _status(s), 0

    return burst_fn


def make_prefill_batch_fn(cfg: ModelConfig, *, x_pad: int, y_pad: int,
                          kv_dtype: Optional[str] = None):
    """Prefill a WAVE of admissions in one forward.

    fn(model, cache, lanes, idx [n] (the admitted lanes), x_tokens [n,
    x_pad], x_lens [n], y_prefix [n, K, y_pad], prefix_lens [n], admit_ids
    [n]) -> (cache, lanes), both updated in place.  Only the admitted lanes
    are computed ([n, x_pad + y_pad] through models.voicecraft.
    prefill_lanes: the attention kernel from 1024 columns) and only their
    rows of the slab's prefix region are written, through the uint8 views
    for an fp8 slab, with every other part of their cache (a hybrid
    cache's KDA and convolution states: models.voicecraft.store_lanes);
    their generated region needs no reset, since a lane at t = 0 reads
    none of it.  The admitted lanes' state is reset as a new request's.
    """
    Sp = x_pad + y_pad

    @torch.inference_mode()
    def prefill(model: VoiceCraft, cache: torch.Tensor, s: LaneState, idx,
                x_tokens, x_lens, y_prefix, prefix_lens, admit_ids):
        dev = model.device
        idx = torch.as_tensor(idx, device=dev).long()
        xl = torch.as_tensor(x_lens, device=dev).to(torch.int32)
        pl = torch.as_tensor(prefix_lens, device=dev).to(torch.int32)
        no_mask = torch.full((1, y_pad), -1, dtype=torch.long, device=dev)
        h_last, logits0, new = prefill_lanes(
            model, torch.as_tensor(x_tokens, device=dev).long(), xl,
            torch.as_tensor(y_prefix, device=dev).long(), pl, no_mask, Sp,
            kv_dtype)
        store_lanes(cfg, cache, idx, new)
        s.active[idx] = True
        s.t[idx] = 0
        s.x_lens[idx] = xl.long()
        s.prefix_lens[idx] = pl.long()
        s.codebook_eog[idx] = False
        s.consec[idx] = 0
        s.prev[idx] = -1
        s.finish_t[idx] = -1
        s.logits[idx] = logits0
        s.h[idx] = h_last.float()
        s.admit_id[idx] = torch.as_tensor(admit_ids, device=dev).long()
        s.pending[idx] = 0
        s.has_pending[idx] = False
        return cache, s

    return prefill


def make_prefill_lane_fn(cfg: ModelConfig, *, x_pad: int, y_pad: int,
                         kv_dtype: Optional[str] = None):
    """Prefill ONE lane (a mid-flight refill): the wave prefill at n = 1,
    a [1, x_pad + y_pad] forward that writes one lane's prefix rows.

    fn(model, cache, lanes, lane, x_tokens [1, x_pad], x_len, y_prefix
    [1, K, y_pad], prefix_len, admit_id) -> (cache, lanes)."""
    wave = make_prefill_batch_fn(cfg, x_pad=x_pad, y_pad=y_pad,
                                 kv_dtype=kv_dtype)

    def prefill(model, cache, s, lane: int, x_tokens, x_len: int, y_prefix,
                prefix_len: int, admit_id: int):
        return wave(model, cache, s, [lane], x_tokens, [x_len], y_prefix,
                    [prefix_len], [admit_id])

    return prefill


class StreamCancelled(Exception):
    """Raised by ContinuousBatcher.run at the burst whose snapshot carries a
    set cancel flag (on every rank of a mesh at the same burst)."""


class _Snapshot:
    """One burst's status [lanes, 5] (the [B, 4] status of every lane and,
    in column 4, the cancel flag) and recorded rows, copied to the host
    after the burst on the device's stream (pinned buffers, non_blocking,
    and an event to wait on, on CUDA), with the lane -> request map at the
    burst's dispatch."""

    def __init__(self, status: torch.Tensor, gen_buf: torch.Tensor):
        cuda = status.device.type == "cuda"
        self.status = torch.empty(status.shape, dtype=status.dtype,
                                  pin_memory=cuda)
        self.gen = torch.empty(gen_buf.shape, dtype=gen_buf.dtype,
                               pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None
        self.lane_map: List[Optional[int]] = []

    def take(self, status, gen_buf, lane_map) -> "_Snapshot":
        self.status.copy_(status, non_blocking=True)
        self.gen.copy_(gen_buf, non_blocking=True)
        if self.event is not None:
            self.event.record()
        self.lane_map = list(lane_map)
        return self

    def read(self) -> Tuple[np.ndarray, np.ndarray, bool]:
        """(status [lanes, 4], rows, whether any rank's flag was set)."""
        if self.event is not None:
            self.event.synchronize()
        status = self.status.numpy()
        return status[:, :4], self.gen.numpy(), bool(status[:, 4].any())


@dataclasses.dataclass
class ContinuousBatcher:
    """Host-side orchestrator: admits requests into free lanes between
    bursts.

    Usage::

        eng = ContinuousBatcher(model, lanes=8)
        ids = [eng.submit(x_tokens, y_codes) for ...]
        results = eng.run()          # {id: (full_codes, gen_codes)}

    A request submitted with ``on_rows`` streams: after every burst the
    engine calls ``on_rows(rows)`` with the lane's delayed-space rows so far
    ([t, K], monotone and prefix-stable; inference/streaming.py turns them
    into frames and audio).  While a streaming request is in flight the
    loop runs one burst ahead of the host (``pipeline``): burst N + 1 is
    enqueued before burst N's snapshot is read, so the readback and the
    callbacks overlap the device's work, at the cost of one burst of
    retirement staleness.  ``pipeline=False`` reads each burst before the
    next (same outputs).

    ``kv_dtype="float8_e4m3fn"`` stores the slab in fp8.  ``spec`` = tau > 1
    decodes speculatively (the model needs tau - 1 MTP head groups);
    ``spec_force_accept`` (measurement) accepts every draft.

    ``mesh`` (parallel.mesh.Mesh; every rank builds the same batcher, with
    a model sharded by ``shard_params`` or a replicated one, and makes the
    same calls) shards the lanes over its 'data' axis (lanes % n_data ==
    0): the device state (LaneState, the slab, the row buffer) of lanes
    [d * lanes / n_data, (d + 1) * lanes / n_data) lives on data rank d,
    while the host scheduler (admission, retirement, the refill decisions)
    is replicated on every rank over the global lanes: each burst's
    status and rows are all-gathered over 'data' before the host reads
    them, so every rank takes the same decisions.

    ``cancel`` (a threading.Event, or None) is the consumer's flag: its
    state when a burst is enqueued rides in that burst's status, which a
    mesh all-gathers over every rank (the one collective each burst makes
    on every rank, whatever the mesh's shape), and :meth:`run` raises
    :class:`StreamCancelled` when it reads a snapshot whose flag is set on
    any rank.  So every rank stops at the same burst, however many of them
    see the consumer; the batcher is not reused after.  ``stats`` counts
    bursts, device steps (speculative: passes), wave prefills, lane
    refills and the steps replayed from the step's CUDA graph
    (``graph_steps``; :func:`make_burst_fn`) over the batcher's life.
    """

    model: VoiceCraft
    lanes: int = 8
    x_pad: int = 128
    y_pad: int = 192
    gen_max: int = 768
    # retirement-detection granularity, in generated TOKENS for every mode
    # (a speculative engine runs burst // spec passes a burst)
    burst: int = 48
    scfg: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    seed: int = 1
    kv_dtype: Optional[str] = None
    spec: int = 0
    spec_force_accept: bool = False
    mesh: object = None
    pipeline: bool = True
    cancel: object = None

    def __post_init__(self):
        model, cfg = self.model, self.cfg
        K, dev = cfg.n_codebooks, self.model.device
        # this data rank's lanes [lo, lo + B)
        sl = data_slice(self.lanes, self.mesh)
        self._lo, B = sl.start, sl.stop - sl.start
        geom = dict(x_pad=self.x_pad, y_pad=self.y_pad, gen_max=self.gen_max,
                    burst=self.burst, scfg=self.scfg)
        if self.spec > 1:
            check_mtp_heads(model, self.spec,
                            None if self.spec_force_accept else self.scfg)
            # compact per-lane offsets: one block of slack, not a ring
            s_max = self.x_pad + self.y_pad + self.gen_max + self.spec
            self._burst = make_spec_burst_fn(
                cfg, batch_size=B, n_draft=self.spec,
                force_accept=self.spec_force_accept, **geom)
            self._burst_steps = max(1, self.burst // self.spec)
        else:
            # ring width W = gen_max + burst > gen_max - 1 >= every live t
            s_max = self.x_pad + self.y_pad + self.gen_max + self.burst
            self._burst = make_burst_fn(cfg, batch_size=B, **geom)
            self._burst_steps = self.burst
        pads = dict(x_pad=self.x_pad, y_pad=self.y_pad, kv_dtype=self.kv_dtype)
        self._prefill = make_prefill_batch_fn(cfg, **pads)
        self._prefill_lane = make_prefill_lane_fn(cfg, **pads)
        self._cache = new_kv_cache(model, B, s_max, self.kv_dtype)
        self._lanes = _empty_lanes(B, K, cfg.card, cfg.d_model, dev)
        rows = (self.gen_max + max(self.spec, 0), K)
        self._gen_buf = torch.zeros((B,) + rows, dtype=torch.long, device=dev)
        # the plain engine's sampled noise: one generator a lane for the
        # batcher's life (a CUDA graph of the step draws from these),
        # re-seeded at each admission; an empty lane's draws are discarded
        self._gens: List[torch.Generator] = [
            torch.Generator(device=dev).manual_seed(self.seed)
            for _ in range(B)]
        # the host reads every lane's status, the cancel flag and the rows
        self._snaps = [_Snapshot(
            torch.empty((self.lanes, 5), dtype=torch.long, device=dev),
            torch.empty((self.lanes,) + rows, dtype=torch.long, device=dev))
            for _ in range(2)]
        self._n_snap = 0
        self._queue: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self._lane_req: List[Optional[int]] = [None] * self.lanes
        self._retired: set = set()
        self._req_y: Dict[int, np.ndarray] = {}
        self._results: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._stream_cbs: Dict[int, Callable] = {}
        self._stream_sent: Dict[int, int] = {}
        self._next_id = 0
        self.stats = dict(bursts=0, steps=0, waves=0, refills=0,
                          graph_steps=0)
        self._source = tracing.new_source()

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    def submit(self, x_tokens: np.ndarray, y_codes: np.ndarray,
               on_rows: Optional[Callable] = None) -> int:
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, np.asarray(x_tokens, np.int64),
                            np.asarray(y_codes, np.int64)))
        self._req_y[rid] = np.asarray(y_codes, np.int32)
        if on_rows is not None:
            self._stream_cbs[rid] = on_rows
            self._stream_sent[rid] = 0
        return rid

    # ---- internals -----------------------------------------------------------

    def _local(self, b: int) -> Optional[int]:
        """Global lane b's index in this rank's device state, or None."""
        i = b - self._lo
        return i if 0 <= i < self._gen_buf.shape[0] else None

    def _admit(self) -> None:
        """Admit queued requests into free lanes: a wave of more than half
        the lanes (in practice the startup wave) as ONE prefill forward
        (over a mesh, each data rank's forward over its lanes of it), fewer
        as single-lane refills (each on the data rank that holds the
        lane)."""
        cfg = self.cfg
        K = cfg.n_codebooks
        shift = cfg.n_special if cfg.special_first else 0
        pending = []      # (lane, rid, x, prefix)
        for b in range(self.lanes):
            # occupancy is tracked on the host (_lane_req): no device read
            if self._lane_req[b] is not None or not self._queue:
                continue
            rid, x, y = self._queue.pop(0)
            prefix = spans.compose_tts_prefix(y + shift, cfg)
            if len(x) > self.x_pad or prefix.length > self.y_pad:
                raise ValueError(
                    f"request {rid}: {len(x)} text tokens and a prefix of "
                    f"{prefix.length} columns exceed x_pad {self.x_pad} / "
                    f"y_pad {self.y_pad}")
            pending.append((b, rid, x, prefix))
        if not pending:
            return
        t_admit = tracing.counter_ns()
        n = len(pending)
        xt = np.full((n, self.x_pad), cfg.text_pad_token, np.int64)
        yt = np.full((n, K, self.y_pad), cfg.empty_token, np.int64)
        for i, (_, _, x, prefix) in enumerate(pending):
            xt[i, :len(x)] = x
            yt[i, :, :prefix.length] = prefix.tokens
        mine = [i for i, p in enumerate(pending)
                if self._local(p[0]) is not None]
        if n > self.lanes // 2:
            if mine:
                self._cache, self._lanes = self._prefill(
                    self.model, self._cache, self._lanes,
                    [self._local(pending[i][0]) for i in mine], xt[mine],
                    [len(pending[i][2]) for i in mine], yt[mine],
                    [pending[i][3].length for i in mine],
                    [pending[i][1] for i in mine])
            self.stats["waves"] += 1
        else:
            for i, (b, rid, x, prefix) in enumerate(pending):
                if i in mine:
                    self._cache, self._lanes = self._prefill_lane(
                        self.model, self._cache, self._lanes, self._local(b),
                        xt[i:i + 1], len(x), yt[i:i + 1], prefix.length, rid)
                self.stats["refills"] += 1
        for b, rid, _, _ in pending:
            self._lane_req[b] = rid
            tracing.mark_request(self._source, rid, "admit", t_admit)
            if (self.spec <= 1 and self.scfg.temperature > 0
                    and self._local(b) is not None):
                # in place: the stream of a fresh seeded_generator((seed,
                # rid)), from the generator the step's graph registered
                self._gens[self._local(b)].manual_seed(
                    generator_seed((self.seed, rid)))

    def _dispatch_burst(self) -> _Snapshot:
        """Enqueue one burst and the copy of its snapshot; no host sync
        (sampled speculative passes excepted)."""
        B = self._gen_buf.shape[0]
        if self.spec > 1:
            gens = token_generators(
                self.scfg, self.seed, self.model.device, lanes=B,
                lane_ids=[0 if r is None else r
                          for r in self._lane_req[self._lo:self._lo + B]])
        else:
            gens = self._gens if self.scfg.temperature > 0 else None
        self._cache, self._lanes, self._gen_buf, status, replayed = \
            self._burst(self.model, self._cache, self._lanes, self._gen_buf,
                        gens)
        self.stats["bursts"] += 1
        self.stats["steps"] += self._burst_steps
        self.stats["graph_steps"] += replayed
        flag = int(self.cancel is not None and self.cancel.is_set())
        status = torch.cat([status, status.new_full((B, 1), flag)], 1)
        gen_buf = self._gen_buf
        mesh = self.mesh
        if mesh is not None and mesh.n_data * mesh.n_model > 1:
            # every rank's status and flag: the lanes of each data rank
            # from its model rank 0, the flag set if any rank's is
            every = stack_ranks(status, mesh).view(mesh.n_data,
                                                    mesh.n_model, B, 5)
            status = torch.cat([every[:, 0, :, :4].reshape(-1, 4),
                                every[..., 4].amax().expand(self.lanes, 1)],
                               1)
            if mesh.n_data > 1:
                gen_buf = all_gather_data(gen_buf, mesh, 0)
        snap = self._snaps[self._n_snap % 2]
        self._n_snap += 1
        return snap.take(status, gen_buf, self._lane_req)

    def _retire(self, status: np.ndarray, gen_src: np.ndarray,
                lane_map: Sequence[Optional[int]]) -> None:
        """Retire finished lanes from ONE consistent burst snapshot.  With
        the streaming pipeline the snapshot is one burst behind the device,
        so a rid may already be retired (skipped) and a lane may already
        hold a newer request (freed only if it still holds the snapshot's)."""
        active, t, finish_t, eog_all = status.T
        cfg = self.cfg
        for b in range(self.lanes):
            rid = lane_map[b]
            if rid is None or rid in self._retired or not active[b]:
                continue
            if not (eog_all[b] or t[b] >= self.gen_max - 1):
                continue
            # t counts the rows written: [0, t) (a capped lane's row t was
            # never kept); a finished lane's rows end at its cascade
            n = int(finish_t[b]) + 1 if finish_t[b] >= 0 else int(t[b])
            rows = gen_src[b, :n]
            if rows.shape[0] <= cfg.n_codebooks:
                gen = np.zeros((cfg.n_codebooks, 0), np.int32)
            else:
                gen = patterns.unshift_span(rows.T).astype(np.int32)
            # gen is in the +n_special sampling space when special_first;
            # unshift it BEFORE concatenating the caller's raw prompt
            if cfg.special_first:
                gen = gen - cfg.n_special
            self._results[rid] = (np.concatenate([self._req_y[rid], gen],
                                                 axis=1), gen)
            self._retired.add(rid)
            tracing.mark_request(self._source, rid, "retire")
            self._stream_cbs.pop(rid, None)
            self._stream_sent.pop(rid, None)
            if self._lane_req[b] == rid:
                self._lane_req[b] = None
                if self._local(b) is not None:
                    self._lanes.active[self._local(b)] = False

    def _emit_stream(self, status: np.ndarray, gen_src: np.ndarray,
                     lane_map: Sequence[Optional[int]]) -> None:
        """Call each live streaming request's on_rows with its rows so far,
        capped at the retirement row count (rows past the eog cascade are
        frozen-lane noise), so streamed rows are a prefix of the result."""
        t, finish_t = status[:, 1], status[:, 2]
        K = self.cfg.n_codebooks
        for b in range(self.lanes):
            rid = lane_map[b]
            if rid is None or rid not in self._stream_cbs:
                continue
            n = int(t[b]) if finish_t[b] < 0 else min(int(t[b]),
                                                      int(finish_t[b]) + 1)
            if n <= self._stream_sent[rid]:
                continue
            if self._stream_sent[rid] < K <= n:
                # the first rows that complete a frame
                tracing.mark_request(self._source, rid, "first_rows")
            self._stream_sent[rid] = n
            # a copy: the snapshot's buffer is reused two bursts later
            self._stream_cbs[rid](gen_src[b, :n].astype(np.int32))

    def _process_burst(self, snap: _Snapshot) -> int:
        """The host's side of one finished burst: waiting for its snapshot
        is what blocks on the device.  Returns the host ns of that wait."""
        t0 = tracing.counter_ns()
        status, gen_src, cancelled = snap.read()
        wait_ns = tracing.counter_ns() - t0
        if cancelled:
            raise StreamCancelled()
        self._emit_stream(status, gen_src, snap.lane_map)
        self._retire(status, gen_src, snap.lane_map)
        return wait_ns

    def run(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """Drain the queue; returns {request_id: (full_codes, gen_codes)}.

        Each loop admits into free lanes, enqueues a burst and reads its
        snapshot (the JAX engine's device-side drain becomes this host check
        per burst; outputs do not depend on it).  While a streaming request
        is in flight with ``pipeline``, a burst's snapshot is read after the
        NEXT burst is enqueued.  Each pass of the loop is counted
        (utils.tracing.Burst)."""
        pending = None        # the in-flight burst's snapshot
        while self._queue or any(r is not None for r in self._lane_req):
            t0, before = tracing.counter_ns(), dict(self.stats)
            self._admit()
            admit_ns, wait_ns = tracing.counter_ns() - t0, 0
            streaming = any(rid in self._stream_cbs
                            for rid in self._lane_req + [q[0] for q in
                                                         self._queue]
                            if rid is not None)
            snap = self._dispatch_burst()
            if streaming and self.pipeline:
                if pending is not None:      # overlaps the burst
                    wait_ns = self._process_burst(pending)
                pending = snap
            else:
                if pending is not None:
                    wait_ns = self._process_burst(pending)
                    pending = None
                wait_ns += self._process_burst(snap)
            grew = {k: self.stats[k] - before[k]
                    for k in ("refills", "steps", "graph_steps")}
            tracing.record_burst(tracing.Burst(
                self._source, t0, tracing.counter_ns(), admit_ns, wait_ns,
                **grew))
        if pending is not None:
            self._process_burst(pending)
        out, self._results = self._results, {}
        # nothing in flight references earlier rids any more
        self._retired.clear()
        return out
