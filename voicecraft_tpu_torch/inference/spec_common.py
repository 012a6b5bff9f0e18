"""The one verify core of verified speculative decoding over B lanes
(PyTorch port of voicecraft_tpu/inference/spec_common.py).

Every speculative decoder of the port (single-stream TTS,
models.voicecraft.make_spec_decode_loop; multi-span editing,
models.voicecraft.make_spec_edit_loop; lockstep serving,
inference/serving.py) runs the same pass: sample the true
next token per lane exactly as the plain loop would, draft tau - 1 more
from the MTP heads, run ONE block forward, then accept per lane the prefix
the plain loop would have emitted.  The loops own the plumbing (gating,
caps, the slab, the span queue); this module owns the verify semantics.

Randomness is keyed per lane and token index: lane b's draws for token
index i come from a generator seeded from (seed_b, b, i, salt) alone
(``token_generators``), never from tau or from what was accepted.  So
exact-mode sampled output is the same for every tau, a token rejected in
one pass is redrawn with the same noise as the next pass's first token, a
wave can mix seeds, and same-seed requests in different lanes draw
independently (the JAX package keys lane b on fold_in(PRNGKey(seed_b), b)).
Every other operation of the pass serves all lanes at once.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import ModelConfig
from ..models.voicecraft import (SamplingConfig, _adjust_and_sample,
                                 _adjust_logits, _bench, _finalize_sample,
                                 apply_heads, embed_audio_tokens)
from ..ops.sampling import sample, top_k_top_p_filter, uniform

# salts separating the stochastic verifier's draws at one token index
SALT_DRAFT = 101
SALT_VERIFY = 103

TokenGenerators = Callable[[Union[int, Sequence[int]], int],
                           Optional[List[torch.Generator]]]


def seeded_generator(entropy: Sequence[int], device) -> torch.Generator:
    """A generator whose draws depend on the integers ``entropy`` only."""
    hi, lo = np.random.SeedSequence(list(entropy)).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(hi) << 32 | int(lo))


def lane_seeds(seed: Union[int, Sequence[int]], lanes: int) -> List[int]:
    """Per-lane seeds: one seed for every lane, or one per lane."""
    if isinstance(seed, (int, np.integer)):
        return [int(seed)] * lanes
    seeds = [int(s) for s in seed]
    if len(seeds) != lanes:
        raise ValueError(f"{len(seeds)} seeds for {lanes} lanes")
    return seeds


def lane_generators(seed: Union[int, Sequence[int]], device, lanes: int,
                    lane_ids: Optional[Sequence[int]] = None
                    ) -> List[torch.Generator]:
    """One sequential generator per lane, lane b keyed on (seed_b, id_b):
    id_b = b, or ``lane_ids[b]`` (the continuous-batching engine keys a
    lane on its request's admission, so that a request draws the same noise
    in any lane)."""
    ids = range(lanes) if lane_ids is None else lane_ids
    return [seeded_generator((s, int(i)), device)
            for s, i in zip(lane_seeds(seed, lanes), ids)]


def token_generators(scfg: SamplingConfig, seed: Union[int, Sequence[int]],
                     device, lanes: int = 1,
                     lane_ids: Optional[Sequence[int]] = None
                     ) -> TokenGenerators:
    """gens(index, salt=0) -> one generator per lane for the draws of token
    ``index`` (an int, or one index per lane), lane b keyed on (seed_b,
    id_b, index_b, salt) with id_b = b or ``lane_ids[b]``; None when
    sampling is greedy and draws nothing.  ``seed``: one seed for every
    lane, or one per lane."""
    if scfg.temperature <= 0:
        return lambda index, salt=0: None
    seeds = lane_seeds(seed, lanes)
    ids = [int(i) for i in (range(lanes) if lane_ids is None else lane_ids)]

    def gens(index, salt=0):
        idx = ([int(index)] * lanes if isinstance(index, (int, np.integer))
               else [int(i) for i in index])
        return [seeded_generator((s, b, i, salt), device)
                for b, s, i in zip(ids, seeds, idx)]
    return gens


def make_lane_sampler(cfg: ModelConfig, scfg: SamplingConfig, cap_mult: int,
                      is_tts: bool = True):
    """_adjust_and_sample over lanes, one set of tensor operations for all
    of them (each lane's noise from its own generator): fn(gens, logits
    [B, K, card], eog [B, K], cng, consec, prev, y_pos, x_len [B],
    raw_override=None) -> (samples [B, K], eog [B, K], consec [B], prev
    [B])."""
    def sample_lanes(gens, logits, eog, cng, consec, prev, y_pos, x_len,
                     raw_override=None):
        return _adjust_and_sample(cfg, scfg, is_tts, cap_mult, gens, logits,
                                  eog, cng, consec, prev, y_pos, x_len,
                                  raw_override=raw_override)
    return sample_lanes


def use_stochastic_verify(scfg: SamplingConfig, tau: int) -> bool:
    """Stochastic verification applies when asked for, when sampling is
    stochastic (temperature > 0) and when there are drafts."""
    return (scfg.spec_sampling == "stochastic" and scfg.temperature > 0
            and tau > 1)


def _filtered(scfg: SamplingConfig, logits: torch.Tensor) -> torch.Tensor:
    """The sampling distribution in logit space: the temperature, then the
    top-k / top-p filter (what ops.sampling.sample draws from)."""
    lg = logits if scfg.temperature == 1.0 else logits / scfg.temperature
    return top_k_top_p_filter(lg, scfg.top_k, scfg.top_p)


def _filtered_draft(scfg: SamplingConfig, logits: torch.Tensor) -> torch.Tensor:
    """The draft proposal q in logit space: as _filtered, at the draft
    temperature (spec_draft_temperature; < 0: the sampling temperature),
    floored at 1e-3 so that log q stays finite."""
    td = (scfg.spec_draft_temperature if scfg.spec_draft_temperature >= 0
          else scfg.temperature)
    td = max(td, 1e-3)
    lg = logits if td == 1.0 else logits / td
    return top_k_top_p_filter(lg, scfg.top_k, scfg.top_p)


def stochastic_row_verify(generator, la: torch.Tensor, dlg: torch.Tensor,
                          d_tok: torch.Tensor, overridden: torch.Tensor,
                          scfg: SamplingConfig):
    """Per-codebook-row speculative-sampling verification (``generator``:
    one, or one per lane of the leading axis, ops.sampling.uniform).

    la [..., K, card]: the plain loop's ADJUSTED logits at the slot (the
    target p = softmax(filter(la / T))); dlg [..., K, card]: the raw MTP
    draft logits the proposal came from (q); d_tok [..., K]: the proposed
    tokens; overridden [..., K]: rows the finaliser forces or replaces (the
    forced empties, the eog cascade), which take a fresh p-draw.

    Per row: accept d with probability min(1, p(d) / q(d)), else draw from
    the residual max(p - q, 0) / Z; the raw row is distributed exactly as p
    either way.  The draws come from ``generator`` in a fixed order (the
    accept uniforms, the residual, the fresh p-draw).  Returns (raw
    [..., K], ok [...]: every non-overridden row accepted).  The caller
    also requires finalise(raw) == the fed draft before accepting a slot.
    """
    logp = torch.log_softmax(_filtered(scfg, la), dim=-1)
    logq = torch.log_softmax(_filtered_draft(scfg, dlg), dim=-1)
    lp_d = logp.gather(-1, d_tok[..., None])[..., 0]
    lq_d = logq.gather(-1, d_tok[..., None])[..., 0]
    u = uniform(generator, lp_d.shape, la.device).clamp(min=1e-20)
    accept = torch.log(u) < (lp_d - lq_d)
    resid = torch.log(torch.clamp(logp.exp() - logq.exp(), min=1e-30))
    r_tok = sample(generator, resid)
    f_tok = sample(generator, logp)
    raw = torch.where(overridden, f_tok, torch.where(accept, d_tok, r_tok))
    return raw, (accept | overridden).all(dim=-1)


def spec_verify_pass(model, cfg: ModelConfig, sample_lanes, *, tau: int,
                     gate: torch.Tensor, tok_gen: TokenGenerators,
                     y_pos0: torch.Tensor, x_lens: torch.Tensor,
                     logits: torch.Tensor, h: torch.Tensor, eog: torch.Tensor,
                     cng: torch.Tensor, consec: torch.Tensor,
                     prev: torch.Tensor, t, accept_cap: int, forward,
                     bench_mode: bool = False, force_accept: bool = False,
                     mix_emb=None,
                     scfg: Optional[SamplingConfig] = None,
                     is_tts: bool = True, cap_mult: Optional[int] = None,
                     pending: Optional[torch.Tensor] = None,
                     has_pending: Optional[torch.Tensor] = None) -> dict:
    """One verified tau-token pass for B lanes.

    gate [B] bool: the lanes that take part (the others emit empty rows and
    keep their state).  tok_gen(i, salt) -> the lanes' generators for token
    index t + i (None when greedy).  t: the lanes' token counts, one host
    int for all or a [B] tensor; token i of lane b is accepted only while
    t_b + i < accept_cap.  forward(feed [B, tau, D])
    -> h_blk [B, tau, D] runs the block through the decoder (the caller
    owns the slab).  mix_emb(emb [B, tau, D]) -> [B, tau, D], optional,
    replaces the token embeddings before the positional term (the edit
    loop's feed passes).  The sampling state (eog [B, K], cng, consec, prev,
    y_pos0, x_lens [B]) is on the device; logits [B, K, card] f32, h [B, D].

    With ``scfg.spec_sampling == "stochastic"`` (temperature > 0, tau > 1
    and ``pending`` given) drafts are sampled from q and verified by
    stochastic_row_verify; a rejected slot's corrected raw token becomes
    ``pending`` [B, K] / ``has_pending`` [B] and is the next pass's first
    token (fed, finalised and emitted there through raw_override).
    ``bench_mode`` (measurement): no codebook finishes and special codes
    become 0 (models.voicecraft._bench), so a decode runs to its budget.

    Returns a dict: blk [B, tau, K] emitted rows (rows at n_acc or beyond
    are 0 or stale), n_acc [B], eog / cng / consec / prev (the carried
    state), logits_next [B, K, card] and h_next [B, D] f32 (gate-frozen),
    the raw block outputs h_blk [B, tau, D] and logits_blk [B, tau, K,
    card], tokens_fed [B, tau, K], and pending / has_pending.
    """
    K = cfg.n_codebooks
    B = logits.shape[0]
    dev, dtype = logits.device, model.dtype
    empty_row = torch.full((B, K), cfg.empty_token, dtype=torch.long,
                           device=dev)
    stochastic = (scfg is not None and use_stochastic_verify(scfg, tau)
                  and pending is not None)
    if stochastic and force_accept:
        raise ValueError("force_accept measures the exact-verification "
                         "ceiling; it does not combine with stochastic "
                         "verification")
    if stochastic and cap_mult is None:
        raise ValueError("stochastic verification needs cap_mult")
    kidx = torch.arange(K, device=dev)

    # -- token 0: the true next token, as the plain loop samples it (in
    #    stochastic mode a pending corrected token replaces the draw) --
    ov = (gate & has_pending, pending) if stochastic else None
    t0, eog0, consec0, prev0 = sample_lanes(
        tok_gen(0, 0), logits.float(), eog, cng, consec, prev, y_pos0,
        x_lens, raw_override=ov)
    if bench_mode:
        t0, eog0, consec0, prev0 = _bench(cfg, t0, eog0, consec0, prev0)
    t0 = torch.where(gate[:, None], t0, empty_row)
    eog0 = torch.where(gate[:, None], eog0, eog)

    # -- drafts from the MTP heads at the last accepted hidden --
    d_logits = []
    if tau > 1:
        h_c = h.to(dtype)
        d_logits = [apply_heads(model.mtp_heads[j], h_c) for j in range(tau - 1)]
        if stochastic:
            # proposals drawn from q, each lane from its own generator
            drafts = torch.stack([
                sample(tok_gen(j + 1, SALT_DRAFT),
                       _filtered_draft(scfg, d_logits[j]))    # [B, K]
                for j in range(tau - 1)])
        else:
            drafts = torch.stack(d_logits).argmax(dim=-1)      # [tau-1, B, K]
        # rows beyond cur_num_gen are forced empty by the verifier: draft
        # them empty too
        cng_d = (cng[None, :, None] + 1
                 + torch.arange(tau - 1, device=dev)[:, None, None])
        drafts = torch.where(kidx[None, None, :] > cng_d, cfg.empty_token,
                             drafts)
        tokens = torch.cat([t0[None], drafts])
    else:
        tokens = t0[None]
    tokens_b = tokens.transpose(0, 1)                          # [B, tau, K]

    # -- one block forward for all lanes --
    emb = embed_audio_tokens(model.audio_emb,
                             tokens_b.transpose(1, 2)).to(dtype)
    if mix_emb is not None:
        emb = mix_emb(emb)
    pos_grid = y_pos0[:, None] + torch.arange(tau, device=dev)[None, :]
    feed = emb + model.alpha_audio.to(dtype) * model.pe[pos_grid].to(dtype)
    h_blk = forward(feed)                                      # [B, tau, D]
    logits_blk = apply_heads(model.heads, h_blk.reshape(B * tau, -1)).view(
        B, tau, K, -1)

    # -- verify the drafts per lane against the plain loop's emission --
    emitted = [t0]
    alive = gate & ~eog0.all(dim=1)
    st = (eog0, cng + gate.long(), torch.where(gate, consec0, consec),
          torch.where(gate, prev0, prev))
    n_acc = gate.long()
    pend_out = pending
    has_pend_out = torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(1, tau):
        eog_c, cng_c, consec_c, prev_c = st
        in_cap = t + i < accept_cap
        if isinstance(in_cap, bool):
            in_cap = torch.full((B,), in_cap, dtype=torch.bool, device=dev)
        if stochastic:
            la_i = _adjust_logits(cfg, scfg, is_tts,
                                  logits_blk[:, i - 1].float(), eog_c, cng_c,
                                  consec_c, prev_c)
            overridden = ((eog_c.sum(dim=1) > 0)[:, None]
                          | (kidx[None, :] > cng_c[:, None]))
            raw_i, ok_i = stochastic_row_verify(
                tok_gen(i, SALT_VERIFY), la_i, d_logits[i - 1],
                tokens_b[:, i], overridden, scfg)
            ti, eog_i, consec_i, prev_i = _finalize_sample(
                cfg, scfg, is_tts, cap_mult, la_i, raw_i, eog_c, cng_c,
                consec_c, prev_c, y_pos0 + i, x_lens)
            # accept a slot only when the FINALISED row equals the FED
            # draft: the finaliser can rewrite a raw draw (the row-0 stop
            # check, the cascade), and a slot emitted unlike its fed
            # embedding would condition every later slot on a token that
            # was never emitted; the raw draw is still a valid p-draw for
            # this position, carried as pending below
            match = ok_i & (ti == tokens_b[:, i]).all(dim=1)
        else:
            ti, eog_i, consec_i, prev_i = sample_lanes(
                tok_gen(i, 0), logits_blk[:, i - 1], eog_c, cng_c, consec_c,
                prev_c, y_pos0 + i, x_lens)
            match = (ti == tokens_b[:, i]).all(dim=1)
        if bench_mode:
            ti, eog_i, consec_i, prev_i = _bench(cfg, ti, eog_i, consec_i,
                                                 prev_i)
        if force_accept:          # measurement: 100% acceptance
            match = torch.ones_like(match)
            ti = tokens_b[:, i]
        accept = alive & match & in_cap
        if stochastic:
            # the first rejected slot's corrected raw token was drawn from
            # logits whose prefix was all accepted: a valid draw for this
            # position, fed and emitted as the next pass's first token
            capture = alive & ~match & in_cap
            pend_out = torch.where(capture[:, None], raw_i, pend_out)
            has_pend_out = has_pend_out | capture
        emitted.append(torch.where(accept[:, None], ti, 0))
        n_acc = n_acc + accept.long()
        st = (torch.where(accept[:, None], eog_i, eog_c),
              torch.where(accept, cng_c + 1, cng_c),
              torch.where(accept, consec_i, consec_c),
              torch.where(accept, prev_i, prev_c))
        alive = alive & accept & ~eog_i.all(dim=1)

    eog_f, cng_f, consec_f, prev_f = st
    # -- the last accepted position's outputs seed the next pass --
    last = (n_acc - 1).clamp(min=0)
    lanes = torch.arange(B, device=dev)
    logits_next = torch.where(gate[:, None, None], logits_blk[lanes, last],
                              logits)
    h_next = torch.where(gate[:, None], h_blk[lanes, last].float(), h.float())
    out = {"blk": torch.stack(emitted, dim=1), "n_acc": n_acc,
           "eog": eog_f, "cng": cng_f, "consec": consec_f, "prev": prev_f,
           "logits_next": logits_next, "h_next": h_next,
           "h_blk": h_blk, "logits_blk": logits_blk,
           # the rows FED to the block forward: every accepted slot's
           # emitted row equals its fed row
           "tokens_fed": tokens_b,
           "pending": pending, "has_pending": has_pending}
    if stochastic:
        out["pending"] = pend_out
        out["has_pending"] = torch.where(gate, has_pend_out, has_pending)
    return out
