"""Streaming TTS: audio chunks while the decode is still running (PyTorch
port of voicecraft_tpu/inference/streaming.py).

A streaming request rides a lane of the continuous-batching engine with
per-burst callbacks (engine.ContinuousBatcher.submit(on_rows=...)); the
host turns the growing delayed-row prefix into settled audio:

  rows [t, K] (delayed space, prefix-stable)
    -> generated frames via ops.patterns.unshift_span (positional, so
       earlier frames never change as t grows)
    -> audio via the codec's exact incremental decoder (models/encodec.py
       StreamingDecoder: the EnCodec stack is causal, so the streamed
       samples are those of decoding the finished utterance).

First audio arrives after one burst instead of the whole utterance.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models import encodec as ec
from ..models.voicecraft import SamplingConfig, VoiceCraft
from ..ops import patterns
from .engine import ContinuousBatcher, StreamCancelled
from .serving import _ceil


def frames_from_rows(rows: np.ndarray, cfg: ModelConfig) -> np.ndarray:
    """Delayed-space rows [t, K] -> generated frames [K, max(t - K, 0)], as
    ContinuousBatcher._retire converts them (unshift, then the special_first
    un-shift), so streamed frames are a prefix of the final ``gen``."""
    K = cfg.n_codebooks
    if rows.shape[0] <= K:
        return np.zeros((K, 0), np.int32)
    frames = patterns.unshift_span(rows.T).astype(np.int32)
    if cfg.special_first:
        frames = frames - cfg.n_special
    return frames


class AudioStreamer:
    """Turns a growing frame prefix into PCM chunks with the codec's exact
    incremental decoder: O(new frames) codec work per feed."""

    def __init__(self, codec: ec.Encodec, chunk_frames: int = 16):
        self._dec = ec.StreamingDecoder(codec, chunk_frames=chunk_frames)

    def feed(self, new_frames: np.ndarray) -> np.ndarray:
        return self._dec.feed(new_frames)

    def flush(self) -> np.ndarray:
        return self._dec.flush()


def stream_tts(model: VoiceCraft, x_tokens: np.ndarray, y_codes: np.ndarray,
               scfg: SamplingConfig = SamplingConfig(), *, seed: int = 1,
               codec: Optional[ec.Encodec] = None, burst: int = 48,
               gen_max: Optional[int] = None, kv_dtype: Optional[str] = None,
               spec: int = 0, mesh=None, lanes: int = 1,
               pipeline: bool = True,
               stats: Optional[dict] = None) -> Iterator[dict]:
    """Generator of streaming TTS chunks for one request, on the model's
    device.

    Yields dicts with ``frames`` ([K, m] newly settled generated frames)
    and, with a ``codec``, ``audio`` (float32 samples, the next piece of
    the final waveform).  The last chunk also carries ``full`` / ``gen``
    with inference_tts's semantics (the streamed frames concatenate to
    exactly ``gen``) and ``t_decode``, the producer's wall seconds of the
    whole engine run (independent of how fast the consumer drains).

    A producer thread runs the engine, on the model's device.  Closing the
    generator early (a client that hangs up) sets the engine's cancel flag
    and waits for the producer to end: the engine stops at the first burst
    whose snapshot carries the flag (ContinuousBatcher(cancel=)), so after
    the close it hands over at most the frames of the burst in flight.
    ``stats`` receives, when the generator ends either way, ``frames`` (the
    generated frames, or on cancellation those the producer handed over),
    ``t_decode`` (the producer's wall seconds so far) and ``cancelled``, so
    that a server can account a cancelled stream too.
    ``mesh`` and ``lanes`` pass through to the engine: every rank of the
    mesh runs the same stream, whose one request rides lane 0 of ``lanes``
    (a multiple of the mesh's data axis; the JAX server passes lanes =
    n_data).  The flag of the one rank whose consumer closed reaches every
    rank in the burst's snapshot, so every rank's engine stops at the same
    burst, and the other ranks' generators end there without a last chunk.
    """
    cfg = model.cfg
    K = cfg.n_codebooks
    x_tokens = np.asarray(x_tokens, np.int32)
    y_codes = np.asarray(y_codes, np.int32)
    prefix_len = y_codes.shape[1] + 1    # compose_tts_prefix: T + 1 columns
    if gen_max is None:
        cap = cfg.encodec_sr // 5
        gen_max = max(len(x_tokens) * cap - prefix_len + K + 8, 2 * K + 8)
    gen_max = _ceil(gen_max, 128)
    eng = ContinuousBatcher(
        model, lanes=lanes, x_pad=_ceil(len(x_tokens), 32),
        y_pad=_ceil(prefix_len, 64), gen_max=gen_max, burst=burst, scfg=scfg,
        seed=seed, kv_dtype=kv_dtype, spec=spec, mesh=mesh,
        pipeline=pipeline, cancel=threading.Event())

    q: "queue.Queue" = queue.Queue()
    sent = {"n": 0}
    progress = {"t_decode": 0.0, "done": False}

    def on_rows(rows):
        frames = frames_from_rows(rows, cfg)
        if frames.shape[1] > sent["n"]:
            new = frames[:, sent["n"]:]
            sent["n"] = frames.shape[1]
            q.put(("frames", new))

    rid = eng.submit(x_tokens, y_codes, on_rows=on_rows)
    dev = model.device

    def work():
        # the decode time is measured at the producer: the queue is
        # unbounded, so eng.run()'s wall time never includes the consumer's
        # pace (a realtime-paced client would make every arm look alike)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        t0 = time.perf_counter()
        try:
            res = eng.run()
            progress["t_decode"] = time.perf_counter() - t0
            progress["done"] = True
            progress["frames"] = res[rid][1].shape[1]
            q.put(("done", (res[rid], progress["t_decode"])))
        except StreamCancelled:
            progress["t_decode"] = time.perf_counter() - t0
            q.put(("cancelled", None))
        except Exception as e:  # surfaced to the consumer
            progress["t_decode"] = time.perf_counter() - t0
            q.put(("error", e))

    producer = threading.Thread(target=work, daemon=True)
    producer.start()
    streamer = AudioStreamer(codec) if codec is not None else None
    try:
        while True:
            kind, payload = q.get()
            if kind == "error":
                raise payload
            if kind == "cancelled":     # another rank's consumer closed
                return
            if kind == "frames":
                chunk = {"frames": payload}
                if streamer is not None:
                    chunk["audio"] = streamer.feed(payload)
                yield chunk
                continue
            (full, gen), t_run = payload
            rest = gen[:, sent["n"]:]
            chunk = {"frames": rest, "full": full, "gen": gen,
                     "t_decode": t_run}
            if streamer is not None:
                chunk["audio"] = np.concatenate([streamer.feed(rest),
                                                 streamer.flush()])
            yield chunk
            return
    finally:
        eng.cancel.set()
        producer.join()
        if stats is not None:
            stats.update(frames=progress.get("frames", sent["n"]),
                         t_decode=progress["t_decode"],
                         cancelled=not progress["done"])
