#!/usr/bin/env python
"""HTTP serving app of the PyTorch port (voicecraft_tpu_torch), by default
on a CUDA card: zero-shot TTS, Long TTS and speech editing with
micro-batching, on the stdlib only.  The port's counterpart of
serve_cli.py, with the same endpoints and request fields.

  python serve_torch_cli.py --model ckpt.pth --codec encodec.th --port 8080
  # smoke on the CPU:
  python serve_torch_cli.py --model tiny_test --random-init --device cpu \\
      --text-backend grapheme --port 8080

Features:
  * three modes: TTS, Long TTS (sentences decoded as one lockstep wave)
    and Edit
  * smart transcript: the prompt's aligned words are stitched ahead of
    (and, for edits, after) the typed text
  * per-sentence rerun via /rerun
  * number normalization (app.py)
  * editing from a raw wav alone: without alignment rows in the request,
    the energy aligner (voicecraft_tpu_torch/align.py) finds the words
  * /tts_stream: audio while the decode runs (inference/streaming.py over
    the continuous-batching engine)

Endpoints:
  GET  /            web UI (three modes)
  GET  /healthz     liveness + model info (+ the autospec arms)
  POST /tts         {"prompt_wav_b64", "prompt_transcript",
                     "target_transcript", "mode": "TTS"|"Long TTS",
                     "smart_transcript": bool, "prompt_end_sec": float,
                     "split_text": "Sentence"|"Newline", "top_k": 40, ...}
                    -> {"wav_b64", "gen_sec", "latency_sec", "session",
                        "sentences": ["0: ...", ...],
                        "inference_transcript"}
  POST /tts_stream  the /tts fields (TTS or Long TTS, no smart transcript)
                    -> a WAV header, then PCM16 as frames settle
  POST /rerun       {"session", "sentence_idx", "sentence_text"?, "seed"?}
                    -> {"wav_b64" (combined), "sentence_wav_b64"}
  POST /edit        {"wav_b64", "target_transcript", ...
                     either ("orig_transcript" + "edit_type"
                             [+ "alignment" rows])
                     or     ("edit_start_sec" + "edit_end_sec"
                             [+ "smart_transcript" + "orig_transcript"])
                     or     ("edit_spans": [[s0,e0],[s1,e1],...] seconds:
                             multi-span editing in one decode)}
                    -> {"wav_b64", "edit_interval_frames", "latency_sec"}

Lone requests decode through inference_tts / inference_tts_batch /
inference_tts_spec / inference_edit; concurrent ones that share a sampling
configuration ride one lockstep wave (serve_tts_batch / serve_edit_batch).

Over several cards, one process per card under torchrun, with the model
sharded over a DATA x MODEL mesh (lanes over DATA, heads and FFN columns
over MODEL; voicecraft_tpu_torch/parallel/mesh.py):

  python -m torch.distributed.run --nproc-per-node 4 serve_torch_cli.py \
      --mesh 2x2 --model giga830M --random-init --port 8080

Rank 0 runs the HTTP front and the micro-batch worker; it broadcasts each
decode call (a wave's inputs, padded to a multiple of DATA, or a lone
request or a stream) to the other ranks, and every rank runs it.

--asr-model (a local Whisper snapshot) gives the word rows of a request
without "alignment" (the smart transcripts' words_info and /edit's span)
from Whisper's word timestamps, else the energy aligner's; over a mesh
rank 0 aligns, before the decode call it broadcasts.
"""

import argparse
import base64
import collections
import datetime
import io
import json
import logging
import os
import queue
import struct
import tempfile
import threading
import time
import uuid
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

log = logging.getLogger("voicecraft_tpu_torch.serve")


def _decode_fn(name: str):
    """The decode functions that a mesh's ranks all run, by name."""
    from voicecraft_tpu_torch.inference import (editing, serving, streaming,
                                                tts)
    return {"serve_tts_batch": serving.serve_tts_batch,
            "serve_edit_batch": serving.serve_edit_batch,
            "inference_tts": tts.inference_tts,
            "inference_tts_batch": tts.inference_tts_batch,
            "inference_tts_spec": tts.inference_tts_spec,
            "inference_edit": editing.inference_edit,
            "stream_tts": streaming.stream_tts}[name]


class Engine:
    """Model + codec + micro-batching scheduler + session store.  With a
    ``mesh`` (parallel.mesh.Mesh) every rank builds one; rank 0 serves and
    the others :meth:`follow` its decode calls."""

    def __init__(self, args, mesh=None):
        import dataclasses
        import torch
        from voicecraft_tpu_torch.data.phonemes import make_text_tokenizer
        from voicecraft_tpu_torch.inference.autospec import (AutoSpecPolicy,
                                                             resolve_spec_arg)
        from voicecraft_tpu_torch.inference.loader import (load_codec,
                                                           load_model)
        from voicecraft_tpu_torch.models.voicecraft import VoiceCraft
        self.args = args
        self.device = torch.device(args.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but no CUDA device is "
                               "available (pass --device cpu to run on the "
                               "CPU)")
        self.cfg, self.model, self.phn2num = load_model(
            args.model, args.random_init, args.seed, self.device)
        self.device = self.model.device        # with its index: cuda:N
        spec_arg = str(getattr(args, "spec", 0) or 0)
        auto = spec_arg.strip().lower().startswith("auto")
        fixed = 0 if auto else int(spec_arg)
        if fixed > 1 and not hasattr(self.model, "mtp_heads"):
            if args.random_init:
                # the same random weights plus TAU - 1 MTP head groups,
                # drawn after every other weight
                self.cfg = dataclasses.replace(self.cfg, n_mtp=fixed - 1)
                self.model = VoiceCraft(self.cfg, self.device).init_weights(
                    torch.Generator(device=self.device).manual_seed(
                        args.seed)).eval()
            else:
                log.warning("--spec %s requested but the checkpoint has no "
                            "MTP heads; speculative serving disabled",
                            spec_arg)
        if getattr(args, "fp8", False):
            from voicecraft_tpu_torch.utils.quantize import \
                quantize_decoder_fp8
            self.model = quantize_decoder_fp8(self.model, pack_qkv=True)
            log.info("serving with the weight-only fp8 decoder (packed qkv)")
        self.mesh = mesh
        self.primary = mesh is None or mesh.rank == 0
        if mesh is not None:
            import torch.distributed as dist
            from voicecraft_tpu_torch.parallel.mesh import shard_params
            shard_params(self.model, mesh)
            # the decode calls travel on a gloo group that waits as long as
            # the server stays idle
            self.control = dist.new_group(
                backend="gloo", timeout=datetime.timedelta(days=365))
            log.info("serving over a (%d data x %d model) mesh, rank %d",
                     mesh.n_data, mesh.n_model, mesh.rank)
        self.ccfg, self.codec = load_codec(
            args.codec, args.random_init, args.seed, self.device,
            codebook_size=self.cfg.audio_vocab_size)
        self.tok = make_text_tokenizer(args.language, args.text_backend)
        self.kv_dtype = ("float8_e4m3fn"
                         if getattr(args, "kv_fp8", False) else None)
        if auto:
            self.spec, self.autospec = resolve_spec_arg(spec_arg, self.model)
        else:
            self.spec = fixed if hasattr(self.model, "mtp_heads") else 0
            self.autospec = None
        if auto and self.spec == 0:
            log.warning("--spec auto requested but the model has no MTP "
                        "heads; speculative serving disabled")
        # one policy per tier: TTS waves, edit waves and streams have
        # different economics, so their samples are not pooled
        self.autospec_edit = self.autospec_stream = None
        if self.autospec is not None:
            self.autospec_edit = AutoSpecPolicy(taus=self.autospec.taus)
            self.autospec_stream = AutoSpecPolicy(taus=self.autospec.taus)
            log.info("adaptive speculation over arms %s", self.autospec.arms)
        self.queue: "queue.Queue" = queue.Queue()
        self.lock = threading.Lock()
        # rerun sessions: sid -> {"codes", "scfg", "seed", "sentences",
        #                         "targets", "gen_wavs", ...}
        self.sessions = collections.OrderedDict()
        if self.primary:
            threading.Thread(target=self._batch_worker, daemon=True).start()

    # ---- decode calls, on every rank of a mesh ----------------------------------

    def _call(self, name, *args, stats=None, **kwargs):
        """Run decode function ``name`` on the model with ``args`` /
        ``kwargs`` (host values); over a mesh, broadcast the call to the
        other ranks first, so that every rank runs it.  Hold ``self.lock``."""
        if self.mesh is not None:
            import torch.distributed as dist
            dist.broadcast_object_list([(name, args, kwargs)], src=0,
                                       group=self.control)
        return self._local_call(name, args, kwargs, stats)

    def _local_call(self, name, args, kwargs, stats=None):
        kwargs = dict(kwargs)
        if name in ("serve_tts_batch", "serve_edit_batch", "stream_tts"):
            kwargs.update(mesh=self.mesh, stats=stats)
        if name == "stream_tts":
            kwargs.update(codec=self.codec if self.primary else None,
                          lanes=self._n_data)
        return _decode_fn(name)(self.model, *args, **kwargs)

    @property
    def _n_data(self) -> int:
        return 1 if self.mesh is None else self.mesh.n_data

    def _pad_wave(self, items: list, seeds: list):
        """A wave padded to a multiple of the mesh's data axis by repeating
        its last request (seed 0), as serve_cli.py pads."""
        items, seeds = list(items), list(seeds)
        while len(items) % self._n_data:
            items.append(items[-1])
            seeds.append(0)
        return items, seeds

    def follow(self):
        """A follower rank's loop: run every decode call rank 0 broadcasts
        (a stream to its end, its audio unused), until the process ends."""
        import torch.distributed as dist
        self._on_device()
        while True:
            job = [None]
            dist.broadcast_object_list(job, src=0, group=self.control)
            name, args, kwargs = job[0]
            out = self._local_call(name, args, kwargs)
            if name == "stream_tts":
                for _ in out:
                    pass

    # ---- request plumbing ---------------------------------------------------

    def _on_device(self):
        """A thread's CUDA calls go to the model's card."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _phonemize(self, text):
        from voicecraft_tpu_torch.data.phonemes import (build_vocab,
                                                        phones_to_ids)
        phones = self.tok.phonemize(text)
        if self.phn2num is None:
            self.phn2num = build_vocab([phones])
        return np.asarray(phones_to_ids(phones, self.phn2num), np.int32)

    def _decode_wav_b64(self, b64):
        from voicecraft_tpu_torch.utils import audio as au
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
            f.write(base64.b64decode(b64))
            path = f.name
        try:
            return au.load_audio(path, self.ccfg.sample_rate)
        finally:
            os.unlink(path)

    def _wav_to_b64(self, wav):
        buf = io.BytesIO()
        with wave.open(buf, "wb") as wf:
            wf.setnchannels(1)
            wf.setsampwidth(2)
            wf.setframerate(self.ccfg.sample_rate)
            pcm = np.round(np.clip(wav, -1, 1) * 32767).astype("<i2")
            wf.writeframes(pcm.tobytes())
        return base64.b64encode(buf.getvalue()).decode()

    def _encode(self, wav):
        from voicecraft_tpu_torch.models import encodec as ec
        self._on_device()
        return ec.encode_bucketed(self.codec, wav)[0]

    def _decode(self, codes):
        from voicecraft_tpu_torch.models import encodec as ec
        self._on_device()
        return ec.decode_bucketed(self.codec, codes[None])[0]

    def _scfg(self, req):
        from voicecraft_tpu_torch.models.voicecraft import SamplingConfig
        return SamplingConfig(
            top_k=int(req.get("top_k", 40)),
            top_p=float(req.get("top_p", 1.0)),
            temperature=float(req.get("temperature", 1.0)),
            stop_repetition=int(req.get("stop_repetition", 3)),
            silence_tokens=tuple(req.get("silence_tokens",
                                         (1388, 1898, 131))),
            spec_sampling=req.get(
                "spec_sampling",
                getattr(self.args, "spec_sampling", "exact")),
            spec_draft_temperature=float(
                req.get("spec_draft_temperature", -1.0)))

    def _align(self, wav, transcript):
        """Word rows of ``wav`` (align.py:align_words: Whisper's with
        --asr-model, on the model's device, else the energy aligner's)."""
        from voicecraft_tpu_torch.align import align_words
        return align_words(wav, self.ccfg.sample_rate, transcript,
                           asr_model_path=self.args.asr_model,
                           device=self.device)

    def _words_info(self, req, wav, transcript):
        """Whisper-style words_info of the prompt: the request's alignment
        rows, else the aligner's."""
        from voicecraft_tpu_torch.app import words_info_from_rows
        if req.get("alignment"):
            return words_info_from_rows(req["alignment"])
        return words_info_from_rows(self._align(wav, transcript))

    def _decode_sentences(self, slots):
        """Queue sentence slots through the micro-batcher, wait for all."""
        for s in slots:
            self.queue.put(s)
        for s in slots:
            if not s["done"].wait(timeout=600):
                raise TimeoutError("decode timed out after 600 s")
            if isinstance(s["result"], Exception):
                raise s["result"]

    def _remember(self, sid, state):
        self.sessions[sid] = state
        while len(self.sessions) > 16:
            self.sessions.popitem(last=False)

    # ---- TTS / Long TTS -----------------------------------------------------

    def tts(self, req: dict) -> dict:
        from voicecraft_tpu_torch.app import (normalize_transcript,
                                              smart_transcript_tts,
                                              split_sentences)
        t0 = time.time()
        cfg, ccfg = self.cfg, self.ccfg
        mode = req.get("mode", "TTS")
        target_text = normalize_transcript(req["target_transcript"])
        prompt_transcript = normalize_transcript(
            req.get("prompt_transcript", ""))

        wav = self._decode_wav_b64(req["prompt_wav_b64"])
        audio_dur = wav.shape[1] / ccfg.sample_rate
        prompt_end = float(req.get("prompt_end_sec", -1))
        if prompt_end <= 0:
            prompt_end = audio_dur
        smart = bool(req.get("smart_transcript", False))

        if mode == "Long TTS":
            sentences = split_sentences(target_text,
                                        req.get("split_text", "Sentence"))
        else:
            sentences = [target_text.replace("\n", " ")]

        words_info = None
        if smart:
            if not prompt_transcript:
                raise ValueError("smart_transcript needs prompt_transcript")
            words_info = self._words_info(req, wav, prompt_transcript)

        # per-sentence targets (and the prompt cut a smart transcript moves)
        targets, cut = [], min(prompt_end, audio_dur)
        for sentence in sentences:
            if smart:
                tgt, cut = smart_transcript_tts(words_info, cut, sentence)
            else:
                tgt = (prompt_transcript + " " + sentence).strip()
            targets.append(tgt)
        codes = self._encode(wav[:, :int(cut * ccfg.sample_rate)])

        seed = int(req.get("seed", self.args.seed))
        scfg = self._scfg(req)
        sbs = int(req.get("sample_batch_size", 1))
        # per-sentence seeds: each sentence's noise is its own however the
        # micro-batcher slices sentences into waves (lanes carry their
        # seeds), as /tts_stream seeds its sentences
        slots = [{"x": self._phonemize(t), "codes": codes, "scfg": scfg,
                  "seed": seed + i, "sbs": sbs, "done": threading.Event(),
                  "result": None} for i, t in enumerate(targets)]
        self._decode_sentences(slots)

        gen_wavs = [self._decode(s["result"][1]) for s in slots]
        combined = np.concatenate(gen_wavs, axis=-1)
        if req.get("include_prompt"):
            combined = np.concatenate(
                [wav[0, :int(cut * ccfg.sample_rate)], combined], axis=-1)

        sid = uuid.uuid4().hex[:12]
        self._remember(sid, {"codes": codes, "scfg": scfg, "seed": seed,
                             "sentences": list(sentences),
                             "targets": targets, "gen_wavs": gen_wavs,
                             "smart": smart, "words_info": words_info,
                             "cut": cut})
        gen_sec = sum(s["result"][1].shape[1] for s in slots) / cfg.encodec_sr
        return {"wav_b64": self._wav_to_b64(combined),
                "gen_sec": gen_sec,
                "latency_sec": time.time() - t0,
                "session": sid,
                "sentences": [f"{i}: {s}" for i, s in enumerate(sentences)],
                "inference_transcript": "\n".join(targets)}

    def tts_stream(self, req: dict):
        """Generator of WAV byte chunks: the header first, then PCM16 audio
        as the decode settles frames (inference/streaming.py).  ``mode:
        "Long TTS"`` streams the sentences back to back, each from the same
        prompt; no smart transcript.  First audio comes after one engine
        burst.  Holds the model lock for the whole stream.  A stream that
        ends early (the client hung up) still gives the stream tier's
        autospec arm its sample: the frames and producer seconds so far."""
        from voicecraft_tpu_torch.app import (normalize_transcript,
                                              split_sentences)
        ccfg = self.ccfg
        target_text = normalize_transcript(req["target_transcript"])
        prompt_transcript = normalize_transcript(
            req.get("prompt_transcript", ""))
        wav = self._decode_wav_b64(req["prompt_wav_b64"])
        prompt_end = float(req.get("prompt_end_sec", -1))
        cut = (wav.shape[1] / ccfg.sample_rate if prompt_end <= 0
               else min(prompt_end, wav.shape[1] / ccfg.sample_rate))
        codes = self._encode(wav[:, :int(cut * ccfg.sample_rate)])
        if req.get("mode") == "Long TTS":
            sentences = split_sentences(target_text,
                                        req.get("split_text", "Sentence"))
        else:
            sentences = [target_text.replace("\n", " ")]
        targets = [(prompt_transcript + " " + s).strip() for s in sentences]
        scfg = self._scfg(req)
        seed = int(req.get("seed", self.args.seed))

        # a WAV header with unknown (streaming) sizes
        yield (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
               + struct.pack("<IHHIIHH", 16, 1, 1, ccfg.sample_rate,
                             ccfg.sample_rate * 2, 2, 16)
               + b"data" + struct.pack("<I", 0xFFFFFFFF))
        if req.get("include_prompt"):
            pcm = np.round(np.clip(wav[0, :int(cut * ccfg.sample_rate)],
                                   -1, 1) * 32767).astype("<i2")
            yield pcm.tobytes()
        with self.lock:
            self._on_device()
            for i, target in enumerate(targets):
                x = self._phonemize(target)
                # the stream tier rides its own autospec arm, per sentence
                smode = (self.autospec_stream.next_mode()
                         if self.autospec_stream is not None else self.spec)
                # the decode time is the PRODUCER's (stream_tts's worker):
                # the consumer runs at the client's pace, which would make
                # every arm look alike
                stats: dict = {}
                stream_it = self._call(
                    "stream_tts", x, codes, scfg, seed=seed + i,
                    kv_dtype=self.kv_dtype, spec=smode,
                    burst=int(req.get("burst", 48)), stats=stats)
                try:
                    for chunk in stream_it:
                        audio = chunk.get("audio")
                        if audio is not None and audio.size:
                            yield (np.round(np.clip(audio, -1, 1) * 32767)
                                   .astype("<i2").tobytes())
                finally:
                    # a closed stream cancels the producer and waits for it
                    stream_it.close()
                    if (self.autospec_stream is not None
                            and stats.get("t_decode", 0) > 0):
                        self.autospec_stream.observe(smode, stats["frames"],
                                                     stats["t_decode"])

    def rerun(self, req: dict) -> dict:
        """Regenerate one sentence of an earlier TTS session."""
        from voicecraft_tpu_torch.app import (normalize_transcript,
                                              smart_transcript_tts)
        t0 = time.time()
        st = self.sessions.get(req.get("session", ""))
        if st is None:
            raise ValueError("unknown or expired session")
        idx = int(req["sentence_idx"])
        if not 0 <= idx < len(st["targets"]):
            raise ValueError(f"sentence_idx out of range: {idx}")
        sentence = req.get("sentence_text")
        if sentence is not None:
            sentence = normalize_transcript(sentence)
            if st["smart"]:
                tgt, _ = smart_transcript_tts(st["words_info"], st["cut"],
                                              sentence)
            else:
                tgt = sentence
            st["sentences"][idx] = sentence
            st["targets"][idx] = tgt
        seed = int(req.get("seed", st["seed"] + 1000 + idx))
        slot = {"x": self._phonemize(st["targets"][idx]),
                "codes": st["codes"], "scfg": st["scfg"], "seed": seed,
                "done": threading.Event(), "result": None}
        self._decode_sentences([slot])
        st["gen_wavs"][idx] = self._decode(slot["result"][1])
        combined = np.concatenate(st["gen_wavs"], axis=-1)
        return {"wav_b64": self._wav_to_b64(combined),
                "sentence_wav_b64": self._wav_to_b64(st["gen_wavs"][idx]),
                "latency_sec": time.time() - t0}

    def _batch_worker(self):
        self._on_device()
        while True:
            slots = [self.queue.get()]
            deadline = time.time() + self.args.batch_window_ms / 1000.0
            while len(slots) < self.args.max_batch:
                try:
                    slots.append(self.queue.get(
                        timeout=max(deadline - time.time(), 0)))
                except queue.Empty:
                    break
            try:
                log.info("micro-batch wave: %d slot(s) [%s]", len(slots),
                         ",".join(s.get("kind", "tts") for s in slots))
                with self.lock:
                    # a lockstep wave decodes with ONE SamplingConfig, so
                    # only requests that share it are batched; per-request
                    # seeds ride along (each lane has its own)
                    groups: dict = {}
                    for s in slots:
                        k = (s.get("kind", "tts"), s["scfg"],
                             s.get("sbs", 1))
                        groups.setdefault(k, []).append(s)
                    for (kind, scfg, sbs), group in groups.items():
                        if kind == "edit":
                            self._edit_group(group, scfg)
                        elif len(group) > 1 and sbs == 1:
                            # the bandit picks the wave's mode and learns
                            # from its measured throughput
                            mode = (self.autospec.next_mode()
                                    if self.autospec is not None
                                    else self.spec)
                            stats: dict = {}
                            reqs, seeds = self._pad_wave(
                                [(s["x"], s["codes"]) for s in group],
                                [s["seed"] for s in group])
                            outs = self._call(
                                "serve_tts_batch", reqs, scfg, seeds=seeds,
                                kv_dtype=self.kv_dtype, spec=mode,
                                stats=stats)
                            if self.autospec is not None:
                                self.autospec.observe(
                                    mode, stats["frames"], stats["seconds"],
                                    tok_per_pass=stats["tok_per_pass"])
                            for s, o in zip(group, outs):
                                s["result"] = o
                        else:
                            for s in group:
                                # best-of-N, or a lone request
                                if sbs > 1:
                                    s["result"] = self._call(
                                        "inference_tts_batch", s["x"],
                                        s["codes"], scfg, batch_size=sbs,
                                        seed=s["seed"])
                                elif self.spec > 1:
                                    s["result"] = self._call(
                                        "inference_tts_spec", s["x"],
                                        s["codes"], scfg, n_draft=self.spec,
                                        seed=s["seed"])
                                else:
                                    s["result"] = self._call(
                                        "inference_tts", s["x"], s["codes"],
                                        scfg, seed=s["seed"])
            except Exception as e:  # surfaced to the waiters
                log.exception("batch failed")
                for s in slots:
                    if s["result"] is None:
                        s["result"] = e
            for s in slots:
                s["done"].set()

    def _edit_group(self, group, scfg):
        """Edit slots sharing a SamplingConfig: one serve_edit_batch wave,
        or inference_edit for a lone one."""
        if len(group) == 1:
            s = group[0]
            s["result"] = self._call("inference_edit", s["x"], s["codes"],
                                     s["intervals"], scfg, seed=s["seed"],
                                     spec=self.spec)
            return
        mode = (self.autospec_edit.next_mode()
                if self.autospec_edit is not None else self.spec)
        stats: dict = {}
        reqs, seeds = self._pad_wave(
            [(s["x"], s["codes"], s["intervals"]) for s in group],
            [s["seed"] for s in group])
        outs = self._call("serve_edit_batch", reqs, scfg, seeds=seeds,
                          kv_dtype=self.kv_dtype, spec=mode, stats=stats)
        if self.autospec_edit is not None:
            self.autospec_edit.observe(mode, stats["frames"],
                                       stats["seconds"],
                                       tok_per_pass=stats["tok_per_pass"])
        for s, o in zip(group, outs):
            s["result"] = o

    # ---- editing ------------------------------------------------------------

    def edit(self, req: dict) -> dict:
        from voicecraft_tpu_torch.align import widen_margins_for_aligner
        from voicecraft_tpu_torch.app import (morph_edit_span,
                                              normalize_transcript,
                                              smart_transcript_edit)
        from voicecraft_tpu_torch.inference.editing import (get_mask_interval,
                                                            get_span)
        t0 = time.time()
        cfg, ccfg = self.cfg, self.ccfg
        wav = self._decode_wav_b64(req["wav_b64"])
        audio_dur = wav.shape[1] / ccfg.sample_rate
        codes = self._encode(wav)
        target_text = normalize_transcript(req["target_transcript"])
        orig_text = normalize_transcript(req.get("orig_transcript", ""))
        left_m = float(req.get("left_margin", req.get("margin", 0.08)))
        right_m = float(req.get("right_margin", req.get("margin", 0.08)))

        def decode(intervals):
            slot = {"kind": "edit", "x": self._phonemize(target_text),
                    "codes": codes, "intervals": intervals,
                    "scfg": self._scfg(req),
                    "seed": int(req.get("seed", self.args.seed)),
                    "result": None, "done": threading.Event()}
            # concurrent edits that share a SamplingConfig ride one wave
            self._decode_sentences([slot])
            return self._wav_to_b64(self._decode(slot["result"]))

        if "edit_spans" in req:
            # explicit multi-span editing: every span in one decode
            spans_sec = sorted((float(s), float(e))
                               for s, e in req["edit_spans"])
            for s, e in spans_sec:
                if not e > s:
                    raise ValueError(f"edit span [{s}, {e}] has "
                                     "non-positive length")
            for (_, e0), (s1, _) in zip(spans_sec, spans_sec[1:]):
                if s1 < e0:
                    raise ValueError("edit_spans must be disjoint "
                                     f"(span starting at {s1}s overlaps "
                                     f"the previous span ending at {e0}s)")
            intervals = sorted(morph_edit_span(
                s, e, left_margin=left_m, right_margin=right_m,
                audio_dur=audio_dur, codec_sr=cfg.encodec_sr)
                for s, e in spans_sec)
            # widened margins can make neighbouring frame intervals touch:
            # merge them, the union regenerated as one edit (the splice
            # needs strictly increasing, disjoint intervals)
            merged = [list(intervals[0])]
            for s, e in intervals[1:]:
                if s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            intervals = [tuple(iv) for iv in merged]
            return {"wav_b64": decode(intervals),
                    "edit_interval_frames": [list(iv) for iv in intervals],
                    "latency_sec": time.time() - t0}

        if "edit_start_sec" in req and "edit_end_sec" in req:
            start_sec = float(req["edit_start_sec"])
            end_sec = float(req["edit_end_sec"])
            if req.get("smart_transcript"):
                if not orig_text:
                    raise ValueError("smart_transcript needs orig_transcript")
                wi = self._words_info(req, wav, orig_text.lower())
                target_text = normalize_transcript(smart_transcript_edit(
                    wi, start_sec, end_sec, target_text))
        else:
            # the transcript diff (edit_torch_cli.py's path); word rows from
            # the request or the aligner (the energy aligner's margins widen
            # to its p90 boundary error)
            if not orig_text:
                raise ValueError("need orig_transcript (or edit_*_sec times)")
            if req.get("alignment"):
                rows = [r for r in req["alignment"]
                        if r.get("Type", "words") == "words"]
            else:
                rows = self._align(wav, orig_text.lower())
            orig_span, _ = get_span(orig_text.lower(), target_text.lower(),
                                    req["edit_type"])
            start_sec, end_sec = get_mask_interval(rows, tuple(orig_span),
                                                   req["edit_type"])
            left_m, right_m, _ = widen_margins_for_aligner(rows, left_m,
                                                           right_m)
        interval = morph_edit_span(
            start_sec, end_sec, left_margin=left_m, right_margin=right_m,
            audio_dur=audio_dur, codec_sr=cfg.encodec_sr)
        return {"wav_b64": decode([interval]),
                "edit_interval_frames": list(interval),
                "latency_sec": time.time() - t0}


INDEX_HTML = """<!doctype html><html><head><title>voicecraft-tpu</title>
<style>body{font-family:sans-serif;max-width:52rem;margin:2rem auto;padding:0 1rem}
textarea,input,select{width:100%;margin:.25rem 0;box-sizing:border-box}
button{padding:.5rem 1rem;margin:.25rem .25rem .25rem 0}
.row{display:flex;gap:1rem}.row>div{flex:1}
fieldset{margin:.75rem 0;border:1px solid #ccc}</style></head>
<body><h2>voicecraft-tpu</h2>
<div class=row><div>
<label>Mode <select id=mode onchange="modeUi()">
<option>TTS</option><option>Long TTS</option><option>Edit</option>
</select></label></div><div>
<label><input type=checkbox id=smart style="width:auto"> smart transcript</label>
</div></div>
<input type=file id=wav accept=.wav>
<textarea id=pt rows=2 placeholder="prompt / original transcript"></textarea>
<textarea id=tt rows=3 placeholder="target transcript (TTS: text to speak; Edit: replacement text or full target)"></textarea>
<div class=row id=ttsopts><div>
<label>prompt end (s) <input id=pend type=number step=0.01 value=-1></label>
</div><div>
<label>split <select id=split><option>Sentence</option><option>Newline</option></select></label>
</div></div>
<fieldset id=editopts style="display:none"><legend>Edit</legend>
<div class=row><div>
<label>edit type <select id=etype><option>substitution</option>
<option>insertion</option><option>deletion</option></select></label></div><div>
<label>left margin <input id=lm type=number step=0.01 value=0.08></label></div><div>
<label>right margin <input id=rm type=number step=0.01 value=0.08></label>
</div></div></fieldset>
<div class=row><div><label>top_k <input id=topk type=number value=40></label></div>
<div><label>top_p <input id=topp type=number step=0.05 value=1.0></label></div>
<div><label>temperature <input id=temp type=number step=0.05 value=1.0></label></div>
<div><label>seed <input id=seed type=number value=1></label></div></div>
<button onclick=go()>Run</button> <span id=st></span>
<audio id=out controls style="display:block;margin-top:1rem"></audio>
<fieldset id=rerunbox style="display:none"><legend>Rerun a sentence</legend>
<select id=sentsel></select>
<textarea id=sentedit rows=2></textarea>
<button onclick=rerun()>Rerun sentence</button>
<audio id=sentout controls style="display:block"></audio></fieldset>
<pre id=itx></pre>
<script>
let session = null;
function modeUi(){
  const m = document.getElementById('mode').value;
  document.getElementById('editopts').style.display = m==='Edit'?'':'none';
  document.getElementById('ttsopts').style.display = m==='Edit'?'none':'flex';
}
async function b64(){
  const f = document.getElementById('wav').files[0];
  if(!f){alert('pick a wav');throw 'no wav'}
  const bytes = new Uint8Array(await f.arrayBuffer());
  let s=''; for(let i=0;i<bytes.length;i+=0x8000)
    s += String.fromCharCode.apply(null, bytes.subarray(i,i+0x8000));
  return btoa(s);
}
function common(){return {
  top_k:+document.getElementById('topk').value,
  top_p:+document.getElementById('topp').value,
  temperature:+document.getElementById('temp').value,
  seed:+document.getElementById('seed').value,
  smart_transcript:document.getElementById('smart').checked};}
async function go(){
  const m = document.getElementById('mode').value;
  const st = document.getElementById('st');
  st.textContent = 'generating...';
  try{
    let r, j;
    if(m==='Edit'){
      r = await fetch('/edit',{method:'POST',body:JSON.stringify({...common(),
        wav_b64: await b64(),
        orig_transcript: document.getElementById('pt').value,
        target_transcript: document.getElementById('tt').value,
        edit_type: document.getElementById('etype').value,
        left_margin:+document.getElementById('lm').value,
        right_margin:+document.getElementById('rm').value})});
    } else {
      r = await fetch('/tts',{method:'POST',body:JSON.stringify({...common(),
        mode:m, prompt_wav_b64: await b64(),
        prompt_transcript: document.getElementById('pt').value,
        target_transcript: document.getElementById('tt').value,
        prompt_end_sec:+document.getElementById('pend').value,
        split_text: document.getElementById('split').value})});
    }
    j = await r.json();
    if(!r.ok) throw j.error;
    st.textContent = (j.gen_sec!==undefined?j.gen_sec.toFixed(1)+'s audio in ':'done in ')
      + j.latency_sec.toFixed(1)+'s';
    document.getElementById('out').src = 'data:audio/wav;base64,'+j.wav_b64;
    document.getElementById('itx').textContent = j.inference_transcript||'';
    session = j.session||null;
    const box = document.getElementById('rerunbox');
    if(j.sentences && j.sentences.length){
      box.style.display='';
      const sel = document.getElementById('sentsel');
      sel.innerHTML='';
      j.sentences.forEach(s=>{const o=document.createElement('option');
        o.textContent=s; sel.appendChild(o);});
      sel.onchange = ()=>{const v=sel.value;
        document.getElementById('sentedit').value=v.slice(v.indexOf(':')+2);};
      sel.onchange();
    } else box.style.display='none';
  }catch(e){st.textContent = 'error: '+e}
}
async function rerun(){
  const sel = document.getElementById('sentsel');
  const st = document.getElementById('st');
  st.textContent = 'rerunning...';
  try{
    const r = await fetch('/rerun',{method:'POST',body:JSON.stringify({
      session, sentence_idx: sel.selectedIndex,
      sentence_text: document.getElementById('sentedit').value,
      seed: Math.floor(Math.random()*1e6)})});
    const j = await r.json();
    if(!r.ok) throw j.error;
    st.textContent = 'rerun done in '+j.latency_sec.toFixed(1)+'s';
    document.getElementById('out').src = 'data:audio/wav;base64,'+j.wav_b64;
    document.getElementById('sentout').src = 'data:audio/wav;base64,'+j.sentence_wav_b64;
  }catch(e){st.textContent = 'error: '+e}
}
modeUi();
</script></body></html>"""

def make_handler(engine: Engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.info("%s " + fmt, self.client_address[0], *args)

        def _send(self, code, body, ctype="application/json"):
            data = body if isinstance(body, bytes) else body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/":
                self._send(200, INDEX_HTML, "text/html")
            elif self.path == "/healthz":
                info = {"status": "ok", "device": str(engine.device),
                        "model_d_model": engine.cfg.d_model,
                        "n_codebooks": engine.cfg.n_codebooks}
                for key in ("autospec", "autospec_edit", "autospec_stream"):
                    policy = getattr(engine, key)
                    if policy is not None:
                        info[key] = policy.snapshot()
                self._send(200, json.dumps(info))
            else:
                self._send(404, json.dumps({"error": "not found"}))

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n))
                if self.path == "/tts_stream":
                    # WAV bytes as frames settle; the end is the
                    # connection's close (no Content-Length)
                    gen = engine.tts_stream(req)
                    first = next(gen)           # raise before headers go out
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.end_headers()
                    try:
                        self.wfile.write(first)
                        self.wfile.flush()
                        for part in gen:
                            self.wfile.write(part)
                            self.wfile.flush()
                    except Exception:
                        # the headers are out: a 500 body would be read as
                        # audio, so log and close (truncation = error)
                        log.exception("stream aborted")
                    finally:
                        gen.close()
                        self.close_connection = True
                    return
                if self.path == "/tts":
                    out = engine.tts(req)
                elif self.path == "/edit":
                    out = engine.edit(req)
                elif self.path == "/rerun":
                    out = engine.rerun(req)
                else:
                    return self._send(404, json.dumps({"error": "not found"}))
                self._send(200, json.dumps(out))
            except Exception as e:
                log.exception("request failed")
                self._send(500, json.dumps({"error": str(e)}))

    return Handler


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True,
                    help=".pth bundle, HF snapshot dir, or preset name")
    ap.add_argument("--codec", default=None, help="audiocraft .th checkpoint")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--batch-window-ms", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--language", default="en-us")
    ap.add_argument("--text-backend", default="auto",
                    choices=["auto", "phonemizer", "espeak", "grapheme"])
    ap.add_argument("--fp8", action="store_true",
                    help="weight-only fp8 decoder (quantize_decoder_fp8, "
                         "packed qkv)")
    ap.add_argument("--kv-fp8", action="store_true",
                    help="the KV slab of waves and streams in float8_e4m3fn")
    ap.add_argument("--spec", default="0", metavar="TAU|auto[:T1,T2..]",
                    help="speculative decoding with TAU tokens per verified "
                         "pass, for lone requests, waves and streams (the "
                         "model needs TAU - 1 MTP head groups; "
                         "--random-init adds them).  'auto' runs a bandit "
                         "per tier (TTS waves, edit waves, streams) over "
                         "{plain, tau=4, full MTP depth} on live traffic "
                         "(lone requests use the deepest tau); 'auto:T1,T2' "
                         "names the taus")
    ap.add_argument("--spec-sampling", default="exact",
                    choices=["exact", "stochastic"],
                    help="the default speculative verification (a request "
                         "may set spec_sampling)")
    ap.add_argument("--random-init", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no automatic "
                         "fallback to the CPU")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve over a DATA x MODEL mesh of processes, one "
                         "per card, under torchrun (python -m torch."
                         "distributed.run --nproc-per-node DATA*MODEL): "
                         "NCCL on cuda:LOCAL_RANK, gloo with --device cpu")
    ap.add_argument("--asr-model", default=None,
                    help="local Whisper snapshot dir for alignment (else "
                         "the energy aligner is used)")
    return ap


def init_mesh(ap: argparse.ArgumentParser, args):
    """The process group and mesh of ``--mesh DATAxMODEL`` (None without
    it), from torchrun's RANK / WORLD_SIZE / LOCAL_RANK; sets args.device
    to this rank's card."""
    if args.mesh is None:
        return None
    try:
        n_data, n_model = (int(v) for v in args.mesh.lower().split("x"))
    except ValueError:
        ap.error(f"--mesh takes DATAxMODEL (e.g. 2x2), got {args.mesh!r}")
    env = [os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")]
    if None in env or int(env[1]) != n_data * n_model:
        ap.error(f"--mesh {args.mesh} needs {n_data * n_model} processes "
                 "under torchrun (python -m torch.distributed.run "
                 f"--nproc-per-node {n_data * n_model}), one per card")
    rank, world, local = (int(v) for v in env)
    import torch
    import torch.distributed as dist
    from voicecraft_tpu_torch.parallel.mesh import make_mesh
    if args.device == "cpu":
        dist.init_process_group("gloo", rank=rank, world_size=world)
    else:
        if not torch.cuda.is_available():
            ap.error("--device cuda, but no CUDA device is available (pass "
                     "--device cpu to run on the CPU)")
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
        dist.init_process_group("nccl", rank=rank, world_size=world)
    return make_mesh(n_data, n_model, args.device)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    spec = str(args.spec).strip().lower()
    if not (spec.startswith("auto") or spec.isdigit()):
        ap.error(f"--spec takes an integer TAU or auto[:T1,T2..], got "
                 f"{args.spec!r}")
    logging.basicConfig(level=logging.INFO)
    mesh = init_mesh(ap, args)
    try:
        engine = Engine(args, mesh)
    except RuntimeError as e:
        ap.error(str(e))
    if not engine.primary:
        engine.follow()
        return
    server = ThreadingHTTPServer((args.host, args.port), make_handler(engine))
    log.info("serving on http://%s:%d (%s)", args.host, args.port,
             engine.device)
    server.serve_forever()


if __name__ == "__main__":
    main()
