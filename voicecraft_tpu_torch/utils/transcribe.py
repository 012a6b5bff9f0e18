"""Transcription glue (PyTorch port of voicecraft_tpu/utils/transcribe.py;
reference gradio_app.py:41-79 Whisper/WhisperX): transformers' Whisper from
a local snapshot directory (offline), on the caller's device, and the
sentence split of long-form TTS.  Word alignment for editing comes from
align.py (Whisper's token timestamps, or the energy aligner) or an external
aligner's CSV (edit_torch_cli.py --mfa-csv)."""

from __future__ import annotations

import re
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch


class WhisperTranscriber:
    """transformers Whisper ASR from the local snapshot ``model_path``, the
    model on ``device``."""

    def __init__(self, model_path: str, device="cuda"):
        from transformers import (WhisperForConditionalGeneration,
                                  WhisperProcessor)
        self.device = torch.device(device)
        self.processor = WhisperProcessor.from_pretrained(model_path)
        self.model = WhisperForConditionalGeneration.from_pretrained(
            model_path).to(self.device).eval()

    def transcribe(self, wav: np.ndarray, sample_rate: int = 16000) -> str:
        """The transcript of ``wav`` ([T], or [C, T] averaged to mono)."""
        if wav.ndim == 2:
            wav = wav.mean(axis=0)
        inputs = self.processor(wav, sampling_rate=sample_rate,
                                return_tensors="pt")
        with torch.no_grad():
            ids = self.model.generate(inputs.input_features.to(self.device))
        return self.processor.batch_decode(ids, skip_special_tokens=True)[0]


@lru_cache(maxsize=2)
def make_transcriber(model_path: Optional[str], device="cuda"):
    """A transcriber of the snapshot ``model_path`` on ``device``, memoized
    on both (the batch CLIs' --wer calls it once a row and seed), or an
    error that says what to pass when there is none."""
    if model_path is None:
        raise RuntimeError(
            "no ASR model configured: pass a local Whisper snapshot dir "
            "(e.g. downloaded openai/whisper-base) via --asr-model, or "
            "provide the transcript explicitly")
    return WhisperTranscriber(model_path, device)


def split_sentences(text: str) -> List[str]:
    """Split after '.', '!' or '?' followed by whitespace, dropping empty
    pieces (a dependency-free stand-in for nltk's sent_tokenize)."""
    parts = re.split(r"(?<=[.!?])\s+", text.strip())
    return [p for p in (s.strip() for s in parts) if p]
