"""Transcript helpers (PyTorch port of voicecraft_tpu/utils/transcribe.py:
the sentence split of long-form TTS; Whisper transcription is not yet
ported)."""

from __future__ import annotations

import re
from typing import List


def split_sentences(text: str) -> List[str]:
    """Split after '.', '!' or '?' followed by whitespace, dropping empty
    pieces (a dependency-free stand-in for nltk's sent_tokenize)."""
    parts = re.split(r"(?<=[.!?])\s+", text.strip())
    return [p for p in (s.strip() for s in parts) if p]
