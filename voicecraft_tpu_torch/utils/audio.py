"""WAV I/O and resampling (port of voicecraft_tpu/utils/audio.py; numpy and
scipy, the same samples).

Replaces the reference's torchaudio.load / convert_audio
(data/tokenizer.py:89-99, 137-149) with a RIFF reader, stdlib ``wave`` and
scipy polyphase resampling.  Reads 8/16/24/32-bit PCM and IEEE float WAV.
"""

from __future__ import annotations

import contextlib
import struct
import wave
from fractions import Fraction
from typing import Tuple

import numpy as np


def _read_riff(path):
    """(fmt_code, n_ch, sr, bits, data) of a RIFF/WAVE file (a path, or a
    binary file object); stdlib ``wave`` rejects IEEE-float files, which
    the demo wavs are."""
    with (contextlib.nullcontext(path) if hasattr(path, "read")
          else open(path, "rb")) as f:
        hdr = f.read(12)
        assert hdr[:4] == b"RIFF" and hdr[8:12] == b"WAVE", path
        fmt = data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            payload = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload
        assert fmt is not None and data is not None, path
        code, n_ch, sr, _, _, bits = fmt
        if code == 0xFFFE and len(payload) >= 24:  # WAVE_FORMAT_EXTENSIBLE
            code = struct.unpack("<H", payload[24:26])[0] if len(payload) >= 26 else 1
        return code, n_ch, sr, bits, data


def read_wav(path) -> Tuple[np.ndarray, int]:
    """A WAV file (a path or a binary file object) -> (float32 [channels, T]
    in [-1, 1], sample_rate)."""
    code, n_ch, sr, bits, raw = _read_riff(path)
    if code == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        data = np.frombuffer(raw, dtype=dt).astype(np.float32)
        return data.reshape(-1, n_ch).T.copy(), sr
    width = bits // 8
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width: {width}")
    return data.reshape(-1, n_ch).T.copy(), sr


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """Write float32 [T] or [channels, T] audio as 16-bit PCM WAV."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    pcm = np.round(np.clip(wav.T, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as wf:
        wf.setnchannels(wav.shape[0])
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(pcm.tobytes())


def resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis."""
    if sr == target_sr:
        return wav
    from scipy.signal import resample_poly
    frac = Fraction(target_sr, sr)
    return resample_poly(wav, frac.numerator, frac.denominator,
                         axis=-1).astype(np.float32)


def convert_audio(wav: np.ndarray, sr: int, target_sr: int,
                  target_channels: int = 1) -> np.ndarray:
    """Channel conversion and resampling (reference data/tokenizer.py:89-99)."""
    assert wav.ndim == 2, wav.shape
    if target_channels == 1:
        wav = wav.mean(axis=0, keepdims=True)
    elif wav.shape[0] == 1:
        wav = np.broadcast_to(wav, (target_channels, wav.shape[1])).copy()
    return resample(wav, sr, target_sr)


def load_audio(path, target_sr: int, offset: int = -1,
               num_frames: int = -1) -> np.ndarray:
    """Load, downmix to mono and resample, with an optional window in
    source-rate samples (reference tokenize_audio, data/tokenizer.py:137-149)."""
    wav, sr = read_wav(path)
    if offset != -1 and num_frames != -1:
        wav = wav[:, offset:offset + num_frames]
    return convert_audio(wav, sr, target_sr, 1)
