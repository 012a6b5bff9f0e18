"""App-layer logic of the web UI / HTTP server (serve_torch_cli.py); a copy
of voicecraft_tpu/app.py, which imports no JAX.

Pure, testable ports of the reference gradio app's behaviour
(its gradio_app.py):

  * smart transcript construction — stitching the prompt's transcribed words
    ahead of (and, for edits, after) the typed text (gradio_app.py:254-296)
  * sentence splitting for Long TTS (gradio_app.py:230-236)
  * number normalization before phonemization (gradio_app.py:207-216,
    via utils/text_norm.py)
  * edit-span morphing: margins with the 1/codec_sr floor and audio-duration
    ceiling, rounded to codec frames (gradio_app.py:301-303)

``words_info`` rows are dicts {"word", "start", "end"} — the shape the
reference's whisper/whisperx transcribe_state carries (gradio_app.py:62-77);
voicecraft_tpu_torch.align produces compatible rows via
``words_info_from_rows``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

from .utils.text_norm import replace_numbers_with_words

_WHITESPACE_RE = re.compile(r"\s+")


def normalize_transcript(text: str) -> str:
    """Number-to-word + whitespace collapse (gradio_app.py:227, 272)."""
    text = replace_numbers_with_words(text).replace("  ", " ").replace("  ", " ")
    return _WHITESPACE_RE.sub(" ", text).strip()


def split_sentences(text: str, split_text: str = "Sentence") -> List[str]:
    """Long TTS sentence split (gradio_app.py:230-236): by newline, or by
    sentence boundary (delegates to utils.transcribe.split_sentences — one
    copy of the regex)."""
    if split_text == "Newline":
        return [s for s in (p.strip() for p in text.split("\n")) if s]
    from .utils.transcribe import split_sentences as _split
    return _split(text.replace("\n", " "))


def words_info_from_rows(rows: Sequence[Dict]) -> List[Dict]:
    """MFA-shaped alignment rows (voicecraft_tpu_torch.align) ->
    whisper-style words_info dicts."""
    return [{"word": r["Label"], "start": float(r["Begin"]),
             "end": float(r["End"])} for r in rows
            if r.get("Type", "words") == "words"]


def smart_transcript_tts(words_info: Sequence[Dict], prompt_end_time: float,
                         sentence: str) -> Tuple[str, float]:
    """TTS/Long-TTS smart transcript (gradio_app.py:256-268): words fully
    before the prompt cut are kept; a word straddling the cut is kept (and
    the cut moved to its end) if its midpoint is before the cut.  Returns
    (target_transcript, adjusted_prompt_end_time)."""
    target = ""
    for w in words_info:
        word = w["word"]
        if w["end"] < prompt_end_time:
            target += word + ("" if word.endswith(" ") else " ")
        elif (w["start"] + w["end"]) / 2 < prompt_end_time:
            target += word + ("" if word.endswith(" ") else " ")
            prompt_end_time = w["end"]
            break
        else:
            break
    return target + f" {sentence}", prompt_end_time


def smart_transcript_edit(words_info: Sequence[Dict], edit_start_time: float,
                          edit_end_time: float, sentence: str) -> str:
    """Edit-mode smart transcript (gradio_app.py:284-296): words starting
    before the edit window, then the typed replacement, then words ending
    after the window."""
    target = ""
    for w in words_info:
        if w["start"] < edit_start_time:
            target += w["word"] + ("" if w["word"].endswith(" ") else " ")
        else:
            break
    target += f" {sentence}"
    for w in words_info:
        if w["end"] > edit_end_time:
            target += w["word"] + ("" if w["word"].endswith(" ") else " ")
    return target


def morph_edit_span(edit_start: float, edit_end: float, *, left_margin: float,
                    right_margin: float, audio_dur: float, codec_sr: int
                    ) -> Tuple[int, int]:
    """Margins + clamps + frame rounding (gradio_app.py:301-303 ==
    inference_speech_editing_scale.py:196-197): floor at one codec frame,
    ceil at the audio duration, round() to frames."""
    s = max(edit_start - left_margin, 1.0 / codec_sr)
    e = min(edit_end + right_margin, audio_dur)
    return round(s * codec_sr), round(e * codec_sr)
