"""Text -> phone-symbol tokenization (port of voicecraft_tpu/data/phonemes.py;
plain Python, the same symbols and ids).

The reference phonemizes with the phonemizer library's espeak backend
(data/tokenizer.py:33-87: IPA, punctuation preserved, word separator '_',
then a regex split into single phone symbols).  Backends in preference
order: the ``phonemizer`` package, an ``espeak-ng``/``espeak`` subprocess,
and a grapheme fallback (characters as symbols), which suits smoke runs
and custom-vocab models but not the published checkpoints (their vocab is
espeak IPA).
"""

from __future__ import annotations

import re
import shutil
import subprocess
from typing import Dict, List, Sequence


def split_phones(phonemized: str, word_sep: str = "_",
                 phone_sep: str = "|") -> List[str]:
    """Split a phonemized string into phone symbols and word separators
    (reference TextTokenizer.to_list, data/tokenizer.py:61-73)."""
    fields: List[str] = []
    for word in phonemized.split(word_sep):
        pp = re.findall(r"\w+|[^\w\s]", word, re.UNICODE)
        fields.extend([p for p in pp if p != phone_sep] + [word_sep])
    return fields[:-1]


class PhonemizerBackend:
    """phonemizer-library backend (as the reference)."""

    def __init__(self, language: str = "en-us"):
        from phonemizer.backend import EspeakBackend
        from phonemizer.punctuation import Punctuation
        from phonemizer.separator import Separator
        self.separator = Separator(word="_", syllable="-", phone="|")
        self.backend = EspeakBackend(
            language, punctuation_marks=Punctuation.default_marks(),
            preserve_punctuation=True, with_stress=False, tie=False,
            language_switch="keep-flags", words_mismatch="ignore")

    def phonemize(self, text: str) -> List[str]:
        out = self.backend.phonemize([text.strip()], separator=self.separator,
                                     strip=True, njobs=1)[0]
        return split_phones(out, self.separator.word, self.separator.phone)


class EspeakCliBackend:
    """espeak-ng subprocess backend: ``espeak-ng -q --ipa -v <lang>``."""

    def __init__(self, language: str = "en-us"):
        self.binary = shutil.which("espeak-ng") or shutil.which("espeak")
        if self.binary is None:
            raise RuntimeError("espeak binary not found")
        self.language = language

    def phonemize(self, text: str) -> List[str]:
        out = subprocess.run(
            [self.binary, "-q", "--ipa", "-v", self.language, text.strip()],
            capture_output=True, text=True, check=True).stdout.strip()
        # espeak separates words with spaces; map to the reference's '_'
        return split_phones(out.replace(" ", "_"))


class GraphemeBackend:
    """Character-level fallback: lowercase letters/digits/punctuation as
    symbols, '_' as the word separator."""

    def __init__(self, language: str = "en-us"):
        self.language = language

    def phonemize(self, text: str) -> List[str]:
        fields: List[str] = []
        for w in text.strip().lower().split():
            fields.extend(re.findall(r"\w|[^\w\s]", w, re.UNICODE))
            fields.append("_")
        return fields[:-1]


def make_text_tokenizer(language: str = "en-us", backend: str = "auto"):
    """The first backend of ``backend`` ("auto": all in order) that loads."""
    if backend in ("auto", "phonemizer"):
        try:
            return PhonemizerBackend(language)
        except Exception:
            if backend == "phonemizer":
                raise
    if backend in ("auto", "espeak"):
        try:
            return EspeakCliBackend(language)
        except Exception:
            if backend == "espeak":
                raise
    return GraphemeBackend(language)


def phones_to_ids(phones: Sequence[str], phn2num: Dict[str, int],
                  drop_unknown: bool = True) -> List[int]:
    """Map phone symbols to vocab ids, dropping symbols not in the vocab
    (reference inference_tts_scale.py:45-51)."""
    if drop_unknown:
        return [phn2num[p] for p in phones if p in phn2num]
    return [phn2num[p] for p in phones]


def build_vocab(all_phones: Sequence[Sequence[str]]) -> Dict[str, int]:
    """A phn2num vocab in first-seen order (reference
    data/phonemize_encodec_encode_hf.py:119-125)."""
    vocab: Dict[str, int] = {}
    for phones in all_phones:
        for p in phones:
            vocab.setdefault(p, len(vocab))
    return vocab
