"""The port's copies of the app layer (voicecraft_tpu_torch/app.py,
utils/text_norm.py) against the JAX package's: the same strings and frames
on tests/test_app_logic.py's cases and on a seeded random sweep of numbers,
transcripts, word timings and edit spans."""

import numpy as np
import pytest

from voicecraft_tpu import app as japp
from voicecraft_tpu.utils import text_norm as jtn
from voicecraft_tpu_torch import app
from voicecraft_tpu_torch.utils import text_norm as tn

WORDS = [{"word": "the", "start": 0.10, "end": 0.25},
         {"word": "quick", "start": 0.30, "end": 0.62},
         {"word": "brown", "start": 0.66, "end": 0.95},
         {"word": "fox", "start": 1.00, "end": 1.30}]
VOCAB = ["the", "quick", "brown", "fox", "jumps", "over", "a", "lazy", "dog",
         "room", "call", "me", "at", "and"]


def _rng_text(rng, n):
    parts = []
    for _ in range(n):
        r = rng.random()
        if r < 0.3:
            parts.append(str(int(rng.integers(0, 10 ** int(rng.integers(1, 10))))))
        elif r < 0.4:
            parts.append(VOCAB[rng.integers(len(VOCAB))]
                         + str(int(rng.integers(0, 1000))))
        else:
            parts.append(VOCAB[rng.integers(len(VOCAB))])
        parts.append(rng.choice([" ", "  ", "\n", ". ", "! ", "? "]))
    return "".join(parts)


def _words(rng, n):
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.uniform(0.0, 0.2))
        d = float(rng.uniform(0.05, 0.5))
        out.append({"word": VOCAB[i % len(VOCAB)] + ("" if i % 3 else " "),
                    "start": t, "end": t + d})
        t += d
    return out


@pytest.mark.parametrize("n", [0, 7, 13, 20, 21, 99, 100, 101, 123, 1000,
                               1005, 1105, 2023, 1234567, -42, 10 ** 12 + 7])
def test_num_to_words_cases(n):
    assert tn.num_to_words(n) == jtn.num_to_words(n)


def test_text_norm_and_transcripts_random_sweep():
    rng = np.random.default_rng(0)
    for n in rng.integers(0, 10 ** 13, 300):
        assert tn.num_to_words(int(n)) == jtn.num_to_words(int(n))
    cases = ["call me at 42 tomorrow", "room101", "I  have 3 cats\nand 12 dogs",
             "One two. Three four! Five?\nSix seven.", "a b\nc d\n\n"]
    cases += [_rng_text(rng, int(rng.integers(1, 30))) for _ in range(100)]
    for text in cases:
        assert (tn.replace_numbers_with_words(text)
                == jtn.replace_numbers_with_words(text))
        assert app.normalize_transcript(text) == japp.normalize_transcript(text)
        for mode in ("Sentence", "Newline"):
            assert (app.split_sentences(text, mode)
                    == japp.split_sentences(text, mode))


def test_smart_transcripts_and_spans_random_sweep():
    rng = np.random.default_rng(1)
    sweeps = [(WORDS, t) for t in (0.64, 0.85, 0.70, 0.0, 2.0)]
    sweeps += [(_words(rng, int(rng.integers(1, 15))),
                float(rng.uniform(0, 4))) for _ in range(100)]
    for words, cut in sweeps:
        assert (app.smart_transcript_tts(words, cut, "jumps high")
                == japp.smart_transcript_tts(words, cut, "jumps high"))
        lo, hi = sorted(float(v) for v in rng.uniform(0, 4, 2))
        assert (app.smart_transcript_edit(words, lo, hi, "slow red")
                == japp.smart_transcript_edit(words, lo, hi, "slow red"))
    assert app.smart_transcript_edit(WORDS, 0.30, 0.95, "slow red") == \
        "the  slow redfox "
    for _ in range(300):
        s = float(rng.uniform(-0.2, 5))
        e = s + float(rng.uniform(0, 2))
        kw = dict(left_margin=float(rng.uniform(0, 0.2)),
                  right_margin=float(rng.uniform(0, 0.2)),
                  audio_dur=float(rng.uniform(1, 6)),
                  codec_sr=int(rng.choice([50, 75])))
        assert (app.morph_edit_span(s, e, **kw)
                == japp.morph_edit_span(s, e, **kw))
    assert app.morph_edit_span(0.01, 0.5, left_margin=0.08,
                               right_margin=0.08, audio_dur=2.0,
                               codec_sr=50) == (1, 29)


def test_words_info_from_rows():
    rows = [{"Label": "hi", "Begin": 0.1, "End": 0.3, "Type": "words"},
            {"Label": "sp", "Begin": 0.3, "End": 0.4, "Type": "phones"},
            {"Label": "there", "Begin": 0.4, "End": 0.8}]
    assert app.words_info_from_rows(rows) == japp.words_info_from_rows(rows)
    assert app.words_info_from_rows(rows) == [
        {"word": "hi", "start": 0.1, "end": 0.3},
        {"word": "there", "start": 0.4, "end": 0.8}]
