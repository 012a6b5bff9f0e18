"""Text normalization for the app layer (a copy of
voicecraft_tpu/utils/text_norm.py, which imports no JAX).

The reference normalizes digits through the ``num2words`` package before
phonemizing (gradio_app.py:207-216).  That package isn't a dependency here;
``num_to_words`` reproduces its default English cardinal output (including
the British "and": num2words(123) == 'one hundred and twenty-three'), and
``replace_numbers_with_words`` reproduces the reference's regex pipeline
(space-pad digit runs, then word-substitute each).
"""

from __future__ import annotations

import re

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
           (10 ** 3, "thousand")]


def _below_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    t, o = divmod(n, 10)
    return _TENS[t] + (f"-{_ONES[o]}" if o else "")


def _below_1000(n: int) -> str:
    if n < 100:
        return _below_100(n)
    h, r = divmod(n, 100)
    if r == 0:
        return f"{_ONES[h]} hundred"
    return f"{_ONES[h]} hundred and {_below_100(r)}"


def num_to_words(num) -> str:
    """Integer (or digit string) -> English cardinal words, num2words-style
    (num2words(1005) == 'one thousand and five';
     num2words(1234567) == 'one million, two hundred and thirty-four '
                           'thousand, five hundred and sixty-seven')."""
    n = int(num)
    if n < 0:
        return "minus " + num_to_words(-n)
    if n < 1000:
        return _below_1000(n)
    parts = []
    for scale, name in _SCALES:
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append(f"{_below_1000(q)} {name}")
    out = ", ".join(parts)
    if n:
        # a final sub-hundred remainder joins with bare " and ", a larger
        # one with ", " (num2words en behaviour)
        out += (" and " if n < 100 else ", ") + _below_1000(n)
    return out


def replace_numbers_with_words(sentence: str) -> str:
    """Reference gradio_app.py:207-216: pad digit runs with spaces, then
    replace each with its word form (phonemizers handle words better)."""
    sentence = re.sub(r"(\d+)", r" \1 ", sentence)

    def sub(match):
        try:
            return num_to_words(match.group(0))
        except Exception:
            return match.group(0)

    return re.sub(r"\b\d+\b", sub, sentence)
