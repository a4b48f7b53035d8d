"""LM corpus preparation: the Gutenberg -> LM-corpus pipeline.

The port's copy of ``wav2letter_tpu/tools/corpus.py``, with the same functions
and outputs; where that imports its package it imports the port's
``ops/editdistance.py``.

Reference: ``recipes/sota/2019/raw_lm_corpus/*`` — Gutenberg text
normalization and dedup of books that overlap LibriVox/LibriSpeech audio
sources by fuzzy title match (``levenshtein-word.pl``), then vocab + corpus
assembly for LM training — and ``lm_corpus_and_PL_generation/*``: the
paragraph-marker skip, abbreviation/time/date preprocessing
(``preprocessing.py``), the full text normalization (``postprocessing.py``:
NFKD ascii folding, roman numerals, $-amounts, number->words spelling with
year-style reading, apostrophe merging), unique-line dedup, word
frequencies, and top-N kenlm vocab (``generate_uniq.py``,
``generate_frequencies.py``, ``generate_kenlm_vocab.py``). The reference
depends on ``num2words``/``roman``; equivalents are implemented natively
(``number_to_words``/``roman_to_int``), so that neither is a dependency.
"""

from __future__ import annotations

import re
import string
import unicodedata
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..ops.editdistance import edit_distance


def normalize_lm_text(text: str, keep_apostrophe: bool = True) -> str:
    """Lowercase, strip punctuation (keeping in-word apostrophes), collapse
    whitespace — the corpus normalization the LM recipes apply."""
    text = text.lower()
    if keep_apostrophe:
        text = re.sub(r"[^a-z' ]+", " ", text)
        text = re.sub(r"(?<![a-z])'|'(?![a-z])", " ", text)
    else:
        text = re.sub(r"[^a-z ]+", " ", text)
    return " ".join(text.split())


def normalize_title(title: str) -> List[str]:
    return normalize_lm_text(title, keep_apostrophe=False).split()


def title_match(a: str, b: str, max_dist_frac: float = 0.25) -> bool:
    """Fuzzy title equality via word-level levenshtein
    (``levenshtein-word.pl`` analog)."""
    wa, wb = normalize_title(a), normalize_title(b)
    if not wa or not wb:
        return False
    d = edit_distance(wa, wb)
    return d <= max_dist_frac * max(len(wa), len(wb))


def dedup_corpus_titles(
    corpus_titles: Sequence[str], exclude_titles: Sequence[str],
    max_dist_frac: float = 0.25,
) -> List[int]:
    """Indices of corpus entries that do NOT fuzzily match any excluded
    title (e.g. drop Gutenberg books whose audio appears in LibriSpeech)."""
    keep = []
    for i, t in enumerate(corpus_titles):
        if not any(title_match(t, e, max_dist_frac) for e in exclude_titles):
            keep.append(i)
    return keep


def build_vocab(
    corpus_lines: Iterable[str], max_words: int = 200000, min_count: int = 1
) -> List[str]:
    counts: Counter = Counter()
    for line in corpus_lines:
        counts.update(normalize_lm_text(line).split())
    items = [(w, c) for w, c in counts.items() if c >= min_count]
    items.sort(key=lambda x: (-x[1], x[0]))
    return [w for w, _ in items[:max_words]]


def write_lm_corpus(
    in_paths: Sequence[str], out_path: str, shuffle_seed: int = 0
) -> int:
    """Concatenate + normalize + shuffle sentence lines (reference
    ``prepare.py:124-147`` LM corpus shuffle)."""
    import random

    lines: List[str] = []
    for p in in_paths:
        with open(p) as f:
            for line in f:
                n = normalize_lm_text(line)
                if n:
                    lines.append(n)
    random.Random(shuffle_seed).shuffle(lines)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines)


# ---------------------------------------------------------------------------
# number / roman-numeral spelling (num2words + roman equivalents)
# ---------------------------------------------------------------------------

_ONES = ("zero one two three four five six seven eight nine ten eleven twelve "
         "thirteen fourteen fifteen sixteen seventeen eighteen nineteen").split()
_TENS = ("", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety")
_SCALES = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"),
           (100, "hundred")]
_ORD_IRREG = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _under_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    t, o = divmod(n, 10)
    return _TENS[t] + (" " + _ONES[o] if o else "")


def number_to_words(n: int) -> str:
    """Cardinal spelling (num2words ``to='cardinal'`` with hyphens/commas
    already collapsed to spaces, as postprocessing.py does)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 100:
        return _under_100(n)
    for scale, name in _SCALES:
        if n >= scale:
            head = number_to_words(n // scale) + " " + name
            rest = n % scale
            if not rest:
                return head
            joiner = " and " if scale == 100 else " "
            return head + joiner + number_to_words(rest)
    return _under_100(n)


def number_to_ordinal(n: int) -> str:
    """Ordinal spelling (num2words ``to='ordinal'``)."""
    words = number_to_words(n).split()
    last = words[-1]
    if last in _ORD_IRREG:
        words[-1] = _ORD_IRREG[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    else:
        words[-1] = last + "th"
    return " ".join(words)


def number_to_year(n: int) -> str:
    """Year-style reading (num2words ``to='year'``): 1984 -> "nineteen
    eighty four", 1905 -> "nineteen o five", 2000 -> "two thousand"."""
    if n < 1000 or n >= 10000:
        return number_to_words(n)
    hi, lo = divmod(n, 100)
    if lo == 0:
        if hi % 10 == 0:
            return number_to_words(n)  # 2000 -> two thousand
        return _under_100(hi) + " hundred"  # 1900 -> nineteen hundred
    if hi % 10 == 0 and lo < 10:
        return number_to_words(n)  # 2005 -> two thousand and five
    if lo < 10:
        return _under_100(hi) + " o " + _ONES[lo]  # 1905 -> nineteen o five
    return _under_100(hi) + " " + _under_100(lo)  # 2019 -> twenty nineteen


_ROMAN_VALS = [("M", 1000), ("CM", 900), ("D", 500), ("CD", 400), ("C", 100),
               ("XC", 90), ("L", 50), ("XL", 40), ("X", 10), ("IX", 9),
               ("V", 5), ("IV", 4), ("I", 1)]


def roman_to_int(s: str) -> int:
    """Strict roman numeral parse (``roman.fromRoman``); raises ValueError
    on malformed input (e.g. 'IIII', 'VX')."""
    if not s:
        raise ValueError("empty roman numeral")
    i, total = 0, 0
    for sym, val in _ROMAN_VALS:
        count = 0
        while s[i : i + len(sym)] == sym:
            total += val
            i += len(sym)
            count += 1
            if count > (3 if len(sym) == 1 and sym not in "VLD" else 1):
                raise ValueError(f"malformed roman numeral: {s}")
            if sym in "VLD" and count > 1:
                raise ValueError(f"malformed roman numeral: {s}")
    if i != len(s):
        raise ValueError(f"not a roman numeral: {s}")
    # round-trip check catches orderings the greedy scan accepts wrongly
    # (e.g. 'VIV' -> 9 but canonical 9 is 'IX'; roman.fromRoman raises too)
    if _int_to_roman(total) != s:
        raise ValueError(f"malformed roman numeral: {s}")
    return total


def _int_to_roman(n: int) -> str:
    out = []
    for sym, val in _ROMAN_VALS:
        q, n = divmod(n, val)
        out.append(sym * q)
    return "".join(out)


# ---------------------------------------------------------------------------
# Gutenberg corpus preprocessing (lm_corpus_and_PL_generation/preprocessing.py)
# ---------------------------------------------------------------------------

_TIME_DEGREE = {"min.": "minutes", "deg.": "degrees", "sec.": "seconds",
                "hrs.": "hours", "hr.": "hour"}
_ABBR = {"mr.": "mister", "mr": "mister", "dr.": "doctor", "dr": "doctor",
         "ms.": "miss", "ms": "miss", "mrs.": "missus", "mrs": "missus",
         "vs.": "versus", "vs": "versus", "st.": "saint", "st": "saint"}
_DIGITS = set("0123456789")


def preprocess_line(line: str) -> str:
    """Abbreviation/time/date expansion pass (``preprocessing.py``):
    `12 min.` -> `12 minutes`, `12:30` -> `12 30`, `3/4` -> `3 4`,
    `mr.` -> `mister`, `&c` -> `et cetera`."""
    out: List[str] = []
    prev = ""
    for word in re.sub(" +", " ", line.strip()).split():
        wl = word.lower()
        if wl in _TIME_DEGREE and _DIGITS & set(prev):
            out.append(_TIME_DEGREE[wl])
        elif word and not set(word) - (_DIGITS | {":"}):
            out.extend(p for p in word.split(":") if p != "")
        elif word and not set(word) - (_DIGITS | {"/"}):
            out.extend(p for p in word.split("/") if p != "")
        elif wl in _ABBR:
            out.append(_ABBR[wl])
        elif "&c" in word:
            out.append(word.replace("&c", " et cetera "))
        else:
            out.append(word)
        prev = word
    return re.sub(" +", " ", " ".join(out)).strip()


def skip_paragraph_markers(lines: Iterable[str]) -> List[str]:
    """Drop the ``<P>`` paragraph markers (``skip_paragraph.py``)."""
    return [l for l in (l.strip() for l in lines) if l != "<P>"]


_LOWER = set(string.ascii_lowercase)
_NUMSET = set("0123456789,")
_ROMANSET = set("IVXLCDM")
_ACCEPTED = _LOWER | {"'"}
_PUNCT = set(".,()[]!?")


def postprocess_line(text: str) -> str:
    """Full normalization (``postprocessing.py``): NFKD ascii folding,
    hyphen removal, & -> and, roman numerals -> digits (with the
    `Chapter I` heuristic for bare `I`), $amount -> `<amount> dollars`,
    numbers -> year-style words, ordinals (1st/2nd/...), abbreviations,
    keep only [a-z'] words, merge trailing-s and leading apostrophes."""
    nfkd = unicodedata.normalize("NFKD", text.strip())
    t = "".join(c for c in nfkd if not unicodedata.combining(c))
    t = t.replace("-", " ").replace("&", " and ")
    t = re.sub(" +", " ", t).strip()
    cleaned: List[str] = []
    words = t.split(" ")
    add_dollar = False
    for index, word in enumerate(words):
        if word == "":
            continue
        if not set(word) - _ROMANSET and (
            word != "I"
            or (index > 0 and words[index - 1] in ("Chapter", "CHAPTER"))
        ):
            try:
                word = str(roman_to_int(word))
            except ValueError:
                pass
        elif (len(word) > 1 and not set(word[:-1]) - _ROMANSET
              and word[-1] in _PUNCT):
            try:
                word = str(roman_to_int(word[:-1]))
            except ValueError:
                pass
        word = word.lower()
        if word == "$":
            add_dollar = True
            cleaned.append("dollars")
            continue
        if not set(word) - _NUMSET and word != ",":
            word = word.replace(",", "")
            if not add_dollar:
                cleaned.append(
                    number_to_year(int(word)).replace(" oh ", " o "))
            else:
                cleaned[-1] = number_to_words(int(word))
                cleaned.append("dollars")
                add_dollar = False
            continue
        add_dollar = False
        if (len(word) > 2 and not set(word[:-2]) - _NUMSET
                and word[-2:] in ("th", "st", "nd", "rd")):
            cleaned.append(number_to_ordinal(int(word[:-2].replace(",", ""))))
            continue
        if word in _ABBR:
            cleaned.append(_ABBR[word])
        elif set(word) & _LOWER:
            if not set(word) - _ACCEPTED:
                cleaned.append(word)
            elif word[-1] == "." and not set(word[:-1]) - _ACCEPTED:
                cleaned.append(word[:-1])
        elif word == "'":
            if (cleaned and len(cleaned[-1]) > 1 and cleaned[-1][-1] == "s"
                    and cleaned[-1][-2] != "'"):
                cleaned[-1] += word
    out = re.sub(" +", " ", " ".join(cleaned)).strip()
    if not out:
        return ""
    final: List[str] = []
    for word in out.split(" "):
        if word[0] != "'":
            final.append(word)
        elif final:
            final[-1] += word
    return " ".join(final).strip()


def unique_lines(lines: Iterable[str]) -> List[str]:
    """Order-preserving line dedup (``generate_uniq.py`` writes a set; we
    keep first-seen order so output is deterministic)."""
    seen = set()
    out = []
    for l in (l.strip() for l in lines):
        if l and l not in seen:
            seen.add(l)
            out.append(l)
    return out


def word_frequencies(lines: Iterable[str]) -> List[Tuple[str, int]]:
    """Word counts sorted by frequency desc (``generate_frequencies.py``)."""
    counts: Counter = Counter()
    for line in lines:
        counts.update(line.strip().split())
    return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))


def kenlm_vocab(freqs: Sequence[Tuple[str, int]], vocab_size: int) -> List[str]:
    """Top-N vocabulary for kenlm pruning (``generate_kenlm_vocab.py``)."""
    return [w for w, _ in freqs[:vocab_size]]


def prepare_gutenberg_corpus(
    in_paths: Sequence[str],
    out_path: str,
    exclude_titles: Sequence[str] = (),
    titles: Optional[Sequence[str]] = None,
    vocab_size: int = 200000,
) -> Dict[str, object]:
    """End-to-end pipeline: per-book {skip <P> -> preprocess -> postprocess}
    -> drop books fuzzily matching excluded titles -> dedup lines -> corpus
    file + frequency list + top-N vocab (the raw_lm_corpus +
    lm_corpus_and_PL_generation workflow in one call)."""
    kept_lines: List[str] = []
    n_dropped_books = 0
    for bi, p in enumerate(in_paths):
        if titles is not None and exclude_titles:
            if any(title_match(titles[bi], e) for e in exclude_titles):
                n_dropped_books += 1
                continue
        with open(p, encoding="utf-8", errors="replace") as f:
            for line in skip_paragraph_markers(f):
                line = postprocess_line(preprocess_line(line))
                if line:
                    kept_lines.append(line)
    lines = unique_lines(kept_lines)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    freqs = word_frequencies(lines)
    return {
        "n_lines": len(lines),
        "n_dropped_books": n_dropped_books,
        "frequencies": freqs,
        "vocab": kenlm_vocab(freqs, vocab_size),
    }
