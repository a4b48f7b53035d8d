"""Transcript -> token-id target encoding.

Mirrors the reference's input/target transform pipeline
(``TargetGenerationConfig`` + ``targetFeatures``/``wordFeatures``,
``cpc/Train.cpp:728-754``):

  word sequence → per-word lexicon spelling (optionally sampled among the
  word's spellings with prob ``--sampletarget``) → flat token list →
  word-separator handling (``--wordseparator``, ``--usewordpiece``) →
  optional surround token (``--surround``) → ASG replabel packing → ids.

Fallback for OOV words when no lexicon entry exists: spell the word as
characters (reference letter-recipes behavior).
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence

from .dictionary import Dictionary, Lexicon, pack_replabels


@dataclasses.dataclass
class TargetOptions:
    word_separator: str = "|"
    use_wordpiece: bool = False
    surround: str = ""
    replabel: int = 0
    sample_target: float = 0.0
    criterion: str = "ctc"
    # size of the token dict before replabels were appended (for packing)
    base_dict_size: int = 0
    fallback_to_letters: bool = True


def spell_word(
    word: str,
    lexicon: Optional[Lexicon],
    opts: TargetOptions,
    rng: Optional[random.Random] = None,
) -> List[str]:
    if lexicon is not None and word in lexicon:
        sample = bool(
            opts.sample_target > 0.0
            and (rng or random).random() < opts.sample_target
        )
        sp = lexicon.spelling(word, sample=sample, rng=rng)
        assert sp is not None
        return list(sp)
    if opts.fallback_to_letters:
        return list(word)
    raise KeyError(f"word not in lexicon: {word!r}")


def encode_transcript(
    words: Sequence[str],
    token_dict: Dictionary,
    lexicon: Optional[Lexicon],
    opts: TargetOptions,
    rng: Optional[random.Random] = None,
) -> List[int]:
    toks: List[str] = []
    for i, w in enumerate(words):
        sp = spell_word(w, lexicon, opts, rng)
        toks.extend(sp)
        if not opts.use_wordpiece and opts.word_separator and i < len(words) - 1:
            if not (sp and sp[-1] == opts.word_separator):
                toks.append(opts.word_separator)
    if opts.surround:
        if not toks or toks[0] != opts.surround:
            toks.insert(0, opts.surround)
        if not toks or toks[-1] != opts.surround:
            toks.append(opts.surround)
    ids = [token_dict.get_index(t) for t in toks if token_dict.contains(t) or True]
    if opts.criterion == "asg" and opts.replabel > 0:
        ids = pack_replabels(ids, opts.replabel, opts.base_dict_size)
    return ids


def tokens_to_words(
    tokens: Sequence[str], word_separator: str, use_wordpiece: bool = False
) -> List[str]:
    """Token string sequence -> word list (reference ``tkn2Wrd``)."""
    if use_wordpiece:
        text = "".join(tokens)
        return [w for w in text.split(word_separator) if w]
    words: List[str] = []
    cur: List[str] = []
    for t in tokens:
        if t == word_separator:
            if cur:
                words.append("".join(cur))
                cur = []
        else:
            cur.append(t)
    if cur:
        words.append("".join(cur))
    return words
