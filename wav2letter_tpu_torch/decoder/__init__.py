"""Beam-search decoding of CTC emissions: n-gram LMs and the ConvLM
(``decoder.convlm``, a neural LM on the device), the lexicon trie, the
Python beam (the reference the native decoder is held against) and, in
``decoder.native``, the native C++ beam decoder; the seq2seq beams, with the
decoder in the loop, in ``decoder.seq2seq_beam`` (Python) and
``decoder.s2s_native`` (native)."""

from .lm import LM, ZeroLM, KenLM, ArpaLM
from .trie import Trie, TrieNode, SmearingMode
from .beam import (
    CriterionType,
    DecodeResult,
    DecoderOptions,
    LexiconDecoder,
    LexiconFreeDecoder,
)

__all__ = [
    "LM",
    "ZeroLM",
    "KenLM",
    "ArpaLM",
    "Trie",
    "TrieNode",
    "SmearingMode",
    "CriterionType",
    "DecodeResult",
    "DecoderOptions",
    "LexiconDecoder",
    "LexiconFreeDecoder",
]
