"""Lexicon trie with score smearing: the port's copy of
``wav2letter_tpu/decoder/trie.py``.

Reference: ``fl::lib::text::Trie`` built from the lexicon with per-word LM
unigram scores then smeared (``SmearingMode::MAX/LOGADD``) so the decoder can
upper-bound the best completion below each node
(``inference/decoder/Decoder.cpp:73-94``).
"""

from __future__ import annotations

import enum
import math
from typing import Dict, List, Optional


class SmearingMode(enum.Enum):
    NONE = "none"
    MAX = "max"
    LOGADD = "logadd"


class TrieNode:
    __slots__ = ("children", "labels", "scores", "max_score")

    def __init__(self):
        self.children: Dict[int, "TrieNode"] = {}
        self.labels: List[int] = []  # word indices ending here
        self.scores: List[float] = []  # per-label scores (LM unigram)
        self.max_score: float = 0.0  # smeared

    def child(self, tok: int) -> Optional["TrieNode"]:
        return self.children.get(tok)


class Trie:
    def __init__(self, n_tokens: int, root_idx: int = -1):
        self.n_tokens = n_tokens
        self.root = TrieNode()

    def insert(self, spelling: List[int], word_idx: int, score: float) -> TrieNode:
        node = self.root
        for t in spelling:
            if t < 0 or t >= self.n_tokens:
                raise ValueError(f"token id {t} out of range")
            nxt = node.children.get(t)
            if nxt is None:
                nxt = TrieNode()
                node.children[t] = nxt
            node = nxt
        node.labels.append(word_idx)
        node.scores.append(score)
        return node

    def search(self, spelling: List[int]) -> Optional[TrieNode]:
        node = self.root
        for t in spelling:
            node = node.children.get(t)
            if node is None:
                return None
        return node

    def smear(self, mode: SmearingMode) -> None:
        """Bottom-up: node.max_score = max/logadd over own labels' scores and
        children's smeared scores (flashlight Trie::smear semantics)."""
        if mode == SmearingMode.NONE:
            return
        # iterative post-order (lexicon tries exceed Python's recursion limit)
        stack = [(self.root, False)]
        while stack:
            node, done = stack.pop()
            if not done:
                stack.append((node, True))
                for c in node.children.values():
                    stack.append((c, False))
                continue
            vals = list(node.scores)
            for c in node.children.values():
                vals.append(c.max_score)
            if not vals:
                node.max_score = -math.inf
            elif mode == SmearingMode.MAX:
                node.max_score = max(vals)
            else:
                m = max(vals)
                node.max_score = m + math.log(sum(math.exp(v - m) for v in vals))
