"""Token dictionaries, lexicons, and ASG replabel packing.

Reference behavior being matched:
  * tokens file: one token per line, index = line number (SURVEY.md App. B.2).
  * CTC blank appended LAST to the token dict (``cpc/Train.cpp:409-412``).
  * ASG replabels ``<1>..<R>`` appended (``cpc/Train.cpp:406-408``); packing
    turns runs of a repeated token into replabel ids, unpacking reverses it
    (decode-side unpacking evidenced at
    ``recipes/streaming_convnets/inference/decoder/Decoder.cpp:189-225``).
  * lexicon: TSV ``word \t tok tok ...``, multiple spellings per word allowed
    (``recipes/conv_glu/librispeech/prepare.py:79-84``).
  * ``loadWords(file, maxword)`` / ``createWordDict`` with ``<unk>``
    (``cpc/Train.cpp:404-436``).
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional, Sequence

UNK_TOKEN = "<unk>"
EOS_TOKEN = "</s>"
PAD_TOKEN = "<pad>"
BLANK_TOKEN = "#"  # reference uses '#' for the CTC blank symbol


class Dictionary:
    """Bidirectional token<->index map; index = insertion order."""

    def __init__(self, tokens: Optional[Iterable[str]] = None):
        self._tok2idx: Dict[str, int] = {}
        self._idx2tok: List[str] = []
        self._default_index: Optional[int] = None
        if tokens is not None:
            for t in tokens:
                self.add_entry(t)

    @classmethod
    def from_file(cls, path: str) -> "Dictionary":
        d = cls()
        with open(path) as f:
            for line in f:
                tok = line.strip().split()[0] if line.strip() else ""
                if tok:
                    d.add_entry(tok)
        return d

    def add_entry(self, token: str) -> int:
        if token in self._tok2idx:
            return self._tok2idx[token]
        idx = len(self._idx2tok)
        self._tok2idx[token] = idx
        self._idx2tok.append(token)
        return idx

    def set_default_index(self, idx: int) -> None:
        self._default_index = idx

    def get_index(self, token: str) -> int:
        if token in self._tok2idx:
            return self._tok2idx[token]
        if self._default_index is not None:
            return self._default_index
        raise KeyError(f"token not in dictionary: {token!r}")

    def get_entry(self, idx: int) -> str:
        return self._idx2tok[idx]

    def contains(self, token: str) -> bool:
        return token in self._tok2idx

    def __contains__(self, token: str) -> bool:
        return token in self._tok2idx

    def __len__(self) -> int:
        return len(self._idx2tok)

    def entries(self) -> List[str]:
        return list(self._idx2tok)

    def map_tokens(self, tokens: Sequence[str]) -> List[int]:
        return [self.get_index(t) for t in tokens]

    def map_indices(self, idxs: Sequence[int]) -> List[str]:
        return [self.get_entry(int(i)) for i in idxs]

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for t in self._idx2tok:
                f.write(t + "\n")


def make_token_dict(
    tokens_path: str, criterion: str, replabel: int = 0, eos: bool = False
) -> Dictionary:
    """Build the token dict with criterion-dependent extras.

    Order matches the reference exactly (``cpc/Train.cpp:404-418``):
    replabels ``<1>..<R>`` for ASG, then blank LAST for CTC; eos/pad for s2s.
    """
    d = Dictionary.from_file(tokens_path)
    if criterion == "asg":
        for r in range(1, replabel + 1):
            d.add_entry(f"<{r}>")
    if criterion == "ctc":
        d.add_entry(BLANK_TOKEN)
    if eos or criterion in ("seq2seq", "transformer"):
        d.add_entry(EOS_TOKEN)
    if criterion in ("seq2seq", "transformer"):
        d.add_entry(PAD_TOKEN)
    return d


def pack_replabels(tokens: Sequence[int], replabel: int, dict_size_before: int) -> List[int]:
    """Replace runs ``a a a`` with ``a <2>`` etc. Replabel ids come right
    after the base token set: ``<r>`` has index ``dict_size_before + r - 1``.
    """
    if replabel <= 0:
        return list(tokens)
    out: List[int] = []
    i = 0
    n = len(tokens)
    while i < n:
        t = tokens[i]
        run = 1
        while i + run < n and tokens[i + run] == t and run <= replabel:
            run += 1
        out.append(t)
        reps = run - 1
        if reps > 0:
            out.append(dict_size_before + reps - 1)
        i += run
    return out


def unpack_replabels(tokens: Sequence[int], replabel: int, dict_size_before: int) -> List[int]:
    out: List[int] = []
    for t in tokens:
        r = t - dict_size_before + 1
        if 1 <= r <= replabel and out:
            out.extend([out[-1]] * r)
        else:
            out.append(t)
    return out


class Lexicon:
    """word -> list of spellings (each a list of token strings)."""

    def __init__(self):
        self.entries: Dict[str, List[List[str]]] = {}

    @classmethod
    def from_file(cls, path: str, max_words: int = -1) -> "Lexicon":
        lx = cls()
        nwords = 0
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line.strip():
                    continue
                if "\t" in line:
                    word, spelling = line.split("\t", 1)
                else:
                    parts = line.split()
                    word, spelling = parts[0], " ".join(parts[1:])
                toks = spelling.split()
                if word not in lx.entries:
                    if max_words >= 0 and nwords >= max_words:
                        continue
                    lx.entries[word] = []
                    nwords += 1
                lx.entries[word].append(toks)
        return lx

    def words(self) -> List[str]:
        return list(self.entries.keys())

    def spellings(self, word: str) -> List[List[str]]:
        return self.entries.get(word, [])

    def spelling(self, word: str, sample: bool = False, rng: Optional[random.Random] = None) -> Optional[List[str]]:
        sp = self.entries.get(word)
        if not sp:
            return None
        if sample and len(sp) > 1:
            return (rng or random).choice(sp)
        return sp[0]

    def __contains__(self, word: str) -> bool:
        return word in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for w, sps in self.entries.items():
                for sp in sps:
                    f.write(f"{w}\t{' '.join(sp)}\n")


def make_word_dict(lexicon: Lexicon) -> Dictionary:
    """Reference ``createWordDict``: word list + <unk> with default index."""
    d = Dictionary(lexicon.words())
    unk = d.add_entry(UNK_TOKEN)
    d.set_default_index(unk)
    return d
