"""Forced alignment — the port of ``wav2letter_tpu/ops/align.py`` (the
reference's ``tools/Align`` op: per-sample word segments ``begin length
word`` with ``$`` for silence).

Viterbi through the constrained target graph (the free Viterbi is in
``ops/ctc.py``/``ops/asg.py``):
  * CTC: blank-interleaved extended targets (2U+1 states), transitions
    stay / advance-1 / skip-2 (skip only between distinct labels).
  * ASG: one state per target token, stay/advance scored by the criterion's
    transition matrix.

One loop over frames carrying (B, S) scores and keeping per-frame
backpointers, then a backtrace loop, as JAX's two scans; variable lengths
frozen with identity backpointers. Viterbi is invariant to per-frame
normalization, so raw logits are accepted.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _backtrace(last: torch.Tensor, bps) -> torch.Tensor:
    """States (B, T) from the final states and the per-frame state steps
    back (``bps[t - 1]`` at frame t)."""
    s = last
    states = [s]
    for bp in reversed(bps):
        s = s - bp.gather(1, s[:, None])[:, 0]
        states.append(s)
    return torch.stack(states[::-1], dim=1)


def _lengths(B, T, targets, emis_len, target_len):
    if emis_len is None:
        emis_len = torch.full((B,), T, dtype=torch.int32, device=targets.device)
    if target_len is None:
        target_len = (targets >= 0).sum(dim=1).to(torch.int32)
    return emis_len, target_len.long()


@torch.no_grad()
def ctc_forced_align(emissions: torch.Tensor, targets: torch.Tensor,
                     emis_len: Optional[torch.Tensor] = None,
                     target_len: Optional[torch.Tensor] = None,
                     blank: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best frame-level token path constrained to the target sequence.

    Returns (path (B, T) int32, the token per frame and the blank on pad
    frames; score (B,), the Viterbi log-score of the alignment)."""
    B, T, N = emissions.shape
    U = targets.shape[1]
    L = 2 * U + 1
    dev = emissions.device
    if blank is None:
        blank = N - 1
    emis_len, target_len = _lengths(B, T, targets, emis_len, target_len)
    tgt = torch.where(targets < 0, torch.full_like(targets, blank), targets).long()
    ext = torch.full((B, L), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = tgt
    pos = torch.arange(L, device=dev)[None, :]
    prev2 = F.pad(ext, (2, 0), value=-1)[:, :L]
    allow_skip = ((pos % 2) == 1) & (ext != prev2)
    valid = pos < (2 * target_len[:, None] + 1)
    em = emissions.float()
    em_ext = em.gather(2, ext[:, None, :].expand(B, T, L))  # (B, T, L)
    neg = torch.full_like(em_ext[:, 0], NEG_INF)
    score = torch.where((pos <= 1) & valid, em_ext[:, 0], neg)
    t_idx = torch.arange(T, device=dev)
    active = (t_idx[:, None] < emis_len[None, :])[..., None]  # (T, B, 1)
    bps = []
    for t in range(1, T):
        s1 = F.pad(score, (1, 0), value=NEG_INF)[:, :L]
        s2 = torch.where(allow_skip, F.pad(score, (2, 0), value=NEG_INF)[:, :L], neg)
        best, bp = torch.stack([score, s1, s2]).max(dim=0)
        new = torch.where(valid, best + em_ext[:, t], neg)
        score = torch.where(active[t], new, score)
        bps.append(torch.where(active[t], bp, torch.zeros_like(bp)))
    # final state: best of the last blank (2*tlen) and the last label (2*tlen - 1)
    fin_b = 2 * target_len
    fin_l = (2 * target_len - 1).clamp(min=0)
    sc_b = score.gather(1, fin_b[:, None])[:, 0]
    sc_l = score.gather(1, fin_l[:, None])[:, 0]
    last = torch.where(sc_b >= sc_l, fin_b, fin_l)
    states = _backtrace(last, bps)
    path = ext.gather(1, states)
    path = torch.where(t_idx[None, :] < emis_len[:, None], path, torch.full_like(path, blank))
    return path.to(torch.int32), torch.maximum(sc_b, sc_l)


@torch.no_grad()
def asg_forced_align(emissions: torch.Tensor, transitions: torch.Tensor,
                     targets: torch.Tensor, emis_len: Optional[torch.Tensor] = None,
                     target_len: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ASG forced alignment (states = target tokens, stay/advance with the
    criterion's transition matrix). Returns (path (B, T) int32, score (B,));
    pad frames repeat the label of the row's last frame."""
    B, T, N = emissions.shape
    U = targets.shape[1]
    dev = emissions.device
    emis_len, target_len = _lengths(B, T, targets, emis_len, target_len)
    tgt = targets.clamp(min=0).long()
    em = emissions.float()
    em_tgt = em.gather(2, tgt[:, None, :].expand(B, T, U))  # (B, T, U)
    trans = transitions.float()
    stay = trans[tgt, tgt]  # (B, U)
    prev = F.pad(tgt, (1, 0))[:, :U]
    adv = trans[tgt, prev]  # (B, U); adv[0] unused
    pos = torch.arange(U, device=dev)[None, :]
    valid = pos < target_len[:, None]
    neg = torch.full_like(em_tgt[:, 0], NEG_INF)
    score = torch.where(pos == 0, em_tgt[:, 0], neg)
    t_idx = torch.arange(T, device=dev)
    active = (t_idx[:, None] < emis_len[None, :])[..., None]
    bps = []
    for t in range(1, T):
        s1 = F.pad(score, (1, 0), value=NEG_INF)[:, :U]
        best, bp = torch.stack([score + stay, s1 + adv]).max(dim=0)
        new = torch.where(valid, best + em_tgt[:, t], neg)
        score = torch.where(active[t], new, score)
        bps.append(torch.where(active[t], bp, torch.zeros_like(bp)))
    last = (target_len - 1).clamp(min=0)
    align_score = score.gather(1, last[:, None])[:, 0]
    path = tgt.gather(1, _backtrace(last, bps))
    path = torch.where(t_idx[None, :] < emis_len[:, None], path, path[:, -1:])
    return path.to(torch.int32), align_score


def path_to_word_segments(path, token_dict, frame_sec: float, wordsep: str = "|",
                          blank: Optional[int] = None, sil_word: str = "$"):
    """Frame token path -> word segments [(begin_s, length_s, word)] with
    ``$`` silence entries, the reference Align output unit (consumed by the
    lm_analysis filter/shuffle scripts). A host-side copy of the JAX
    package's function.

    Words are delimited only by separator-token frames; CTC blanks between
    letters stay inside the word span, while blanks at word edges join the
    adjacent silence. Repeated frames of a token are one emission; a blank
    between equal tokens restarts the emission (CTC collapse semantics).
    """
    # 1. collapse into runs (token, start, end)
    runs = []
    for t, tok in enumerate(path):
        tok = int(tok)
        if runs and runs[-1][0] == tok:
            runs[-1][2] = t + 1
        else:
            runs.append([tok, t, t + 1])

    def kind(tok):
        if blank is not None and tok == blank:
            return "B"
        ch = token_dict.get_entry(tok) if 0 <= tok < len(token_dict) else ""
        return "S" if ch == wordsep else "C"

    # 2. split at separator runs into word groups; track char spans
    segs = []  # (begin_frame, end_frame, word)
    word_chars: list = []
    word_start = word_end = None

    def flush_word():
        nonlocal word_chars, word_start, word_end
        if word_chars:
            segs.append((word_start, word_end, "".join(word_chars)))
        word_chars, word_start, word_end = [], None, None

    for tok, s, e in runs:
        k = kind(tok)
        if k == "C":
            if word_start is None:
                word_start = s
            word_chars.append(token_dict.get_entry(tok))
            word_end = e
        elif k == "S":
            flush_word()
        # blanks: neutral; at word edges they fall into the silence gaps below
    flush_word()

    # 3. silence = gaps between word spans (covers separator + edge blanks)
    out = []
    cursor = 0
    for (s, e, w) in segs:
        if s > cursor:
            out.append((cursor * frame_sec, (s - cursor) * frame_sec, sil_word))
        out.append((s * frame_sec, (e - s) * frame_sec, w))
        cursor = e
    if cursor < len(path):
        out.append((cursor * frame_sec, (len(path) - cursor) * frame_sec, sil_word))
    return out
