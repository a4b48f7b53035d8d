"""Auto-Segmentation (ASG) criterion — the port of ``wav2letter_tpu/ops/asg.py``
(Collobert et al., "Wav2Letter: an End-to-End ConvNet-based Speech
Recognition System"):

    loss = FCC - FAL
    FAL  (forced alignment): log-sum over alignments of the target sequence,
    FCC  (fully connected):  log-sum over ALL label sequences,
    both with bigram transition scores trans[i, j] = score(j -> i).

The JAX package runs both as ``lax.scan`` recursions over time and takes the
gradients by autodiff through the scan. Here each is a loop over frames with
(B, U) or (B, N, N) state inside a ``torch.autograd.Function`` whose backward
is the adjoint loop over the same frames, with the weights JAX's autodiff
gives each log-sum (the gradients of the same arithmetic, to rounding). The
log-space constant is JAX's finite ``NEG_INF = -1e30`` and the log-sum is
JAX's ``max + log(sum(exp(x - max)))``,
not ``-inf`` and ``torch.logaddexp``: where every candidate is -1e30 (a padded
target slot, an alignment that cannot fit its frames) the value stays finite
and the gradient splits evenly, as JAX's does, where ``-inf`` would give NaN.
Rows freeze past ``emis_len``, and FAL's slots past ``target_len`` never feed
the slot it reads.

Every frame is a handful of small launches (forward FAL 12, FCC 8; backward
4 and 2), so on a card the loss is bound by the host's launch rate, not by the
device.

viterbiPath for ASG = max-product FCC with a backpointer backtrace (the greedy
decode of ``Test.cpp:325``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.dictionary import unpack_replabels

NEG_INF = -1e30


def _lse(*xs: torch.Tensor) -> torch.Tensor:
    m = xs[0]
    for x in xs[1:]:
        m = torch.maximum(m, x)
    s = torch.exp(xs[0] - m)
    for x in xs[1:]:
        s = s + torch.exp(x - m)
    return m + torch.log(s)


def _active(T: int, emis_len: torch.Tensor) -> torch.Tensor:
    """(T, B, 1) bool: frame t of row b is inside its ``emis_len``."""
    t = torch.arange(T, device=emis_len.device)
    return (t[:, None] < emis_len[None, :])[..., None]


class _FalRecursion(torch.autograd.Function):
    """FAL's alpha over frames: (B, T, U) target emissions, (B, U) self and
    (B, U-1) step transitions -> the last frame's alpha (B, U).

    The backward is the adjoint recursion of the forward loop, step for step:
    an alpha slot's gradient goes to the two slots its log-sum read, weighted
    by ``exp(x - max) / sum``, the weights JAX's autodiff of ``_lse`` gives
    (0.5 each where both candidates are -1e30). The weights of every frame
    are computed at once from the saved alphas, so a frame costs 4 launches
    backward instead of autograd's ~25."""

    @staticmethod
    def forward(ctx, em_tgt, self_tr, step_tr, active):
        U = em_tgt.shape[2]
        upos = torch.arange(U, device=em_tgt.device)[None, :]
        alpha = torch.where(upos == 0, em_tgt[:, 0], torch.full_like(em_tgt[:, 0], NEG_INF))
        alphas = [alpha]
        for t in range(1, em_tgt.shape[1]):
            stay = alpha + self_tr
            move = F.pad(alpha[:, :-1] + step_tr, (1, 0), value=NEG_INF)
            alpha = torch.where(active[t], _lse(stay, move) + em_tgt[:, t], alpha)
            alphas.append(alpha)
        ctx.save_for_backward(torch.stack(alphas), self_tr, step_tr, active)
        return alpha

    @staticmethod
    def backward(ctx, g):
        alphas, self_tr, step_tr, active = ctx.saved_tensors
        prev = alphas[:-1]  # (T-1, B, U): the alphas each step read
        stay = prev + self_tr
        move = F.pad(prev[..., :-1] + step_tr, (1, 0), value=NEG_INF)
        m = torch.maximum(stay, move)
        e_stay, e_move = torch.exp(stay - m), torch.exp(move - m)
        total = e_stay + e_move
        w_stay, w_move = e_stay / total, e_move / total
        grads = [g]
        for t in range(alphas.shape[0] - 1, 0, -1):
            gp = g * w_stay[t - 1]
            gp[:, :-1] += (g * w_move[t - 1])[:, 1:]
            g = torch.where(active[t], gp, g)
            grads.append(g)
        G = torch.stack(grads[::-1])  # (T, B, U): d out / d alpha_t
        live = G[1:] * active[1:]  # what reached each step's log-sum
        g_em = torch.cat([G[:1] * (torch.arange(G.shape[2], device=G.device) == 0), live])
        g_self = (live * w_stay).sum(0)
        g_step = (live * w_move)[..., 1:].sum(0)
        return g_em.transpose(0, 1), g_self, g_step, None


class _FccRecursion(torch.autograd.Function):
    """FCC over frames: (B, T, N) emissions, (N, N) transitions -> (B,) the
    log-sum over all label sequences. The backward is the adjoint recursion
    (a (B, N) x (B, N, N) product a frame, with JAX's autodiff weights
    ``exp(z - max) / sum``, computed for every frame at once from the saved
    alphas): 2 launches a frame instead of autograd's ~15."""

    @staticmethod
    def forward(ctx, em, trans, active):
        tr = trans[None]  # (1, N_to, N_from)
        alpha = em[:, 0]
        alphas = [alpha]
        for t in range(1, em.shape[1]):
            z = alpha[:, None, :] + tr  # (B, N_to, N_from)
            m = z.amax(dim=-1)
            new = m + torch.log(torch.exp(z - m[..., None]).sum(dim=-1)) + em[:, t]
            alpha = torch.where(active[t], new, alpha)
            alphas.append(alpha)
        m = alpha.amax(dim=-1)
        e = torch.exp(alpha - m[:, None])
        s = e.sum(dim=-1)
        ctx.save_for_backward(torch.stack(alphas), trans, active, e / s[:, None])
        return m + torch.log(s)

    @staticmethod
    def backward(ctx, g_out):
        alphas, trans, active, p_last = ctx.saved_tensors
        z = alphas[:-1, :, None, :] + trans  # (T-1, B, N_to, N_from)
        e = torch.exp(z - z.amax(dim=-1, keepdim=True))
        W = e / e.sum(dim=-1, keepdim=True)
        g = p_last * g_out[:, None]
        grads = [g]
        for t in range(alphas.shape[0] - 1, 0, -1):
            g = torch.where(active[t], torch.bmm(g[:, None, :], W[t - 1])[:, 0], g)
            grads.append(g)
        G = torch.stack(grads[::-1])  # (T, B, N): d out / d alpha_t
        live = G[1:] * active[1:]
        g_em = torch.cat([G[:1], live]).transpose(0, 1)
        g_trans = torch.einsum("tbn,tbnm->nm", live, W)
        return g_em, g_trans, None


def fal_score(emissions: torch.Tensor, transitions: torch.Tensor, targets: torch.Tensor,
              emis_len: torch.Tensor, target_len: torch.Tensor) -> torch.Tensor:
    """(B,) log-sum over the alignments of each row's targets. ``emissions``
    (B, T, N) raw scores, ``transitions`` (N, N), ``targets`` (B, U) padded
    with -1."""
    B, T, N = emissions.shape
    U = targets.shape[1]
    em = emissions.float()
    tgt = targets.clamp(min=0).long()
    em_tgt = em.gather(2, tgt[:, None, :].expand(B, T, U))  # (B, T, U)
    self_tr = transitions[tgt, tgt]  # (B, U): y_u -> y_u
    prev = F.pad(tgt, (1, 0))[:, :U]
    step_tr = transitions[tgt, prev][:, 1:]  # (B, U-1): y_{u-1} -> y_u
    alpha = _FalRecursion.apply(em_tgt, self_tr, step_tr, _active(T, emis_len))
    last = (target_len.long() - 1).clamp(0, U - 1)
    out = alpha[torch.arange(B, device=em.device), last]
    # a row with no target keeps every slot at NEG_INF in JAX
    return torch.where(target_len > 0, out, torch.full_like(out, NEG_INF))


def fcc_score(emissions: torch.Tensor, transitions: torch.Tensor,
              emis_len: torch.Tensor) -> torch.Tensor:
    """(B,) log-sum over all label sequences of each row's frames."""
    return _FccRecursion.apply(emissions.float(), transitions.float(),
                               _active(emissions.shape[1], emis_len))


def asg_loss(emissions: torch.Tensor, transitions: torch.Tensor, targets: torch.Tensor,
             emis_len: torch.Tensor, target_len: torch.Tensor) -> torch.Tensor:
    """Per-sample ASG loss = FCC - FAL (>= 0), differentiable with respect to
    ``emissions`` and ``transitions``."""
    fal = fal_score(emissions, transitions, targets, emis_len, target_len)
    fcc = fcc_score(emissions, transitions, emis_len)
    return fcc - fal


def linseg_loss(emissions: torch.Tensor, transitions: torch.Tensor, targets: torch.Tensor,
                emis_len: torch.Tensor, target_len: torch.Tensor) -> torch.Tensor:
    """LinSeg initialization loss (reference ``--linseg`` updates): the FAL
    term is replaced by the score of the single linear-segmentation alignment
    u(t) = floor(t * U / T_valid)."""
    B, T, N = emissions.shape
    em = emissions.float()
    tgt = targets.clamp(min=0).long()
    t_idx = torch.arange(T, device=em.device)[None, :]
    tl = target_len.long().clamp(min=1)[:, None]
    el = emis_len.long().clamp(min=1)[:, None]
    u_of_t = torch.minimum((t_idx * tl) // el, tl - 1).clamp(min=0)  # (B, T)
    lbl = tgt.gather(1, u_of_t)  # (B, T)
    em_sc = em.gather(2, lbl[:, :, None])[..., 0]
    prev_lbl = F.pad(lbl, (1, 0))[:, :T]
    tr_sc = transitions[lbl, prev_lbl]
    tr_sc = torch.cat([torch.zeros_like(tr_sc[:, :1]), tr_sc[:, 1:]], dim=1)
    valid = t_idx < emis_len[:, None]
    forced = torch.where(valid, em_sc + tr_sc, torch.zeros_like(em_sc)).sum(dim=1)
    return fcc_score(emissions, transitions, emis_len) - forced


@torch.no_grad()
def asg_viterbi(emissions: torch.Tensor, transitions: torch.Tensor,
                emis_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max-product decode with transitions and a backtrace: (B, T, N) ->
    (B, T) int32. Frames past ``emis_len`` repeat the row's last label."""
    B, T, N = emissions.shape
    em = emissions.float()
    trans = transitions.float()[None]
    dev = em.device
    if emis_len is None:
        emis_len = torch.full((B,), T, dtype=torch.int32, device=dev)
    active = _active(T, emis_len)
    ident = torch.arange(N, device=dev)[None, :].expand(B, N)
    alpha = em[:, 0]
    bps = []  # bps[t - 1]: the best predecessor of each label at frame t
    for t in range(1, T):
        best, best_prev = (alpha[:, None, :] + trans).max(dim=-1)
        alpha = torch.where(active[t], best + em[:, t], alpha)
        # frozen frames point to themselves (identity backpointer)
        bps.append(torch.where(active[t], best_prev, ident))
    lbl = alpha.argmax(dim=-1)
    path = [lbl]
    for bp in reversed(bps):
        lbl = bp.gather(1, lbl[:, None])[:, 0]
        path.append(lbl)
    # the last step of the backtrace is JAX's ``first``: bps[0] at the label of t=1
    return torch.stack(path[::-1], dim=1).to(torch.int32)


def asg_collapse(path, replabel: int = 0, base_dict_size: int = 0) -> List[List[int]]:
    """Host-side: collapse repeats and unpack replabels (reference ASG decode
    postprocessing, Decoder.cpp:189-225). A list per row."""
    out = []
    for row in np.asarray(path):
        toks = []
        prev = None
        for t in row:
            t = int(t)
            if t != prev:
                toks.append(t)
            prev = t
        if replabel > 0:
            toks = unpack_replabels(toks, replabel, base_dict_size)
        out.append(toks)
    return out
