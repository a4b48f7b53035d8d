"""The comparison that decides ``correct``: the numbers, each held to its
limit from ``benchmark/limits/<cell>.json``.

Training (the first three updates of the run's one ``Trainer``, which the
window then drives on):
  loss_gap         the largest relative gap of an update's loss to the
                   reference's
  grad_gap         the worst leaf's gap between the norms of the first
                   gradient, as the optimizer took it, of the program and of
                   the reference
  grad_gap_median  the median leaf's gap of the same: the worst leaves are the
                   LayerNorm biases, whose gradient is a sum over every frame
                   that all but cancels, so under bf16 their gap is rounding
                   noise that swings from seed to seed; the median is steady
  change_gap       the worst leaf's gap between the norms of the parameters'
                   change over the three updates
A leaf's gap is over the larger of the reference's norm of that leaf and of
the median leaf. Leaves whose first gradient in the reference is under a
thousandth of the median leaf's move by round-off alone and are left out.

Serving (a sample of the served batches, drawn from the seed, the longest
among them):
  token_gap          the widest gap by which a served frame's token lies below
                     the reference's best emission of that frame
  mean_gap           that gap's mean over every served frame
  length_mismatch    rows whose path length is not the reference's
  collapse_mismatch  rows whose tokens are not the collapse of their path
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Set

import numpy as np
import torch


def counted(ref_grad: Dict[str, float]) -> Set[str]:
    med = statistics.median(ref_grad.values())
    return {n for n, g in ref_grad.items() if g >= 1e-3 * med}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: Set[str]) -> List[float]:
    med = statistics.median(ref[n] for n in leaves)
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves]


def train_numbers(prog_loss: List[float], ref_loss: List[float], prog_grad: Dict[str, float],
                  ref_grad: Dict[str, float], prog_change: Dict[str, float],
                  ref_change: Dict[str, float]) -> Dict[str, float]:
    leaves = counted(ref_grad)
    loss = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_loss, ref_loss))
    if not all(np.isfinite(prog_loss)):
        loss = float("inf")
    grad = leaf_gaps(prog_grad, ref_grad, leaves)
    return {"loss_gap": loss, "grad_gap": max(grad),
            "grad_gap_median": statistics.median(grad),
            "change_gap": max(leaf_gaps(prog_change, ref_change, leaves))}


def collapse(path, blank: int) -> List[int]:
    """CTC's collapse of a frame path: merge repeats, drop blanks."""
    out, prev = [], None
    for t in path:
        t = int(t)
        if t != prev and t != blank:
            out.append(t)
        prev = t
    return out


def serve_numbers(served: List[tuple], refs: List[tuple], blank: int) -> Dict[str, float]:
    """``served``: (paths (B, T'), lengths (B,), tokens per row) of each
    sampled batch; ``refs``: the reference's (emissions (B, T', N), lengths)."""
    gap, gap_sum, frames, bad_len, bad_tok = 0.0, 0.0, 0, 0, 0
    for (paths, lens, toks), (em, rlen) in zip(served, refs):
        rlen = rlen.cpu().numpy()
        if paths.shape[0] != em.shape[0] or len(toks) != em.shape[0]:
            bad_len += abs(em.shape[0] - min(paths.shape[0], len(toks))) or em.shape[0]
        for i in range(min(paths.shape[0], len(toks), em.shape[0])):
            n = int(rlen[i])
            if int(lens[i]) != n or paths.shape[1] != em.shape[1]:
                bad_len += 1
                continue
            e = em[i, :n]
            p = torch.as_tensor(paths[i, :n].astype(np.int64), device=e.device)
            if n:
                g = e.max(dim=-1).values - e.gather(-1, p[:, None])[:, 0]
                gap = max(gap, float(g.max()))
                gap_sum += float(g.double().sum())
                frames += n
            if list(toks[i]) != collapse(paths[i, :n], blank):
                bad_tok += 1
    return {"token_gap": gap, "mean_gap": gap_sum / max(frames, 1),
            "length_mismatch": float(bad_len),
            "collapse_mismatch": float(bad_tok)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """The numbers that have a limit, each beside it. A number that no
    control or fault separates from sound runs has none: it is not compared."""
    return {k: {"value": v, "limit": float(limits[k])} for k, v in numbers.items()
            if k in limits}


def passed(checks: Dict[str, dict]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
