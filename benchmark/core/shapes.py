"""The calls a forward of an arch makes on a batch of (B, T) padded feature
frames, walked from its lines: the per-layer metrics count operations and
bytes from these.

Records (all sizes as the program runs them, padding included):
  frontend  (B, S samples, T frames, mels)
  tconv     time convolutions: (B, T in, T out, F, C, CO, K)
  wnconv    weight-normed convolutions: the same fields
  linear    (rows, in, out)
  attention (B, T, H, Dh)
  ln        the residual LayerNorms of TDS and TR blocks: (rows, D)
  ctc       (B, T', N)
"""

from __future__ import annotations

from typing import Dict, List

from ..reference.model import parse_arch


def walk(lines: List[str], n_feat: int, n_label: int, B: int, T: int) -> Dict[str, list]:
    out: Dict[str, list] = {k: [] for k in
                            ("frontend", "tconv", "wnconv", "linear", "attention", "ln", "ctc")}
    out["frontend"].append(dict(B=B, S=(T - 1) * 160 + 400, T=T, mels=n_feat))
    layers = parse_arch(lines, n_feat, n_label)
    pads = {}
    for a, b in zip(layers, layers[1:]):
        if a.kind == "PD" and b.kind == "C2":
            pads[b.index] = (a.a[1], a.a[2])
    F_, C, D = n_feat, 1, 0
    for lay in layers:
        k, a = lay.kind, lay.a
        if k == "V" and D == 0:
            F_, C = a[1], a[2]
        elif k == "C2":
            ci, co, wx, _, sx = a[:5]
            lp, rp = pads.get(lay.index, (0, 0))
            px = a[6]
            lp, rp = (lp + px, rp + px) if px >= 0 else _same(T, wx, sx)
            Tout = (T + lp + rp - wx) // sx + 1
            out["tconv"].append(dict(B=B, Tin=T, Tout=Tout, F=F_, C=ci, CO=co, K=wx))
            C, T = co, Tout
        elif k == "C":
            _, _, ci, co, wx, sx, px = a
            lp, rp = _same(T, wx, sx) if px == -1 else (px, px)
            Tout = (T + lp + rp - wx) // sx + 1
            out["wnconv"].append(dict(B=B, Tin=T, Tout=Tout, F=F_, C=ci, CO=co, K=wx))
            C, T = co, Tout
        elif k == "GLU":
            C //= 2
        elif k == "M":
            T = -(-T // a[2])
        elif k == "TDS":
            c, w, f = a[:3]
            inner = (a[4] if len(a) > 4 else 0) or c * f
            out["tconv"].append(dict(B=B, Tin=T, Tout=T, F=f, C=c, CO=c, K=w))
            out["linear"] += [dict(rows=B * T, i=c * f, o=inner), dict(rows=B * T, i=inner, o=c * f)]
            out["ln"] += [dict(rows=B * T, D=c * f)] * 2
        elif k == "RO":
            D = F_ * C
        elif k == "L":
            out["linear"].append(dict(rows=B * T, i=a[0], o=a[1]))
            D = a[1]
        elif k == "TR":
            d, mlp, H = a[:3]
            out["linear"] += [dict(rows=B * T, i=d, o=d)] * 4
            out["linear"] += [dict(rows=B * T, i=d, o=mlp), dict(rows=B * T, i=mlp, o=d)]
            out["attention"].append(dict(B=B, T=T, H=H, Dh=d // H))
            out["ln"] += [dict(rows=B * T, D=d)] * 2
    out["ctc"].append(dict(B=B, T=T, N=n_label))
    return out


def _same(n: int, k: int, s: int):
    o = -(-n // s)
    total = max(0, (o - 1) * s + k - n)
    return total // 2, total - total // 2


def model_flops(calls: Dict[str, list], train: bool) -> float:
    """The model's matrix products and convolutions, 2 flops a multiply-add:
    the forward, and in training twice more for the backward, less the
    first layer's gradient of its input (the features have none)."""
    fwd = []
    for c in calls["tconv"] + calls["wnconv"]:
        fwd.append(2.0 * c["B"] * c["Tout"] * c["F"] * c["C"] * c["CO"] * c["K"])
    for c in calls["linear"]:
        fwd.append(2.0 * c["rows"] * c["i"] * c["o"])
    for c in calls["attention"]:
        T = c["T"]  # q.k, q.P over the 2T - 1 offsets, p.v
        fwd.append(2.0 * c["B"] * c["H"] * c["Dh"] * (T * T + T * (2 * T - 1) + T * T))
    total = sum(fwd)
    if not train:
        return total
    return 3.0 * total - (fwd[0] if fwd else 0.0)
