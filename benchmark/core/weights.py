"""Seeded weights, made on the device in one draw and handed to both the
program and the reference.

The scale of each tensor follows its shape: a convolution's (out, in, h, w)
weight (or weight-normed ``v``) He-normal over in * h * w; a linear's (in,
out) weight normal over sqrt(in); a weight norm's gain sqrt(2) (an He row);
a relative-position table 0.06; a LayerNorm's scalar gain 1 and a bias near
0, each with a small spread so that no two leaves are alike.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _scale(name: str, shape: Tuple[int, ...]):
    """(mean, std) of a leaf."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 4 and leaf in ("weight", "v"):
        return 0.0, math.sqrt(2.0 / max(1, shape[1] * shape[2] * shape[3]))
    if leaf == "g":
        return math.sqrt(2.0), 0.05
    if leaf == "pos_emb":
        return 0.0, 0.06
    if len(shape) == 2:
        return 0.0, 1.0 / math.sqrt(shape[0])
    if leaf == "weight" and math.prod(shape) == 1:
        return 1.0, 0.05
    return 0.0, 0.02


def seeded(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} from one normal draw of the seed's
    generator on that device."""
    total = sum(math.prod(s) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed((seed * 2_654_435_761 + 12345) % (2 ** 63))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        mean, std = _scale(name, tuple(shape))
        out[name] = flat[at:at + n].view(shape).mul_(std).add_(mean)
        at += n
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, w: Dict[str, torch.Tensor]) -> None:
    """Write ``w`` into the module's parameters, every one of them."""
    params = dict(module.named_parameters())
    if set(params) != set(w):
        raise ValueError(f"weights for {sorted(set(w) ^ set(params))[:4]}... do not match")
    for n, p in params.items():
        p.copy_(w[n])
