"""The optimizer side of a training step: the learning rate of an update,
the seed of its random draws, the clip by the global norm, SGD and Adam
(Kingma and Ba 2015, bias-corrected, epsilon outside the root)."""

from __future__ import annotations

import math
from typing import Dict

import torch


def learning_rate(flags: dict, update: int) -> float:
    """wav2letter's schedule: linear warmup over ``warmup`` updates from
    lr / warmup, then ``inv_sqrt`` (lr / sqrt(u / lr_step_decay), u counted
    after the warmup, at most lr) or constant."""
    lr = float(flags["lr"])
    warmup = int(flags.get("warmup", 0))
    if warmup > 0 and update < warmup:
        return lr * (update + 1) / warmup
    sched = flags.get("lr_sched", "constant")
    if sched == "inv_sqrt" and int(flags.get("lr_step_decay", 0)) > 0:
        return lr / math.sqrt(max(1.0, (update - warmup) / int(flags["lr_step_decay"])))
    if sched != "constant":
        raise ValueError(f"lr_sched {sched!r} is not in the reference")
    return lr


def step_seed(seed: int, update: int) -> int:
    """The seed of update ``update``'s draws on one card: (seed + 7) *
    1,000,003 + update."""
    return (seed + 7) * 1_000_003 + update


def clip_scale(grads: Dict[str, torch.Tensor], max_norm: float) -> float:
    gn = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads.values()))
    return min(1.0, max_norm / (gn + 1e-12)) if max_norm > 0 else 1.0


class Optimizer:
    """SGD (``momentum`` 0) or Adam over a parameter dict, float32 state."""

    def __init__(self, flags: dict, params: Dict[str, torch.Tensor]):
        self.name = flags["netoptim"]
        self.count = 0
        if self.name == "sgd":
            if float(flags.get("momentum", 0.0)) != 0.0:
                raise ValueError("SGD with momentum is not in the reference")
        elif self.name == "adam":
            self.b1 = float(flags.get("adambeta1", 0.9))
            self.b2 = float(flags.get("adambeta2", 0.999))
            self.eps = float(flags.get("optimepsilon", 1e-8))
            self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
            self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        else:
            raise ValueError(f"optimizer {self.name!r} is not in the reference")

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             lr: float, scale: float) -> None:
        self.count += 1
        c = self.count
        for n, p in params.items():
            g = grads[n] * scale
            if self.name == "sgd":
                p -= lr * g
            else:
                self.mu[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
                self.nu[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                m_hat = self.mu[n] / (1 - self.b1 ** c)
                v_hat = self.nu[n] / (1 - self.b2 ** c)
                p -= lr * m_hat / (v_hat.sqrt() + self.eps)
