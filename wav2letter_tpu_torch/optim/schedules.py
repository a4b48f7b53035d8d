"""LR schedules — the port's own copy of ``wav2letter_tpu/optim/schedules.py``
(pure Python): closed-form, matching the reference's in-repo implementation
(``cpc/Train.cpp:908-967``) and flag set: ``--warmup --hold --lr_sched
{constant,linear,inv_sqrt,step,cosine} --lr_ld_final --lr_step_decay
--stepsize --gamma --lr_decay --lr_decay_step --lrcosine``.

Both update-based (warmup/decay) and epoch-based (lr_decay halving) terms
compose multiplicatively; returns the absolute LR for (update, epoch).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class LRSchedule:
    base_lr: float
    warmup: int = 0
    hold: int = 0
    sched: str = "constant"
    total_updates: int = 1000000
    lr_final: float = 0.0  # linear decay floor
    step_decay: int = 0  # inv_sqrt / step interval (updates)
    stepsize: int = 1000000  # multiply by gamma every stepsize updates
    gamma: float = 1.0
    lr_decay_epoch: int = 0  # epoch to start halving (0 = off)
    lr_decay_step: int = 1000000  # halve every this many epochs after start
    cosine: bool = False

    @classmethod
    def from_config(cls, cfg, lr: float) -> "LRSchedule":
        return cls(
            base_lr=lr,
            warmup=cfg.warmup,
            hold=cfg.hold,
            sched=cfg.lr_sched,
            total_updates=cfg.iter,
            lr_final=cfg.lr_ld_final,
            step_decay=cfg.lr_step_decay,
            stepsize=cfg.stepsize,
            gamma=cfg.gamma,
            lr_decay_epoch=cfg.lr_decay if cfg.lr_decay > 0 else 0,
            lr_decay_step=cfg.lr_decay_step,
            cosine=cfg.lrcosine,
        )

    def __call__(self, update: int, epoch: int = 0) -> float:
        lr = self.base_lr
        # warmup (linear from 0)
        if self.warmup > 0 and update < self.warmup:
            return lr * (update + 1) / self.warmup
        u = update - self.warmup
        if self.hold > 0 and u < self.hold:
            pass  # flat
        else:
            uh = u - (self.hold if self.hold > 0 else 0)
            if self.sched == "linear":
                frac = min(1.0, uh / max(1, self.total_updates - self.warmup - self.hold))
                lr = lr + (self.lr_final - lr) * frac
            elif self.sched == "inv_sqrt" and self.step_decay > 0:
                lr = lr / math.sqrt(max(1.0, uh / self.step_decay))
            elif self.sched == "step" and self.step_decay > 0:
                lr = lr * (self.gamma ** (uh // self.step_decay))
            elif self.cosine or self.sched == "cosine":
                frac = min(1.0, uh / max(1, self.total_updates - self.warmup - self.hold))
                lr = lr * 0.5 * (1 + math.cos(math.pi * frac))
        # --stepsize/--gamma update-based exponential decay
        if self.gamma != 1.0 and self.stepsize > 0 and self.sched not in ("step",):
            lr = lr * (self.gamma ** (update // self.stepsize))
        # epoch-based halving (--lr_decay/--lr_decay_step)
        if self.lr_decay_epoch > 0 and epoch >= self.lr_decay_epoch:
            n = 1 + (epoch - self.lr_decay_epoch) // max(1, self.lr_decay_step)
            lr = lr * (0.5 ** n)
        return max(lr, 0.0)
