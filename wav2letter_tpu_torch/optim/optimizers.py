"""Optimizers — the port of ``wav2letter_tpu/optim/optimizers.py`` (reference
``initOptimizer``; ``--netoptim/--critoptim`` in sgd|adam|adadelta|adagrad|
amsgrad|novograd|rmsprop, with the momentum, weight-decay, beta and epsilon
flags).

The JAX package builds these from optax; its rules are written out here,
because ``torch.optim`` computes several of them differently (adagrad's
accumulator starts at 0.1 and eps sits inside the root; rmsprop puts eps
inside the root and applies the learning rate before the momentum trace;
amsgrad keeps the maximum of the bias-corrected second moment; adadelta
scales by the learning rate after its own step; there is no novograd) and
refuses an empty parameter list, which a criterion without parameters has.
As in ``make_optimizer``: the learning rate is given at every step, and weight
decay is added to the gradient before the rule
(``optax.add_decayed_weights`` ahead of the base). All state is float32, as
the parameters are. Updates are applied in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

NAMES = ("sgd", "adam", "amsgrad", "adagrad", "adadelta", "rmsprop", "novograd")
# per-parameter state of each rule, with its initial value
_SLOTS = {
    "sgd": (),
    "adam": (("mu", 0.0), ("nu", 0.0)),
    "amsgrad": (("mu", 0.0), ("nu", 0.0), ("nu_max", 0.0)),
    "adagrad": (("sum_of_squares", 0.1),),
    "adadelta": (("e_g", 0.0), ("e_x", 0.0)),
    "rmsprop": (("nu", 0.0), ("trace", 0.0)),
    "novograd": (("mu", 0.0), ("nu", 0.0)),
}


class Optimizer:
    """One optax-equivalent rule over named parameters.

    ``step(lr)`` reads each parameter's ``.grad`` (a parameter without one is
    left alone) and updates the parameter and the state in place.
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], name: str,
                 momentum: float = 0.0, weight_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, rho: float = 0.9):
        self.name = name.lower()
        if self.name not in NAMES:
            raise ValueError(f"unknown optimizer: {name}")
        self.params: List[Tuple[str, torch.Tensor]] = list(named_params)
        self.momentum, self.weight_decay = momentum, weight_decay
        self.beta1, self.beta2, self.eps, self.rho = beta1, beta2, epsilon, rho
        self.count = 0
        # column shards under tensor parallelism, and the sum over their model
        # group: novograd's per-tensor norm is over the whole array, as optax's
        self.sharded: frozenset = frozenset()
        self.shard_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
        slots = list(_SLOTS[self.name])
        if self.name == "sgd" and momentum > 0:
            slots.append(("trace", 0.0))
        self.state: Dict[str, Dict[str, torch.Tensor]] = {
            slot: {n: (torch.zeros((), dtype=p.dtype, device=p.device)
                       if (self.name, slot) == ("novograd", "nu")
                       else torch.full_like(p, init))
                   for n, p in self.params}
            for slot, init in slots}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.count += 1
        c = self.count
        b1, b2, eps, rho, m = self.beta1, self.beta2, self.eps, self.rho, self.momentum
        st = self.state
        for n, p in self.params:
            if p.grad is None:
                continue
            g = p.grad
            if self.weight_decay > 0:
                g = g + self.weight_decay * p
            if self.name == "sgd":
                if m > 0:
                    g = st["trace"][n].mul_(m).add_(g)
                p.add_(g, alpha=-lr)
            elif self.name in ("adam", "amsgrad"):
                mu = st["mu"][n].mul_(b1).add_(g, alpha=1 - b1)
                nu = st["nu"][n].mul_(b2).addcmul_(g, g, value=1 - b2)
                nu_hat = nu / (1 - b2 ** c)
                if self.name == "amsgrad":
                    nu_hat = torch.maximum(st["nu_max"][n], nu_hat, out=st["nu_max"][n])
                p.addcdiv_(mu / (1 - b1 ** c), nu_hat.sqrt().add_(eps), value=-lr)
            elif self.name == "adagrad":
                ss = st["sum_of_squares"][n].addcmul_(g, g)
                scale = torch.where(ss > 0, torch.rsqrt(ss + eps), torch.zeros_like(ss))
                p.addcmul_(scale, g, value=-lr)
            elif self.name == "adadelta":
                e_g = st["e_g"][n].mul_(rho).addcmul_(g, g, value=1 - rho)
                e_x = st["e_x"][n]
                u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
                e_x.mul_(rho).addcmul_(u, u, value=1 - rho)
                p.add_(u, alpha=-lr)
            elif self.name == "rmsprop":
                nu = st["nu"][n].mul_(rho).addcmul_(g, g, value=1 - rho)
                u = g * torch.rsqrt(nu + eps) * (-lr)
                p.add_(st["trace"][n].mul_(m).add_(u))
            else:  # novograd: one second moment per parameter tensor
                sq = g.float().pow(2).sum()
                if n in self.sharded:
                    sq = self.shard_sum(sq)
                nu, mu = st["nu"][n], st["mu"][n]
                if c == 1:
                    nu.copy_(sq)
                    mu.copy_(g / (nu.sqrt() + eps))
                else:
                    nu.mul_(b2).add_(sq, alpha=1 - b2)
                    mu.mul_(b1).add_(g / (nu.sqrt() + eps))
                p.add_(mu, alpha=-lr)

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "count": self.count,
                "state": {slot: {n: t.detach().cpu() for n, t in d.items()}
                          for slot, d in self.state.items()}}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        if sd.get("name", self.name) != self.name:
            raise ValueError(f"optimizer state is for {sd['name']!r}, not {self.name!r}")
        if set(sd["state"]) != set(self.state):
            raise ValueError(f"optimizer state has slots {sorted(sd['state'])}, "
                             f"expected {sorted(self.state)}")
        self.count = int(sd["count"])
        for slot, d in self.state.items():
            for n, t in d.items():
                t.copy_(sd["state"][slot][n])


def make_optimizer(named_params, name: str, momentum: float = 0.0,
                   weight_decay: float = 0.0, beta1: float = 0.9, beta2: float = 0.999,
                   epsilon: float = 1e-8, rho: float = 0.9) -> Optimizer:
    return Optimizer(named_params, name, momentum, weight_decay, beta1, beta2, epsilon, rho)


def sgd_state_from_optax(opt_state: Dict[str, Any], count: int = 0) -> Dict[str, Any]:
    """An optax SGD-momentum state, as the JAX package's checkpoints store it
    (the nested dict of ``inject_hyperparams`` > ``chain`` > ``trace``), as the
    state dict of this module's ``sgd``: its ``trace`` tree under the port's
    parameter names."""
    from ..runtime.checkpoint import convert_jax_params

    def find(node):
        if isinstance(node, dict):
            if "trace" in node:
                return node["trace"]
            for v in node.values():
                hit = find(v)
                if hit is not None:
                    return hit
        return None

    trace = find(opt_state)
    if trace is None:
        raise ValueError("no momentum trace in the optax state (sgd without momentum?)")
    return {"name": "sgd", "count": count, "state": {"trace": convert_jax_params(trace)}}
