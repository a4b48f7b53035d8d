"""The system under test, ``wav2letter_tpu_torch``, driven through its own
entry points: ``runtime.train.Trainer`` for an update and
``runtime.test.Evaluator`` for a served batch.

Each call is what the program's own loop does for one batch:
  * an update, the body of ``Trainer.run``'s loop: the learning rates of the
    update from the schedules, the update's seed, SpecAugment on once
    ``updates`` reaches ``--saug_start_update``, ``pad_batch_rows``, then
    ``Trainer.train_step``; reports, validation and checkpoints stay out;
  * a served batch, the body of ``runtime/test.py::evaluate``'s loop without
    the meters: ``Evaluator.emissions``, ``Evaluator.viterbi``, the paths
    copied to the host, ``Evaluator.collapse`` of each row.

The constructors need a tokens file, a lexicon and a list; they are written
under a work directory. The ``Evaluator`` loads its model from a checkpoint:
one in the program's format is written whose tensors are expanded zeros (a
few bytes on disk), and the seeded weights are then written into the loaded
model, as they are into the ``Trainer``'s.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import torch

from . import manifest


def write_files(workdir: str, n_classes: int, separator: str = "|") -> Dict[str, str]:
    """tokens (the word separator and n_classes - 2 word pieces; CTC adds the
    blank), a lexicon and a list of two utterances, which the constructors
    read and the benchmark never loads."""
    os.makedirs(workdir, exist_ok=True)
    paths = {k: os.path.join(workdir, f) for k, f in
             (("tokens", "tokens.txt"), ("lexicon", "lexicon.txt"), ("list", "pool.lst"))}
    with open(paths["tokens"], "w") as f:
        f.write(f"{separator}\n" + "".join(f"p{i:04d}\n" for i in range(1, n_classes - 1)))
    with open(paths["lexicon"], "w") as f:
        f.write("".join(f"w{i}\tp{i + 1:04d} p{i + 2:04d} {separator}\n" for i in range(8)))
    with open(paths["list"], "w") as f:
        f.write("".join(f"u{i} {workdir}/u{i}.flac 4000.0 w{i} w{i + 1}\n" for i in range(2)))
    return paths


def program_config(config: dict, files: Dict[str, str], seed: int, **extra):
    from wav2letter_tpu_torch.config import Config

    flags = dict(config["flags"])
    flags.update(arch=manifest.arch_path(config), tokens=files["tokens"],
                 lexicon=files["lexicon"], train=files["list"], seed=seed, rundir="",
                 runname="", reportiters=0, nthread=1, **extra)
    return Config().update(flags)


def param_shapes(config: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """The program's parameter names and shapes for the config's arch, from
    a model built on the meta device."""
    from wav2letter_tpu_torch.models import build_arch_module

    with torch.device("meta"):
        model = build_arch_module(manifest.arch_path(config), int(config["flags"]["filterbanks"]),
                                  int(config["n_classes"]))
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


class TrainSystem:
    """One ``Trainer`` on ``device``, with the seeded weights."""

    def __init__(self, config: dict, files: Dict[str, str], seed: int, device: str,
                 weights: Dict[str, torch.Tensor]):
        from wav2letter_tpu_torch.data.batching import pad_batch_rows
        from wav2letter_tpu_torch.runtime.train import Trainer
        from .weights import load_into

        self._pad = pad_batch_rows
        self.cfg = program_config(config, files, seed)
        self.tr = Trainer(self.cfg, device=device)
        load_into(self.tr.model, weights)
        self.tr.epoch = 1
        self.tr.updates = int(config.get("start_update", 0))

    def step(self, batch: dict) -> Tuple[float, bool]:
        tr, cfg = self.tr, self.cfg
        lr = tr.net_sched(tr.updates, tr.epoch)
        lr_crit = tr.crit_sched(tr.updates, tr.epoch)
        seed = tr._step_seed(cfg.seed + 7)
        saug_on = 0 <= cfg.saug_start_update <= tr.updates
        loss, finite, _, _ = tr.train_step(self._pad(batch, 1), lr, lr_crit, saug_on, seed)
        tr.updates += 1
        return loss, finite

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.tr.model.named_parameters())

    def first_gradient(self, before: Dict[str, torch.Tensor], lr: float) -> Dict[str, float]:
        """The norm of each leaf's gradient as the optimizer took it in the
        first update, worked out from the optimizer's state after it: Adam's
        first moment over (1 - beta1), or SGD's step over the learning rate."""
        opt = self.tr.net_opt
        out = {}
        with torch.no_grad():
            for n, p in self.params().items():
                if opt.name == "adam":
                    g = opt.state["mu"][n] / (1.0 - opt.beta1)
                elif opt.name == "sgd" and opt.momentum == 0.0:
                    g = (before[n].to(p.device) - p) / lr
                else:
                    raise ValueError(f"no first gradient from a {opt.name} state")
                out[n] = float(g.double().norm())
        return out

    def lr(self) -> float:
        return self.tr.net_sched(self.tr.updates, self.tr.epoch)


class InferSystem:
    """One ``Evaluator`` on ``device``, with the seeded weights."""

    def __init__(self, config: dict, files: Dict[str, str], seed: int, device: str,
                 weights: Dict[str, torch.Tensor], batch: int):
        from wav2letter_tpu_torch.config import Config
        from wav2letter_tpu_torch.runtime.checkpoint import Checkpoint, save_checkpoint
        from wav2letter_tpu_torch.runtime.test import Evaluator
        from .weights import load_into

        cfg = program_config(config, files, seed)
        am = os.path.join(os.path.dirname(files["tokens"]), "am.pt")
        zero = torch.zeros((), dtype=torch.float32)
        state = {n: zero.expand(w.shape) for n, w in weights.items()}
        save_checkpoint(am, Checkpoint(cfg.serialize(), 0, 0, state))
        self.ev = Evaluator(Config(am=am, batchsize=batch), device=device)
        load_into(self.ev.model, weights)

    def serve(self, batch: dict):
        """(paths (B, T') int32, path lengths (B,), collapsed tokens per row)."""
        ev = self.ev
        em, elen = ev.emissions(batch)
        vit, vlen = ev.viterbi(em, elen)
        vit, vlen = vit.cpu().numpy(), vlen.cpu().numpy()
        toks = [ev.collapse(vit[i], int(vlen[i])) for i in range(vit.shape[0])]
        return vit, vlen, toks

