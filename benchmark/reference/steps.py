"""Training steps and serving forwards of the reference, in blocks of rows,
so that they fit beside nothing else on the card.

A training step, as wav2letter trains a CTC model: features, the
flag-driven SpecAugment (when on), the model in training mode, the CTC loss
of each row scaled by ``--onorm``/``--sqnorm``, their mean over the batch's
real rows, the gradient, the clip by the global norm, the optimizer. The
random draws replay the program's from the step's seed (``model``)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import ctc, frontend, optim
from .model import Model
from .numerics import EXACT, Precision


class Reference:
    """One configuration's reference on a device: the model, the flags, the
    parameters (float32, the program's names) and the optimizer state."""

    def __init__(self, lines, flags: dict, n_label: int, params: Dict[str, torch.Tensor],
                 device, prec: Precision = EXACT, block_rows: int = 16):
        self.flags = flags
        self.n_feat = int(flags.get("filterbanks", 80))
        self.model = Model(lines, self.n_feat, n_label)
        self.device = torch.device(device)
        self.params = {n: p.detach().to(self.device, torch.float32).clone().requires_grad_(True)
                       for n, p in params.items()}
        self.prec = prec
        self.block = block_rows
        self.opt = optim.Optimizer(flags, self.params)
        self.mask_dtype = (torch.bfloat16 if flags.get("compute_dtype", "bfloat16") == "bfloat16"
                           else torch.float32)

    def features(self, batch: dict):
        feats, flen = frontend.features(batch, self.device, int(self.flags.get(
            "localnrmlleftctx", 0)), int(self.flags.get("localnrmlrightctx", 0)), self.n_feat)
        return feats.float(), flen

    @torch.no_grad()
    def emissions(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serving: (emissions (B, T', N) float32, lengths (B,))."""
        feats, flen = self.features(batch)
        B, T = feats.shape[:2]
        ems, lens = [], []
        for r0 in range(0, B, self.block):
            rows = slice(r0, min(B, r0 + self.block))
            em, el = self.model.forward(self.params, feats[rows], flen[rows], T, rows,
                                        prec=self.prec)
            ems.append(em)
            lens.append(el)
        return torch.cat(ems), torch.cat(lens)

    def train_step(self, batch: dict, update: int,
                   seed: int) -> Tuple[float, Dict[str, torch.Tensor], float]:
        """One update on a padded batch (the numpy dict the program gets; rows
        of ``sample_idx`` -1 are padding). Returns (loss, the clipped gradient
        the optimizer takes, the learning rate)."""
        f = self.flags
        s = optim.step_seed(seed, update)
        feats, flen = self.features(batch)
        B, T, C = feats.shape
        gen = torch.Generator().manual_seed(s)
        if int(f.get("saug_start_update", -1)) >= 0:  # on: the step is past it
            keep = frontend.specaugment_keep(
                B, T, C, gen, int(f.get("saug_fmaskn", 2)), int(f.get("saug_fmaskf", 27)),
                int(f.get("saug_tmaskn", 2)), int(f.get("saug_tmaskt", 100)),
                float(f.get("saug_tmaskp", 1.0)), flen)
            feats = feats * keep.to(self.device)
        self.model.saug_keep(B, T, gen)
        draws = self.model.draw(self.model.sites(B, T, True), s, self.mask_dtype, self.device)
        target = torch.as_tensor(batch["target"]).to(self.device)
        tlen = torch.as_tensor(batch["target_len"]).to(self.device)
        rmask = (torch.as_tensor(batch["sample_idx"]) >= 0).to(self.device).double()
        n_rows = float(rmask.sum())
        for p in self.params.values():
            p.grad = None
        total = 0.0
        for r0 in range(0, B, self.block):
            rows = slice(r0, min(B, r0 + self.block))
            em, el = self.model.forward(self.params, feats[rows], flen[rows], T, rows, draws,
                                        training=True, prec=self.prec)
            losses = ctc.scaled(ctc.ctc_nll(em, el, target[rows], tlen[rows]), tlen[rows],
                                f.get("onorm", "none"), bool(f.get("sqnorm", False)))
            loss = (losses * rmask[rows]).sum() / n_rows
            loss.backward()
            total += float(loss.detach())
        del draws
        grads = {n: p.grad.detach().clone() for n, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        scale = optim.clip_scale(grads, float(f.get("maxgradnorm", 0.0)))
        lr = optim.learning_rate(f, update)
        self.opt.step(self.params, grads, lr, scale)
        return total, {n: g * scale for n, g in grads.items()}, lr
