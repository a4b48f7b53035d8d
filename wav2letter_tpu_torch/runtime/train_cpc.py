"""CPC / wav2vec2-style joint training — the port of
``wav2letter_tpu/runtime/train_cpc.py`` (reference
``recipes/joint_training_vox_populi/cpc/Train.cpp``).

Alternating unsupervised (CPC InfoNCE) and supervised (CTC) updates over a
network of three archs (``--arch=encoder,context,predict``): ``--supdelay``
(updates before supervision starts), ``--unsupdates``/``--supdates`` (the
alternation), ``--twostage`` (no encoder gradient in the supervised phase),
``--trainencoder``/``--traincontext``/``--freeze`` gating,
``--grad_mult_feat`` (the encoder's gradient scale), ``--l2_enc_pen``,
``--lr2`` with the supervised ramp ``--supwarmup``/``--suphold``,
``--maxgradnorm2`` and ``--pretrainmodel``.

As in JAX: one optimizer over the four parameter groups ``enc``, ``ctx``,
``prd``, ``cpc`` (a gated group gets a zero gradient, so momentum and weight
decay still move it), the network in fp32 whatever ``--compute_dtype`` says,
the predict arch in eval mode, both data streams in the order of
``batch_specs(shuffle_seed=--seed)`` pass after pass, one ``001_log`` and
``model_last.bin`` with ``extra["cpc_flags"]``. ``continue`` keeps the
flags it is given (not the stored ones, as JAX).

Draws: the mask and the negatives of update ``u`` come from a generator on
the device seeded by ``(--seed + 13, u)``, dropout from the device's global
generator seeded alike; a step also takes the draws (``mask_idx``, ``r``) from
the caller and returns those it used. Unlike JAX, whose ``continue`` restarts
both data streams and its key stream, a ``continue`` here skips the batches the
run consumed, so 2 updates and ``continue`` for 2 take the batches and draws of
4 updates.

It trains in one process: on several ranks it raises (the JAX trainer's data
parallelism is not ported).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..criterions.cpc import CPCConfig, CPCCriterion
from ..data import AsrDataset, Lexicon, PrefetchIterator, make_token_dict
from ..data.batching import pad_batch_rows
from ..features import FeatureParams, Featurizer
from ..kernels import disable_tf32
from ..models.arch import build_arch_module
from ..ops.ctc import ctc_loss
from ..optim import LRSchedule, make_optimizer
from ..parallel.distributed import world_size
from .checkpoint import Checkpoint, find_last_checkpoint, load_checkpoint, save_checkpoint
from .test import resolve_device
from .train import update_seed

# CPC-specific flags (reference DEFINEs, cpc/Train.cpp:45-203), carried in a
# side dict: they are the recipe's, not core flags. JAX's defaults.
CPC_DEFAULTS = dict(
    codedim=256,
    contextdim=256,
    mutualdim=256,
    maskprob=0.065,
    masklength=10,
    temperature=0.1,
    nnegativesamples=100,
    supdelay=0,
    supdates=1,
    unsupdates=1,
    twostage=False,
    trainencoder=True,
    traincontext=True,
    freeze=False,
    grad_mult_feat=1.0,
    l2_enc_pen=0.0,
    lr2=0.0,
    # the supervised branch's LR ramp (Train.cpp:908-916)
    supwarmup=0,
    suphold=0,
    # the supervised criterion (only "ctc", the reference default) and its clip
    criterion2="ctc",
    lrcrit2=0.0,
    maxgradnorm2=0.0,
    # start from pretrained weights (Train.cpp:495-503 PartialLoading)
    pretrainmodel="",
)
GROUPS = ("enc", "ctx", "prd", "cpc")


class CPCTrainer:
    def __init__(self, cfg: Config, cpc_flags: Optional[Dict] = None, mode: str = "train",
                 device: str = "cuda"):
        self.cfg = cfg
        self.fl = dict(CPC_DEFAULTS)
        if cpc_flags:
            self.fl.update(cpc_flags)
        if str(self.fl.get("criterion2", "ctc")) != "ctc":
            raise ValueError(
                "--criterion2: only 'ctc' is supported (the reference default;"
                " no vox_populi recipe uses another supervised criterion)")
        ranks = max(cfg.world_size if cfg.enable_distributed else 1, world_size(),
                    int(os.environ.get("WORLD_SIZE", "1")))
        if ranks > 1:
            raise NotImplementedError(
                f"CPC training on {ranks} ranks: the port trains CPC in one process only")
        self.updates = 0
        self.mode = mode
        self.device = resolve_device(device)
        disable_tf32()
        self.rundir = os.path.join(cfg.rundir, cfg.runname) if cfg.runname else cfg.rundir
        resume = None
        if mode == "continue" and self.rundir:
            last = find_last_checkpoint(self.rundir)
            if not last:
                raise FileNotFoundError(
                    f"continue: no checkpoint (model_last.bin) under {self.rundir!r}")
            resume = load_checkpoint(last)
            self.updates = resume.updates
        if self.rundir:
            os.makedirs(self.rundir, exist_ok=True)

        tokens_path = os.path.join(cfg.tokensdir, cfg.tokens) if cfg.tokensdir else cfg.tokens
        self.token_dict = make_token_dict(tokens_path, "ctc", 0, False)
        self.n_classes = len(self.token_dict)
        self.lexicon = Lexicon.from_file(cfg.lexicon) if cfg.lexicon else None
        self.featurizer = Featurizer(FeatureParams.from_config(cfg)).to(self.device)
        self.n_feat = cfg.num_features()

        # --- the network of three archs and the criterion ---
        archs = [a.strip() for a in cfg.arch.split(",")]
        if len(archs) != 3:
            raise ValueError("CPC training needs --arch=encoder,context,predict")
        paths = [os.path.join(cfg.archdir, a) if cfg.archdir else a for a in archs]
        code, ctxd = int(self.fl["codedim"]), int(self.fl["contextdim"])
        torch.manual_seed(cfg.seed)
        self.encoder = build_arch_module(paths[0], self.n_feat, code)
        self.context = build_arch_module(paths[1], code, ctxd)
        self.predict = build_arch_module(paths[2], ctxd, self.n_classes)
        self.cpc = CPCCriterion(CPCConfig(
            n_encoder=code, n_context=ctxd, n_mutual=int(self.fl["mutualdim"]),
            n_negative=int(self.fl["nnegativesamples"]),
            temperature=float(self.fl["temperature"]),
            mask_prob=float(self.fl["maskprob"]), mask_length=int(self.fl["masklength"])))
        self.net = nn.ModuleDict(dict(zip(GROUPS, (self.encoder, self.context, self.predict,
                                                   self.cpc))))

        # --- pretrained / resumed weights ---
        if str(self.fl["pretrainmodel"]):
            # matching groups of a CPC checkpoint (Train.cpp:495-503); a plain
            # ASR checkpoint seeds the encoder
            src = load_checkpoint(str(self.fl["pretrainmodel"])).state_dict
            if {k.split(".", 1)[0] for k in src} >= {"enc", "ctx"}:
                for g, mod in self.net.items():
                    sub = {k[len(g) + 1:]: v for k, v in src.items() if k.startswith(g + ".")}
                    if sub:
                        mod.load_state_dict(sub, strict=True)
            else:
                self.encoder.load_state_dict(src, strict=True)
        if resume is not None:
            self.net.load_state_dict(resume.state_dict, strict=True)
        self.net.to(self.device)

        # --- one optimizer; the two phases' schedules ---
        lr2 = float(self.fl["lr2"]) or cfg.lr
        self.sched_unsup = LRSchedule.from_config(cfg, cfg.lr)
        self.sched_sup = dataclasses.replace(
            LRSchedule.from_config(cfg, lr2),
            warmup=int(self.fl["supwarmup"]), hold=int(self.fl["suphold"]))
        self.opt = make_optimizer(self.net.named_parameters(), cfg.netoptim, cfg.momentum,
                                  cfg.weightdecay, cfg.adambeta1, cfg.adambeta2,
                                  cfg.optimepsilon)
        if resume is not None and resume.opt_state:
            self.opt.load_state_dict(resume.opt_state)

        self.sup_ds = (AsrDataset(cfg.train, self.token_dict, self.lexicon, cfg)
                       if cfg.train else None)
        self.unsup_ds = (AsrDataset(cfg.train2, self.token_dict, self.lexicon, cfg,
                                    allow_empty_targets=True)
                         if cfg.train2 else None)

    # ------------------------------------------------------------------
    def _grad_gates(self, phase: str) -> Dict[str, float]:
        """Per-group gradient multipliers: trainencoder, traincontext, freeze,
        twostage and grad_mult_feat."""
        g = {"enc": float(self.fl["grad_mult_feat"]), "ctx": 1.0, "prd": 1.0, "cpc": 1.0}
        if not self.fl["trainencoder"]:
            g["enc"] = 0.0
        if not self.fl["traincontext"]:
            g["ctx"] = 0.0
        if phase == "sup" and (self.fl["twostage"] or self.fl["freeze"]):
            g["enc"] = 0.0
            if self.fl["freeze"]:
                g["ctx"] = 0.0
        return g

    def in_sup_phase(self, update: int) -> bool:
        """The phase rule of update ``update`` (JAX's ``run``)."""
        if self.unsup_ds is None:
            return True
        if self.sup_ds is None:
            return False
        fl = self.fl
        return (update >= int(fl["supdelay"])
                and update % (int(fl["supdates"]) + int(fl["unsupdates"]))
                >= int(fl["unsupdates"]))

    def _begin(self, batch, seed: int):
        self.encoder.train()
        self.context.train()
        self.cpc.train()
        self.predict.eval()  # JAX applies it without train=True
        for p in self.net.parameters():
            p.grad = None
        torch.manual_seed(seed)  # dropout: the device's global generator
        b = {k: torch.as_tensor(batch[k]).to(self.device)
             for k in ("audio", "audio_len", "target", "target_len", "row_mask")}
        feats, flen = self.featurizer(b["audio"], b["audio_len"])
        enc, elen = self.encoder(feats.float(), flen)
        return b, enc, elen

    def _finish(self, loss, gates: Dict[str, float], lr: float, max_norm: float):
        """Gate, clip (``max_norm`` > 0), zero a non-finite step's gradients,
        then step; returns (loss, finite)."""
        with torch.no_grad():
            grads = []
            for g, mod in self.net.items():
                for p in mod.parameters():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    if gates[g] != 1.0:
                        p.grad.mul_(gates[g])
                    grads.append(p.grad)
            loss_v = float(loss.detach())
            finite = bool(np.isfinite(loss_v))
            if max_norm > 0:
                gn = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(x.float()) for x in grads]))
                torch._foreach_mul_(grads, float(torch.clamp(max_norm / (gn + 1e-12),
                                                             max=1.0)))
            if not finite:
                torch._foreach_zero_(grads)
            self.opt.step(lr)
        return loss_v, finite

    def unsup_step(self, batch, lr: float, seed: int, draws: Optional[Dict] = None):
        """One CPC update on a padded batch. ``draws``: ``mask_idx`` (B, K) and
        ``r`` (B, K, n) to use instead of drawing. Returns (loss, finite, the
        draws used)."""
        b, enc, elen = self._begin(batch, seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        B, T = enc.shape[:2]
        if draws is None:
            mask, mask_idx = self.cpc.make_mask(B, T, gen, self.device)
            r = self.cpc.negative_draws(B, mask_idx.shape[1], gen, self.device)
        else:
            mask_idx = torch.as_tensor(draws["mask_idx"]).to(self.device).long()
            r = torch.as_tensor(draws["r"]).to(self.device)
            mask = torch.zeros((B, T), dtype=torch.bool, device=self.device).scatter_(
                1, mask_idx, True)
        ctx, _ = self.context(self.cpc.apply_mask(enc, mask), elen)
        losses = self.cpc(enc, ctx, mask_idx, r=r)
        rm = b["row_mask"]
        loss = (losses * rm).sum() / rm.sum().clamp(min=1.0)
        l2pen = float(self.fl["l2_enc_pen"])
        if l2pen > 0:
            loss = loss + l2pen * enc.float().pow(2).mean()
        loss.backward()
        loss_v, finite = self._finish(loss, self._grad_gates("unsup"), lr, 0.0)
        return loss_v, finite, {"mask_idx": mask_idx, "r": r}

    def sup_step(self, batch, lr: float, seed: int):
        """One CTC update through the three archs; returns (loss, finite)."""
        b, enc, elen = self._begin(batch, seed)
        ctx, clen = self.context(enc, elen)
        em, emlen = self.predict(ctx, clen)
        losses = ctc_loss(em.float(), b["target"], emlen, b["target_len"])
        rm = b["row_mask"]
        loss = (losses * rm).sum() / rm.sum().clamp(min=1.0)
        loss.backward()
        # the supervised phase clips with --maxgradnorm2 when set
        # (Train.cpp:84-85, :1341-1351), else --maxgradnorm
        mgn = float(self.fl.get("maxgradnorm2", 0.0)) or self.cfg.maxgradnorm
        return self._finish(loss, self._grad_gates("sup"), lr, mgn)

    # ------------------------------------------------------------------
    def _stream(self, ds: AsrDataset, skip: int):
        """The batches of ``ds`` in the order of ``batch_specs(shuffle_seed=
        --seed)``, pass after pass, from the ``skip``-th on."""
        specs = ds.batch_specs(shuffle_seed=self.cfg.seed)
        if not specs:
            raise ValueError("CPC training: a data list gives no batch")
        start = skip % len(specs)
        while True:
            for b in PrefetchIterator(ds, specs[start:], num_threads=self.cfg.nthread):
                yield pad_batch_rows(b, 1)
            start = 0

    def run(self):
        cfg = self.cfg
        done_sup = sum(self.in_sup_phase(u) for u in range(self.updates))
        sup_gen = self._stream(self.sup_ds, done_sup) if self.sup_ds else None
        unsup_gen = (self._stream(self.unsup_ds, self.updates - done_sup)
                     if self.unsup_ds else None)
        losses = {"sup": [], "unsup": []}
        while self.updates < cfg.iter:
            seed = update_seed(cfg.seed + 13, self.updates)
            if self.in_sup_phase(self.updates):
                lr = self.sched_sup(self.updates)
                loss, _ = self.sup_step(next(sup_gen), lr, seed)
                losses["sup"].append(loss)
            else:
                lr = self.sched_unsup(self.updates)
                loss, _, _ = self.unsup_step(next(unsup_gen), lr, seed)
                losses["unsup"].append(loss)
            self.updates += 1
            if cfg.reportiters > 0 and self.updates % cfg.reportiters == 0:
                self._report(losses, lr)
                losses = {"sup": [], "unsup": []}
                self.save_checkpoint()
        self.save_checkpoint()
        return losses

    def _report(self, losses, lr):
        parts = [f"nupdates: {self.updates:>12d}", f"lr: {lr:09.6f}"]
        for ph in ("unsup", "sup"):
            if losses[ph]:
                parts.append(f"loss-{ph}: {np.mean(losses[ph]):10.5f}")
        line = " | ".join(parts)
        print(line, flush=True)
        if self.rundir:
            with open(os.path.join(self.rundir, "001_log"), "a") as f:
                f.write(line + "\n")

    def save_checkpoint(self):
        """``model_last.bin``: the four groups under ``enc.``, ``ctx.``,
        ``prd.``, ``cpc.``, the optimizer and ``extra["cpc_flags"]``."""
        if not self.rundir:
            return
        ckpt = Checkpoint(config=self.cfg.serialize(), epoch=0, updates=self.updates,
                          state_dict=self.net.state_dict(), opt_state=self.opt.state_dict(),
                          extra={"cpc_flags": dict(self.fl)})
        save_checkpoint(os.path.join(self.rundir, "model_last.bin"), ckpt)
