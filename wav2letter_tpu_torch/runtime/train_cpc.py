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

Several ranks (``--enable_distributed``, or a process group the caller has
initialized) train data-parallel as JAX's trainer does over its mesh: the
weights are rank 0's everywhere, each rank reads the rows
``data_index::n_data`` of every global batch of both lists (padded to the
global batch's T, so every rank masks the same K), the mask and the negatives
are drawn once for the global (B, T) from the update's generator and each
rank takes its rows, the losses divide by the global count of real rows, and
the four groups' gradients (and the loss) are summed over the ranks before
the gates, the clip and the non-finite guard. Two ranks are then one process
at the global batch, but for dropout, which each rank draws for its own rows
(as ``Trainer`` does). Rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import record_function

from ..config import Config
from ..criterions.cpc import CPCConfig, CPCCriterion
from ..data import AsrDataset, Lexicon, PrefetchIterator, make_token_dict
from ..data.batching import pad_batch_rows
from ..features import FeatureParams, Featurizer
from ..kernels import disable_tf32
from ..models.arch import build_arch_module
from ..ops.ctc import ctc_loss
from ..optim import LRSchedule, make_optimizer
from ..parallel import MeshSpec, make_mesh, replicate
from ..parallel.distributed import backend_for, init_distributed, local_rank
from ..parallel.sharding import all_reduce_grads, dataset_shard
from .checkpoint import Checkpoint, find_last_checkpoint, load_checkpoint, save_checkpoint
from .test import resolve_device
from .train import rank_seed, update_seed

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
        self.updates = 0
        self.mode = mode
        # --- ranks: join the group, then one device a rank (as ``Trainer``) ---
        dev = torch.device(device)
        if cfg.enable_distributed:
            init_distributed(backend_for(dev), cfg.world_rank, cfg.world_size)
        if dev.type == "cuda" and dev.index is None and dist.is_initialized():
            dev = torch.device("cuda", local_rank())
        self.device = resolve_device(str(dev))
        if self.device.index is not None:
            torch.cuda.set_device(self.device)
        disable_tf32()
        self.mesh = make_mesh(MeshSpec.from_config(cfg), self.device)
        self.rundir = os.path.join(cfg.rundir, cfg.runname) if cfg.runname else cfg.rundir
        resume = None
        if mode == "continue" and self.rundir:
            last = find_last_checkpoint(self.rundir)
            if not last:
                raise FileNotFoundError(
                    f"continue: no checkpoint (model_last.bin) under {self.rundir!r}")
            resume = load_checkpoint(last)
            self.updates = resume.updates
        if self.rundir and self.mesh.rank == 0:
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
        replicate(self.mesh, self.net)

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

        # each rank reads the rows of its data index of every global batch
        w_rank, w_size = dataset_shard(self.mesh)
        self.sup_ds = (AsrDataset(cfg.train, self.token_dict, self.lexicon, cfg,
                                  world_rank=w_rank, world_size=w_size)
                       if cfg.train else None)
        self.unsup_ds = (AsrDataset(cfg.train2, self.token_dict, self.lexicon, cfg,
                                    allow_empty_targets=True,
                                    world_rank=w_rank, world_size=w_size)
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
        # dropout: the device's global generator, each rank for its own rows
        torch.manual_seed(rank_seed(seed, self.mesh.data_index))
        b = {k: torch.as_tensor(batch[k]).to(self.device)
             for k in ("audio", "audio_len", "target", "target_len", "row_mask")}
        feats, flen = self.featurizer(b["audio"], b["audio_len"])
        enc, elen = self.encoder(feats.float(), flen)
        return b, enc, elen

    def _global_rows(self, row_mask: torch.Tensor) -> torch.Tensor:
        """The global batch's real rows (summed over the data ranks): the
        losses' divisor and the row count of the global draws."""
        n = row_mask.sum().to(torch.float32).reshape(1).clone()
        if self.mesh.distributed:
            dist.all_reduce(n, group=self.mesh.data_group)
        return n[0]

    def _my_rows(self, B: int, n: int) -> torch.Tensor:
        """The rows of the global draws (``n`` rows) that this rank's ``B``
        rows take (``data_index::n_data``); a padding row past them takes the
        last one's."""
        rows = self.mesh.data_index + self.mesh.spec.n_data * torch.arange(
            B, device=self.device)
        return rows.clamp(max=max(n - 1, 0))

    def _finish(self, loss, gates: Dict[str, float], lr: float, max_norm: float):
        """Sum the gradients and the loss over the ranks, then gate, clip
        (``max_norm`` > 0), zero a non-finite step's gradients, and step;
        returns (the global batch's loss, finite)."""
        with torch.no_grad():
            groups = []
            for g, mod in self.net.items():
                for p in mod.parameters():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    groups.append((g, p.grad))
            grads = [x for _, x in groups]
            loss = loss.detach().reshape(1).clone()
            with record_function("w2l/all_reduce"):
                all_reduce_grads(self.mesh, grads + [loss], [])
            for g, x in groups:
                if gates[g] != 1.0:
                    x.mul_(gates[g])
            loss_v = float(loss[0])
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
        """One CPC update on a padded batch (this rank's rows of the global
        batch). ``draws``: ``mask_idx`` (n, K) and ``r`` (n, K, negatives) of
        the global batch's ``n`` real rows, to use instead of drawing. Returns
        (loss, finite, the global draws used)."""
        b, enc, elen = self._begin(batch, seed)
        B, T = enc.shape[:2]
        n = self._global_rows(b["row_mask"])
        if draws is None:  # once for the global (n, T), the same on every rank
            gen = torch.Generator(device=self.device).manual_seed(seed)
            _, g_idx = self.cpc.make_mask(int(n), T, gen, self.device)
            g_r = self.cpc.negative_draws(int(n), g_idx.shape[1], gen, self.device)
        else:
            g_idx = torch.as_tensor(draws["mask_idx"]).to(self.device).long()
            g_r = torch.as_tensor(draws["r"]).to(self.device)
        rows = self._my_rows(B, g_idx.shape[0])
        mask_idx, r = g_idx[rows], g_r[rows]
        mask = torch.zeros((B, T), dtype=torch.bool, device=self.device).scatter_(
            1, mask_idx, True)
        ctx, _ = self.context(self.cpc.apply_mask(enc, mask), elen)
        losses = self.cpc(enc, ctx, mask_idx, r=r)
        loss = (losses * b["row_mask"]).sum() / n.clamp(min=1.0)
        l2pen = float(self.fl["l2_enc_pen"])
        if l2pen > 0:  # the mean over the global (padded) batch, once summed
            loss = loss + l2pen * enc.float().pow(2).mean() / self.mesh.spec.n_data
        loss.backward()
        loss_v, finite = self._finish(loss, self._grad_gates("unsup"), lr, 0.0)
        return loss_v, finite, {"mask_idx": g_idx, "r": g_r}

    def sup_step(self, batch, lr: float, seed: int):
        """One CTC update through the three archs; returns (loss, finite)."""
        b, enc, elen = self._begin(batch, seed)
        ctx, clen = self.context(enc, elen)
        em, emlen = self.predict(ctx, clen)
        losses = ctc_loss(em.float(), b["target"], emlen, b["target_len"])
        n = self._global_rows(b["row_mask"])
        loss = (losses * b["row_mask"]).sum() / n.clamp(min=1.0)
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
        if self.mesh.rank != 0:
            return
        print(line, flush=True)
        if self.rundir:
            with open(os.path.join(self.rundir, "001_log"), "a") as f:
                f.write(line + "\n")

    def save_checkpoint(self):
        """``model_last.bin``: the four groups under ``enc.``, ``ctx.``,
        ``prd.``, ``cpc.``, the optimizer and ``extra["cpc_flags"]``; rank 0
        writes, the others wait at a barrier."""
        if not self.rundir:
            return
        if self.mesh.rank == 0:
            ckpt = Checkpoint(config=self.cfg.serialize(), epoch=0, updates=self.updates,
                              state_dict=self.net.state_dict(),
                              opt_state=self.opt.state_dict(),
                              extra={"cpc_flags": dict(self.fl)})
            save_checkpoint(os.path.join(self.rundir, "model_last.bin"), ckpt)
        if self.mesh.distributed:
            dist.barrier()
