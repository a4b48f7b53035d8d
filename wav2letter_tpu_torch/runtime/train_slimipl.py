"""slimIPL — semi-supervised training with a pseudo-label cache, the port of
``wav2letter_tpu/runtime/train_slimipl.py`` (reference
``recipes/slimIPL/src/Train.cpp``: flags ``:79-102``, cache dump/restore
``:477-533``, PL generation ``:1362-1417``, cache-type dispatch
``:1483-1650``, post-update relabel ``:1833-1841``).

  * supervised warmup until ``--slimIPL_start`` updates, then shuffled
    windows of ``--slimIPL_sup_updates`` supervised and
    ``--slimIPL_unsup_updates`` unsupervised batches (``setsOrder``);
  * ``--slimIPL_type``: ``naive`` (relabel the batch with the current model,
    train on it), ``cache`` (train on cached PLs, then relabel with the
    updated model; an update with no cached row is skipped and labels the
    batch), ``pre-cache`` (relabel with the model of before the update,
    always), ``fixed-pre-cache`` (a cache of ``--slimIPL_fixed_cache_updates``
    batches: while it fills, each unsup step labels one batch and takes no
    update; then batches are served from shuffled passes over it, and with
    probability ``--slimIPL_fixed_cache_update_prob`` a newly labeled batch
    replaces the served slot);
  * ``--slimIPL_use_soft`` (fixed-pre-cache only): the cache keeps fp16
    emissions and the unsup loss is ``soft_scale * CE(softmax(cached),
    log_softmax(current))``, averaged over the valid frames as in JAX (the
    reference averages over the padded time axis);
  * ``--slimIPL_ema``: PLs from an EMA of the parameters, moved after every
    update and kept in the checkpoint;
  * the PL-quality meter (WER of the PLs against the list's transcripts),
    the unsup meters, ``--slimIPL_saug`` (a stronger SpecAugment for the
    supervised batches: ``fmaskn + 1``, ``tmaskn * 1.5``) and
    ``--slimIPL_dyn_dropout`` (every dropout of the arch set to this value at
    PL start; the parameters and the optimizer state carry over);
  * caches persist for an exact ``continue``: token PLs as JSON, the fixed
    batch list as JSON, soft emissions as NPZ, in JAX's formats.

The decisions (windows, fixed-cache draws and passes) use JAX's
``random.Random(--seed + 99)`` in JAX's order, so they equal JAX's. Rows with
no PL are masked through ``sample_idx = -1`` (``pad_batch_rows`` makes their
``row_mask`` 0), as there. Every update draws as the port's ``Trainer`` does,
from ``(--seed + 7, update)`` and the rank's data index.

On several ranks each rank labels and trains on its rows of every global
batch: the counts that decide a skip, and the soft loss's frames, are summed
over the data ranks, the update's gradients as in ``Trainer``, and the
caches are merged before rank 0 writes them.
"""

from __future__ import annotations

import copy
import json
import os
import random
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import Config
from ..data import AsrDataset, PrefetchIterator
from ..data.batching import pad_batch_rows
from ..data.targets import tokens_to_words
from ..features.specaug import SpecAugment
from ..models.arch import build_arch_from_lines, parse_arch_file
from ..models.plugin import is_plugin
from ..parallel.sharding import dataset_shard
from .meters import DatasetMeters, EditDistanceMeter
from .test import path_tokens
from .train import Trainer

SLIMIPL_DEFAULTS = dict(  # upstream defaults, slimIPL/src/Train.cpp:79-102
    unsup_datadir="",  # prefix for --unsup_train (Train.cpp:73-78)
    unsup_train="",  # comma list of unlabeled .lst files
    slimIPL_start=0,
    slimIPL_type="naive",  # naive|cache|pre-cache|fixed-pre-cache
    slimIPL_fixed_cache_updates=1000,  # size of the fixed batch cache
    slimIPL_cache_path="",
    slimIPL_sup_updates=1,
    slimIPL_unsup_updates=3,
    slimIPL_fixed_cache_update_prob=1.0,
    slimIPL_ema=False,
    slimIPL_ema_decay=0.999,
    slimIPL_use_soft=False,  # frame-wise soft-label distillation loss
    slimIPL_soft_scale=20.0,
    slimIPL_saug=False,  # stronger SpecAugment for sup batches (:1052-1076)
    slimIPL_dyn_dropout=-1.0,  # set all net dropouts to this at PL start
)
# the dropout's operand of each mnemonic that has one
DROPOUT_OPERAND = {"DO": 1, "TDS": 4, "TR": 5, "CFR": 6}


class SlimIPLTrainer(Trainer):
    """The port's ``Trainer`` with an unsupervised PL stream."""

    def __init__(self, cfg: Config, ipl_flags: Optional[Dict] = None,
                 unsup_list: str = "", **kw):
        super().__init__(cfg, **kw)
        cfg = self.cfg
        # the PL and soft paths featurize raw audio themselves
        self.host_features = False
        self.train_ds.set_host_featurizer(None)
        for ds in self.valid_ds.values():
            ds.set_host_featurizer(None)
        self.fl = dict(SLIMIPL_DEFAULTS)
        if ipl_flags:
            ipl_flags = dict(ipl_flags)
            if "slimIPL_cache_sz" in ipl_flags:  # legacy alias
                ipl_flags["slimIPL_fixed_cache_updates"] = ipl_flags.pop("slimIPL_cache_sz")
            self.fl.update(ipl_flags)
        if self.fl["slimIPL_type"] not in ("naive", "cache", "pre-cache", "fixed-pre-cache"):
            raise ValueError(f"unknown slimIPL_type {self.fl['slimIPL_type']!r}")
        self.specaug_strong = None
        if self.fl["slimIPL_saug"] and cfg.saug_start_update >= 0:
            self.specaug_strong = SpecAugment(
                n_freq_masks=cfg.saug_fmaskn + 1, freq_mask_f=cfg.saug_fmaskf,
                n_time_masks=int(cfg.saug_tmaskn * 1.5), time_mask_t=cfg.saug_tmaskt,
                time_mask_p=cfg.saug_tmaskp)
        # unlabeled stream: explicit arg > --unsup_datadir/--unsup_train > --train2
        unsup_spec = unsup_list
        if not unsup_spec and str(self.fl["unsup_train"]):
            dd = str(self.fl["unsup_datadir"])
            unsup_spec = ",".join(
                os.path.join(dd, p) if dd and not os.path.isabs(p) else p
                for p in str(self.fl["unsup_train"]).split(",") if p.strip())
        unsup_spec = unsup_spec or cfg.train2
        w_rank, w_size = dataset_shard(self.mesh)
        self.unsup_ds = AsrDataset(unsup_spec, self.token_dict, self.lexicon, cfg,
                                   allow_empty_targets=True, world_rank=w_rank,
                                   world_size=w_size)
        self.cache: Dict[str, List[int]] = {}  # sample_id -> token ids
        self.soft_cache: Dict[str, np.ndarray] = {}  # sample_id -> fp16 (elen, N)
        self.fixed_cache: List[int] = []  # unsup batch-spec indices
        self._cache_hits = 0
        self._label_cursor = 0
        self._label_order: List[int] = []
        self.meters_unsup = DatasetMeters()
        self.pl_quality = EditDistanceMeter()
        self.ema_model = None
        if self.fl["slimIPL_ema"]:
            self.ema_model = copy.deepcopy(self.model)
            for p in self.ema_model.parameters():
                p.requires_grad_(False)
            ema = (self._resume.extra.get("ema_params")
                   if self._resume is not None else None)
            if ema:
                with torch.no_grad():
                    for n, p in self.ema_model.named_parameters():
                        p.copy_(ema[n])
        self._rng = random.Random(cfg.seed + 99)
        self._restore_cache()

    # -- cache persistence (Train.cpp:477-533) -------------------------------
    def _cache_file(self, suffix=""):
        p = self.fl["slimIPL_cache_path"] or (
            os.path.join(self.rundir, "pl_cache") if self.rundir else "")
        if p.endswith(".json"):  # legacy explicit ".json" cache paths
            p = p[: -len(".json")]
        return (p + suffix) if p else ""

    def _restore_cache(self):
        p = self._cache_file(".json")
        if p and os.path.exists(p):
            with open(p) as f:
                self.cache = {k: list(map(int, v)) for k, v in json.load(f).items()}
            self._log(f"slimIPL: restored {len(self.cache)} cached PLs")
        p = self._cache_file("_fixed.json")
        if p and os.path.exists(p):
            with open(p) as f:
                st = json.load(f)
            self.fixed_cache = list(map(int, st["batches"]))[
                : int(self.fl["slimIPL_fixed_cache_updates"])]
            self._cache_hits = min(int(st.get("hits", 0)), len(self.fixed_cache))
            self._label_cursor = int(st.get("cursor", 0))
            self._log(f"slimIPL: restored fixed cache of {len(self.fixed_cache)} batches")
        p = self._cache_file("_soft.npz")
        if p and os.path.exists(p):
            with np.load(p) as z:
                self.soft_cache = {k: z[k] for k in z.files}
            self._log(f"slimIPL: restored {len(self.soft_cache)} soft PLs")

    def _dump_cache(self):
        if self.mesh.distributed:  # each rank labels its own rows
            parts = [None] * dist.get_world_size()
            dist.all_gather_object(parts, (self.cache, self.soft_cache))
            for cache, soft in parts:
                self.cache.update(cache)
                self.soft_cache.update(soft)
        if self.mesh.rank != 0:
            return
        p = self._cache_file(".json")
        if p:
            with open(p, "w") as f:
                json.dump(self.cache, f)
        if self.fixed_cache:
            with open(self._cache_file("_fixed.json"), "w") as f:
                json.dump({"batches": self.fixed_cache, "hits": self._cache_hits,
                           "cursor": self._label_cursor}, f)
        if self.soft_cache:
            np.savez(self._cache_file("_soft.npz"), **self.soft_cache)

    def _ckpt_extra(self):
        if self.ema_model is None:
            return {}
        return {"ema_params": {n: p.detach().cpu()
                               for n, p in self.ema_model.named_parameters()}}

    # -- PL generation (predictPLCommon, Train.cpp:1362-1417) -----------------
    @torch.no_grad()
    def _pl_forward(self, padded):
        """Emissions, their lengths and the viterbi path of the PL model (the
        EMA's parameters with the live model's buffers, or the live model)."""
        model = self.model
        if self.ema_model is not None:
            model = self.ema_model
            for e, b in zip(model.buffers(), self.model.buffers()):
                e.copy_(b)
        model.eval()
        b = self._to_device(padded)
        feats, flen = self.featurizer(b["audio"], b["audio_len"])
        em, elen = model(feats.to(self.compute_dtype), flen)
        em = em.float()
        vit, vlen = self._viterbi(em, elen)
        return em, elen, vit, vlen

    def _generate_pls(self, batch, want_soft=False):
        """Greedy transcripts of ``batch`` by the PL model: ``{dataset index:
        token ids}`` and, with ``want_soft``, ``{dataset index: fp16 emissions
        (elen, N)}``. Meters the PL quality against the list's transcripts."""
        padded = pad_batch_rows(batch, 1)
        em, elen, vit, vlen = self._pl_forward(padded)
        elen, vit, vlen = elen.cpu().numpy(), vit.cpu().numpy(), vlen.cpu().numpy()
        sidx = np.asarray(padded["sample_idx"])
        tgts, tlens = np.asarray(padded["target"]), np.asarray(padded["target_len"])
        out, soft = {}, {}
        wsep = self.cfg.wordseparator
        if want_soft:
            em = em.cpu().numpy().astype(np.float16)
        for i in range(len(sidx)):
            if sidx[i] < 0:
                continue
            toks = path_tokens(vit[i, : int(vlen[i])], self.cfg, self.n_classes)
            out[int(sidx[i])] = toks
            if want_soft:
                soft[int(sidx[i])] = em[i, : int(elen[i])]
            if tlens[i] > 0:  # PL quality against the given transcript
                ref = [int(t) for t in tgts[i, : int(tlens[i])]]
                self.pl_quality.add(
                    tokens_to_words(self.token_dict.map_indices(ref), wsep,
                                    self.cfg.usewordpiece),
                    tokens_to_words(self.token_dict.map_indices(toks), wsep,
                                    self.cfg.usewordpiece))
        return (out, soft) if want_soft else out

    def _store_pls(self, pls: Dict[int, List[int]], soft=None):
        for i, toks in pls.items():
            self.cache[self.unsup_ds.samples[i].sample_id] = toks
        if soft:
            for i, em in soft.items():
                self.soft_cache[self.unsup_ds.samples[i].sample_id] = em

    def _relabel(self, batch, from_cache: bool):
        """The batch with its targets replaced by PLs, and the count of rows
        with one over the data ranks; rows without one get ``sample_idx = -1``
        (masked out of the loss and the meters)."""
        ids = [int(i) for i in batch["sample_idx"]]
        labels = []
        for i in ids:
            sid = self.unsup_ds.samples[i].sample_id
            labels.append(self.cache.get(sid) if from_cache else self.cache[sid])
        # over the data ranks, so that every rank takes the same branch
        n = int(self._global_count(sum(l is not None for l in labels)))
        if n == 0:
            return None, 0
        width = max(max((len(l) for l in labels if l is not None), default=1), 1)
        width = -(-width // 16) * 16  # JAX buckets the target widths
        tgt = np.full((len(ids), width), -1, dtype=np.int32)
        tlen = np.zeros((len(ids),), dtype=np.int32)
        sidx = np.asarray(batch["sample_idx"]).copy()
        for r, l in enumerate(labels):
            if l is None:
                sidx[r] = -1
                continue
            l = l[:width]
            tgt[r, : len(l)] = l
            tlen[r] = len(l)
        return dict(batch, target=tgt, target_len=tlen, sample_idx=sidx), n

    @torch.no_grad()
    def _update_ema(self):
        if self.ema_model is None:
            return
        d = float(self.fl["slimIPL_ema_decay"])
        ema = list(self.ema_model.parameters())
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, list(self.model.parameters()), alpha=1 - d)

    # -- dyn dropout (Train.cpp:1465-1469) -------------------------------------
    def _apply_dyn_dropout(self):
        """Rebuild the arch with every dropout at ``--slimIPL_dyn_dropout``; the
        parameters, buffers and optimizer state carry over."""
        p = float(self.fl["slimIPL_dyn_dropout"])
        cfg = self.cfg
        arch_path = os.path.join(cfg.archdir, cfg.arch) if cfg.archdir else cfg.arch
        if is_plugin(arch_path):
            self._log("slimIPL: dyn_dropout unsupported for plugin archs; skipped")
            return
        out = []
        for line in parse_arch_file(arch_path, self.n_feat, self.model.n_label):
            t = line.split()
            pos = DROPOUT_OPERAND.get(t[0])
            if pos is not None and len(t) > pos:
                t[pos] = repr(p)
            out.append(" ".join(t))
        model = build_arch_from_lines(out, self.model.n_label)
        model.load_state_dict(self.model.state_dict(), strict=True)
        self.model = model.to(self.device)
        self.net_opt.params = list(self.model.named_parameters())
        self.arch_lines = out
        self._log(f"slimIPL: dropouts set to {p}")

    # -- the updates -------------------------------------------------------------
    def _run_train_step(self, batch, seed: int, sup: bool):
        """One update on labels (true or PLs); loss and TER to the right meters."""
        cfg = self.cfg
        lr = self.net_sched(self.updates, self.epoch)
        lr_crit = self.crit_sched(self.updates, self.epoch)
        saug_on = 0 <= cfg.saug_start_update <= self.updates
        padded = pad_batch_rows(batch, 1)
        specaug = self.specaug
        if sup and self.specaug_strong is not None:
            self.specaug = self.specaug_strong
        try:
            loss, finite, vit, vlen = self.train_step(padded, lr, lr_crit, saug_on, seed)
        finally:
            self.specaug = specaug
        self.updates += 1
        self._update_ema()
        m = self.meters.train if sup else self.meters_unsup
        if finite:
            m.loss.add(loss, int(padded["row_mask"].sum()))
        if np.random.rand() * 100.0 < cfg.pcttraineval:
            self._update_edit_meters(m, vit, vlen, padded)
        self.meters.speed.add_audio(float(np.sum(padded["audio_len"])) / cfg.samplerate)

    def soft_step(self, padded, soft_rows, lr: float, saug_on: bool, seed: int):
        """One update of the network against soft targets (no criterion, no
        criterion optimizer, no loss scaling, as JAX's): ``soft_rows[r]`` the
        cached fp16 emissions of row r or None. The loss is that of the global
        batch, over its valid frames on every rank. Returns (loss, finite)."""
        self.model.train()
        b = self._to_device(padded)
        torch.manual_seed(seed)
        gen = torch.Generator().manual_seed(seed)
        named = list(self.model.named_parameters())
        for _, p in named:
            p.grad = None
        stats = [x.clone() for x in self.model.buffers()]
        em, elen = self._emissions(b, True, saug_on, gen)
        em = em.float()
        B, T, N = em.shape
        soft = np.zeros((B, T, N), np.float32)
        for r, e in enumerate(soft_rows):
            if e is not None:
                soft[r, : min(len(e), T)] = e[:T].astype(np.float32)
        q = torch.softmax(torch.from_numpy(soft).to(em.device), dim=-1)
        ce = -(q * F.log_softmax(em, dim=-1)).sum(-1)
        fmask = ((torch.arange(T, device=em.device)[None, :] < elen[:, None]).float()
                 * b["row_mask"][:, None])
        frames = self._global_count(fmask.sum()).clamp(min=1.0)
        loss = float(self.fl["slimIPL_soft_scale"]) * (ce * fmask).sum() / frames
        loss.backward()
        return self._apply_update(named, loss, stats, lr, None)

    def _run_soft_step(self, batch, seed: int):
        """Unsup update against the cached soft emissions (``use_soft``)."""
        sidx = np.asarray(batch["sample_idx"]).copy()
        n = 0
        for r, i in enumerate(sidx):
            if self.unsup_ds.samples[int(i)].sample_id in self.soft_cache:
                n += 1
            else:
                sidx[r] = -1
        if self._global_count(n) == 0:
            return False
        padded = pad_batch_rows(dict(batch, sample_idx=sidx), 1)
        rows = [None if i < 0 else self.soft_cache[self.unsup_ds.samples[int(i)].sample_id]
                for i in padded["sample_idx"]]
        cfg = self.cfg
        loss, finite = self.soft_step(
            padded, rows, self.net_sched(self.updates, self.epoch),
            0 <= cfg.saug_start_update <= self.updates, seed)
        self.updates += 1
        self._update_ema()
        if finite:
            self.meters_unsup.loss.add(loss, n)
        self.meters.speed.add_audio(float(np.sum(padded["audio_len"])) / cfg.samplerate)
        return True

    def _next_label_idx(self, n_batches: int) -> int:
        """Advance the shuffled labeling cursor (unsupBatchesIndices)."""
        if not self._label_order or self._label_cursor >= len(self._label_order):
            self._label_order = list(range(n_batches))
            self._rng.shuffle(self._label_order)
            self._label_cursor = 0
        i = self._label_order[self._label_cursor]
        self._label_cursor += 1
        return i

    def _unsup_update(self, seed, unsup_gen, unsup_specs, stats):
        typ = self.fl["slimIPL_type"]
        soft = bool(self.fl["slimIPL_use_soft"]) and typ == "fixed-pre-cache"
        if typ == "fixed-pre-cache":
            N = int(self.fl["slimIPL_fixed_cache_updates"])
            prob = float(self.fl["slimIPL_fixed_cache_update_prob"])
            relabel = len(self.fixed_cache) < N or self._rng.random() < prob
            new_idx = -1
            if relabel:
                new_idx = self._next_label_idx(len(unsup_specs))
                nb = self.unsup_ds.materialize(unsup_specs[new_idx])
                if soft:
                    pls, softs = self._generate_pls(nb, want_soft=True)
                    self._store_pls(pls, softs)
                else:
                    self._store_pls(self._generate_pls(nb))
            if len(self.fixed_cache) < N:
                if relabel:
                    self.fixed_cache.append(new_idx)
                stats["warmed"] += 1  # cache warming, no model update (:1297-1303)
                self.updates += 1  # the reference counts every batch (curBatch++)
                return
            if self._cache_hits >= len(self.fixed_cache):
                self._rng.shuffle(self.fixed_cache)  # a new pass (:1264-1280)
                self._cache_hits = 0
            serve = self.fixed_cache[self._cache_hits]
            if relabel:  # the served slot takes the new batch (:1291-1298)
                self.fixed_cache[self._cache_hits] = new_idx
            self._cache_hits += 1
            batch = self.unsup_ds.materialize(unsup_specs[serve])
            if soft:
                if self._run_soft_step(batch, seed):
                    stats["unsup"] += 1
                else:
                    stats["skipped_unsup"] += 1
                    self.updates += 1
                return
            labeled, n = self._relabel(batch, from_cache=True)
            if n == 0:
                stats["skipped_unsup"] += 1
                self.updates += 1
                return
            self._run_train_step(labeled, seed, sup=False)
            stats["unsup"] += 1
            return

        batch = next(unsup_gen)
        if typ == "naive":
            self._store_pls(self._generate_pls(batch))
            labeled, n = self._relabel(batch, from_cache=False)
            if n:
                self._run_train_step(labeled, seed, sup=False)
                stats["unsup"] += 1
            else:
                stats["skipped_unsup"] += 1
                self.updates += 1
            return

        # cache / pre-cache
        labeled, n = self._relabel(batch, from_cache=True)
        pre = None
        if typ == "pre-cache" or n == 0:
            pre = self._generate_pls(batch)  # the model of before the update (:1586-1590)
        if n:
            self._run_train_step(labeled, seed, sup=False)
            stats["unsup"] += 1
        else:
            stats["skipped_unsup"] += 1  # doUpdate=false (:1659-1662)
            self.updates += 1
        if pre:
            self._store_pls(pre)
        if typ == "cache" and n:
            # relabel with the model of after the update (:1833-1841)
            self._store_pls(self._generate_pls(batch))

    # -- main loop ---------------------------------------------------------------
    def run(self):
        cfg = self.cfg
        unsup_specs = self.unsup_ds.batch_specs()  # a stable order for the indices

        def cycle(ds):
            seed = cfg.seed
            while True:
                specs = ds.batch_specs(shuffle_seed=seed)
                for b in PrefetchIterator(ds, specs, num_threads=cfg.nthread):
                    yield b
                seed += 1

        sup_gen, unsup_gen = cycle(self.train_ds), cycle(self.unsup_ds)
        start = int(self.fl["slimIPL_start"])
        nsup = int(self.fl["slimIPL_sup_updates"])
        nunsup = int(self.fl["slimIPL_unsup_updates"])
        stats = {"sup": 0, "unsup": 0, "skipped_unsup": 0, "warmed": 0}
        window: List[bool] = []
        dyn_applied = False
        report = cfg.reportiters
        self.meters.runtime.start()
        while self.updates < cfg.iter:
            before = self.updates
            pl_phase = self.updates >= start
            if pl_phase and not dyn_applied:
                dyn_applied = True
                if float(self.fl["slimIPL_dyn_dropout"]) >= 0:
                    self._apply_dyn_dropout()
            if pl_phase:
                if not window:
                    # the shuffled sup/unsup interleave (setsOrder, :1216-1227)
                    window = [True] * nsup + [False] * nunsup
                    self._rng.shuffle(window)
                is_sup = window.pop(0)
            else:
                is_sup = True
            seed = self._step_seed(cfg.seed + 7)
            if is_sup:
                self._run_train_step(next(sup_gen), seed, sup=True)
                stats["sup"] += 1
            else:
                self._unsup_update(seed, unsup_gen, unsup_specs, stats)
            if report > 0 and self.updates != before and self.updates % report == 0:
                self._report_and_save()
                self._dump_cache()
                self._log_unsup()
        self._dump_cache()
        self.save()
        self._log_unsup()
        self._log(f"slimIPL done: {stats}")
        return stats

    def _log_unsup(self):
        if self.meters_unsup.loss.n or self.pl_quality.total:
            self._log(
                "slimIPL unsup: loss {:.5f} | TER {:.2f} | WER {:.2f} | "
                "PL-quality WER {:.2f} | cache {} | soft {} | fixed {}".format(
                    self.meters_unsup.loss.value(), self.meters_unsup.tkn_edit.error_rate(),
                    self.meters_unsup.wrd_edit.error_rate(), self.pl_quality.error_rate(),
                    len(self.cache), len(self.soft_cache), len(self.fixed_cache)))
        self.meters_unsup.reset()
