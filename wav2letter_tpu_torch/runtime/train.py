"""Training executor (the ``fl_asr_train`` binary) — the port of
``wav2letter_tpu/runtime/train.py`` for the CTC, ASG and seq2seq (GRU and
transformer decoder) criterions, on one device or on several ranks through
``torch.distributed``.

Structure as there: mode dispatch (train|continue|fork) with "stored flags <
explicitly passed flags", dictionaries, arch build, one optimizer each for the
network and the criterion, the hot loop with LR schedule, global-norm clipping,
the non-finite guard and the AMP loss scale, periodic validation (viterbi
TER/WER meters) and self-describing checkpoints.

One update, eagerly on ``device``: featurize (K1) -> SpecAugment -> model
forward (K2, K3, K4) in ``--compute_dtype`` with fp32 master parameters ->
the criterion on fp32 emissions -> backward (K2 as dgrad, K2b, K3b, K4b) ->
viterbi of the train batch for the meters (ASG's with the transitions of
before the update, as in JAX; the seq2seq criterions' greedy decode) -> clip
-> optimizer. The criterion's parameters (ASG's transitions, a seq2seq
decoder) take ``--critoptim``/``--lrcrit`` and count in the clip norm.
``--linseg`` is read by neither trainer (JAX's defines the flag only).

The seq2seq criterions read encoder states of the arch's own width (the arch
is not forced to the class count), and their attention window is on while
``updates < --pretrainWindow``, or always with ``--trainWithWindow``
(``_window_active``).

Everything random in an update (dropout, SpecAugment) is a function of
``(seed + 7, update index, data index)``, not of a running stream, and the data
order is a function of ``(seed, epoch)``; so ``continue`` replays exactly what
the uninterrupted run would have drawn. On the CPU that makes a resumed run
equal the uninterrupted one bit for bit. On a CUDA device PyTorch's CTC
backward adds with atomics, so two runs agree only to rounding.

Several ranks (``--enable_distributed``, or a process group the caller has
initialized) form a (data, model) mesh (``parallel/``). Each rank reads the
rows ``data_index::n_data`` of every global batch (``--batchsize`` is per
rank), the loss is the masked mean over the global batch (each rank's sum over
the all-reduced row count), and gradients are summed over the data axis
before the clip norm and the non-finite guard, so every rank takes the same
branch and the replicas stay bit-identical. With ``--mp_axis`` > 1 the big
weights are column-split over the model axis (tensor parallelism). Rank 0
alone writes logs, configs and checkpoints (gathered to full shape). A
BatchNorm's batch statistics are those of the global batch (summed over the
data axis inside autograd), so its running statistics move alike everywhere.

``--arch`` may name a plugin (``models/plugin.py``: a ``.py`` file or
``module:attr``; the JAX package's ``recipes/mls/mling_plugin.py`` maps to
``plugins/mling.py``). ``--features_device=host``, given explicitly on the
command line or in a flagsfile (the port's default featurizes on the card,
JAX's on the host), featurizes in the data threads (``HostFeaturizer``) and
ships the features; the update then starts at SpecAugment, and a
``continue`` keeps the choice. ``--remat`` recomputes the model's forward in
the backward (``torch.utils.checkpoint``), with the SpecAugment generator's
draws and the running statistics as the first forward had them.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..criterions import make_criterion
from ..data import AsrDataset, Lexicon, PrefetchIterator, make_token_dict
from ..data.batching import pad_batch_rows
from ..data.targets import tokens_to_words
from ..features import FeatureParams, Featurizer, HostFeaturizer
from ..features.specaug import SpecAugment
from ..kernels import disable_tf32
from ..models.arch import build_arch_module, output_width
from ..models.layers import statistics_frozen
from ..models.plugin import is_plugin, load_plugin_module
from ..optim import LRSchedule, make_optimizer
from ..parallel import MeshSpec, make_mesh, replicate, shard_batch, shard_params, to_host_local
from ..parallel.distributed import backend_for, init_distributed, local_rank
from ..parallel.mesh import set_current_mesh
from ..parallel.sharding import (all_reduce_grads, dataset_shard, gather_full, global_norm,
                                 model_sum)
from .checkpoint import (Checkpoint, find_last_checkpoint, load_checkpoint,
                         run_index_paths, save_checkpoint)
from .meters import TrainMeters, get_log_string, sync_meters
from .test import S2S_CRITERIONS, encoder_dim, path_tokens, resolve_device, target_tokens


def update_seed(base: int, update: int) -> int:
    """The seed of update ``update``'s draws from a run's ``base``: a function
    of the update index, not of a running stream, so ``continue`` replays them."""
    return base * 1_000_003 + update


def rank_seed(seed: int, data_index: int) -> int:
    """``seed`` for the rank at ``data_index`` of the data axis, so that each
    rank draws for its own rows; index 0 draws as one process does. The step
    is golden-ratio sized because the CPU generator keeps only a seed's low
    32 bits."""
    return seed + data_index * 0x9E3779B9


class Trainer:
    def __init__(self, cfg: Config, mode: str = "train", init_model_path: str = "",
                 device: str = "cuda"):
        self.mode = mode
        self.epoch = 0
        self.updates = 0
        self.run_idx = 1
        explicit = cfg.explicit_dict()

        # --- run dir & continue/fork resolution ---
        self.rundir = os.path.join(cfg.rundir, cfg.runname) if cfg.runname else cfg.rundir
        resume: Optional[Checkpoint] = None
        if mode == "continue":
            last = find_last_checkpoint(self.rundir)
            if not last:
                # starting afresh here would discard the stored run config and
                # train from scratch under the run's name
                raise FileNotFoundError(
                    f"continue: no checkpoint (model_last.bin) under {self.rundir!r}")
            resume = load_checkpoint(last)
            # precedence: stored flags < flags passed explicitly to this run;
            # process defaults never override what the run was started with
            merged = Config.deserialize(resume.config).asdict()
            merged.update(explicit)
            cfg = Config()
            cfg.update(merged)
            self.epoch = resume.epoch
            self.updates = resume.updates
            idxs = run_index_paths(self.rundir)
            self.run_idx = (idxs[-1] + 1) if idxs else 1
        elif mode == "fork":
            if not init_model_path:
                raise ValueError("fork needs the path of the model to start from")
            resume = load_checkpoint(init_model_path)
        elif mode != "train":
            raise ValueError(f"unknown mode {mode!r}: train, continue or fork")
        self.cfg = cfg
        self._resume = resume  # the checkpoint started from, for subclasses

        # the card featurizes unless the host was asked for by name (JAX's
        # default is the host); a continue keeps the run's choice
        self.host_features = (
            explicit["features_device"] == "host" if "features_device" in explicit
            else bool(resume is not None and mode == "continue"
                      and resume.extra.get("host_features")))

        # --- ranks: join the group, then one device a rank ---
        dev = torch.device(device)
        if cfg.enable_distributed:
            init_distributed(backend_for(dev), cfg.world_rank, cfg.world_size)
        if dev.type == "cuda" and dev.index is None and dist.is_initialized():
            dev = torch.device("cuda", local_rank())
        self.device = resolve_device(str(dev))
        if self.device.index is not None:  # the rank's card for its collectives
            torch.cuda.set_device(self.device)
        disable_tf32()
        self.mesh = make_mesh(MeshSpec.from_config(cfg), self.device)
        set_current_mesh(self.mesh)  # mesh-aware layers (the attention's head split)
        self.tensor_parallel = self.mesh.spec.n_model > 1
        if self.rundir and self.mesh.rank == 0:
            os.makedirs(self.rundir, exist_ok=True)

        # --- dictionaries ---
        tokens_path = os.path.join(cfg.tokensdir, cfg.tokens) if cfg.tokensdir else cfg.tokens
        self.token_dict = make_token_dict(
            tokens_path, cfg.criterion, cfg.replabel, cfg.eostoken)
        self.n_classes = len(self.token_dict)
        self.lexicon = Lexicon.from_file(cfg.lexicon, cfg.maxword) if cfg.lexicon else None

        # --- features ---
        self.featurizer = Featurizer(FeatureParams.from_config(cfg)).to(self.device)
        self.n_feat = cfg.num_features()
        self.specaug = None
        if cfg.saug_start_update >= 0:
            self.specaug = SpecAugment(
                n_freq_masks=cfg.saug_fmaskn, freq_mask_f=cfg.saug_fmaskf,
                n_time_masks=cfg.saug_tmaskn, time_mask_t=cfg.saug_tmaskt,
                time_mask_p=cfg.saug_tmaskp)

        # --- model + criterion ---
        self.is_s2s = cfg.criterion in S2S_CRITERIONS
        arch_path = os.path.join(cfg.archdir, cfg.arch) if cfg.archdir else cfg.arch
        out_dim = encoder_dim(cfg, self.n_classes)
        torch.manual_seed(cfg.seed)  # the model's, then the criterion's initial weights
        if is_plugin(arch_path):  # a plugin emits what it is asked for
            self.model = load_plugin_module(arch_path, self.n_feat, out_dim)
            enc_dim = out_dim if self.is_s2s else 0
        else:
            self.model = build_arch_module(arch_path, self.n_feat, out_dim,
                                           force_label_dim=not self.is_s2s)
            enc_dim = output_width(arch_path, self.n_feat, out_dim) if self.is_s2s else 0
        self.criterion = make_criterion(cfg, self.n_classes, enc_dim)
        if resume is not None:
            self.model.load_state_dict(resume.state_dict, strict=True)
            if resume.crit_state_dict:
                self.criterion.load_state_dict(resume.crit_state_dict, strict=True)
        self.model.to(self.device)
        self.criterion.to(self.device)
        # rank 0's weights everywhere; under tensor parallelism each rank then
        # keeps its columns of the big weights (the optimizer slots follow)
        self.sharded = shard_params(self.mesh, self.model, self.tensor_parallel)
        replicate(self.mesh, self.criterion)

        # --- optimizers (net + criterion) ---
        self.net_sched = LRSchedule.from_config(cfg, cfg.lr)
        self.crit_sched = LRSchedule.from_config(cfg, cfg.lrcrit or cfg.lr)
        self.net_opt = make_optimizer(
            self.model.named_parameters(), cfg.netoptim, cfg.momentum, cfg.weightdecay,
            cfg.adambeta1, cfg.adambeta2, cfg.optimepsilon, cfg.optimrho)
        self.net_opt.sharded = frozenset(self.sharded)
        self.net_opt.shard_sum = functools.partial(model_sum, mesh=self.mesh)
        self.crit_opt = make_optimizer(
            self.criterion.named_parameters(), cfg.critoptim, cfg.momentum, 0.0,
            cfg.adambeta1, cfg.adambeta2, cfg.optimepsilon, cfg.optimrho)
        # AMP dynamic loss scale (hardly needed with bf16 and fp32 master
        # parameters; kept for --fl_amp_use_mixed_precision)
        self.amp_scale = cfg.fl_amp_scale_factor if cfg.fl_amp_use_mixed_precision else 1.0
        self._amp_good = 0
        if mode == "continue" and self.tensor_parallel:
            # as in JAX: the stored slots are not resharded
            self._log("continue under tensor parallelism: the optimizer slots start afresh")
        elif mode == "continue":
            if resume.opt_state:
                self.net_opt.load_state_dict(resume.opt_state)
            if resume.crit_opt_state:
                self.crit_opt.load_state_dict(resume.crit_opt_state)
            if cfg.fl_amp_use_mixed_precision and "amp_scale" in resume.extra:
                self.amp_scale = float(resume.extra["amp_scale"])
                self._amp_good = int(resume.extra.get("amp_good", 0))

        # --- datasets ---
        # (the ranks of a model group read the rows of their data index)
        w_rank, w_size = dataset_shard(self.mesh)
        self.train_ds = AsrDataset(cfg.train, self.token_dict, self.lexicon, cfg,
                                   world_rank=w_rank, world_size=w_size)
        self.valid_ds: Dict[str, AsrDataset] = {}
        vbs = cfg.validbatchsize if cfg.validbatchsize > 0 else cfg.batchsize
        for tag, path in cfg.valid_sets():
            self.valid_ds[tag] = AsrDataset(
                path, self.token_dict, self.lexicon, cfg, batch_size=vbs,
                world_rank=w_rank, world_size=w_size)
        if self.host_features:
            hf = HostFeaturizer(FeatureParams.from_config(cfg), out_dtype=(
                torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32))
            for ds in [self.train_ds, *self.valid_ds.values()]:
                ds.set_host_featurizer(hf)

        self.meters = TrainMeters(list(self.valid_ds.keys()))
        self.best_val: Dict[str, float] = {}
        self.skipped = 0
        self.compute_dtype = (
            torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32)
        # synchronize the device at the phase boundaries of an update, so that
        # the fwd/crit-fwd/bwd/optim timers read device work and not its enqueue
        self.sync_timers = False

    # ------------------------------------------------------------------
    # one update
    # ------------------------------------------------------------------
    def _log(self, msg: str) -> None:
        if self.mesh.rank == 0:
            print(msg, flush=True)

    def _to_device(self, batch):
        return shard_batch(self.mesh, batch, self.device)

    def _timed(self, timer, name):
        return _Phase(timer, name, self.device if self.sync_timers else None)

    def _window_active(self) -> bool:
        """The seq2seq attention window's gate, per update: on while
        ``updates < --pretrainWindow``, or always with ``--trainWithWindow``
        (reference slimIPL/src/Train.cpp:1887-1903)."""
        cfg = self.cfg
        if not self.is_s2s or cfg.attnWindow in ("", "no"):
            return False
        return bool(cfg.trainWithWindow) or self.updates < cfg.pretrainWindow

    def _viterbi(self, em, elen):
        """(path, path lengths): the seq2seq criterions' greedy tokens, else
        the frame-level path (CTC's argmax, ASG's max-product)."""
        if self.is_s2s:
            return self.criterion.greedy_path(em, elen)
        return self.criterion.viterbi_path(em, elen), elen

    def _loss(self, b, train: bool, saug_on: bool = False,
              generator: Optional[torch.Generator] = None,
              rows: Optional[torch.Tensor] = None):
        """Masked mean of the per-sample losses, the fp32 emissions and their
        lengths; ``rows`` (default: the batch's) divides the masked sum."""
        em, elen = self._emissions(b, train, saug_on, generator)
        with self._timed(self.meters.crit_fwd_timer, "w2l/criterion"):
            kw = dict(train=train, window=self._window_active()) if self.is_s2s else {}
            losses = self.criterion(em, b["target"], elen, b["target_len"], **kw)
            rm = b["row_mask"]
            loss = (losses * rm).sum() / (rm.sum() if rows is None else rows).clamp(min=1.0)
        return loss, em, elen

    def _emissions(self, b, train: bool, saug_on: bool = False,
                   generator: Optional[torch.Generator] = None):
        """The fp32 emissions of a batch on the device and their lengths:
        features (or the host's), SpecAugment, the model. No dither: the JAX
        trainer passes no dither key either."""
        with self._timed(self.meters.fwd_timer, "w2l/forward"):
            with torch.no_grad():
                if "feats" in b:  # featurized in the data threads
                    feats, flen = b["feats"].float(), b["feat_len"]
                else:
                    feats, flen = self.featurizer(b["audio"], b["audio_len"])
                if self.specaug is not None and train and saug_on:
                    feats = self.specaug(feats, generator, flen)
                feats = feats.to(self.compute_dtype)
            if self.cfg.remat and train:
                em, elen = self._remat_forward(feats, flen, generator)
            else:
                em, elen = self.model(feats, flen, generator=generator)
            return em.float(), elen

    def _remat_forward(self, feats, flen, generator):
        """The model's forward, recomputed in the backward as ``jax.checkpoint``
        does. ``checkpoint`` restores the default generators (dropout, K4's
        seeds); the recompute here also replays the SpecAugment layers' draws
        from ``generator`` and leaves the running statistics alone."""
        start = None if generator is None else generator.get_state()

        @contextlib.contextmanager
        def recompute():
            after = None if generator is None else generator.get_state()
            if generator is not None:
                generator.set_state(start)
            try:
                with statistics_frozen():
                    yield
            finally:
                if generator is not None:
                    generator.set_state(after)

        return checkpoint(lambda f: self.model(f, flen, generator=generator), feats,
                          use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), recompute()))

    def train_step(self, batch, lr: float, lr_crit: float, saug_on: bool, seed: int):
        """One attempt at an update on a padded batch. Returns (loss, finite,
        viterbi path, path lengths), the loss that of the global batch. A
        non-finite loss or gradient zeroes the gradients, and the optimizers
        still step (momentum moves the params), as in the JAX step."""
        self.model.train()
        self.criterion.train()
        b = self._to_device(batch)
        torch.manual_seed(seed)  # dropout draws from the device's global generator
        gen = torch.Generator().manual_seed(seed)  # SpecAugment: flags, then SAUG layers
        named = list(self.model.named_parameters()) + [
            ("criterion." + n, p) for n, p in self.criterion.named_parameters()]
        for _, p in named:
            p.grad = None
        # the running statistics (BatchNorm) move in the forward; a non-finite
        # step keeps the old ones, as JAX keeps its model_state
        stats = [b.clone() for b in self.model.buffers()]
        rows = None
        if self.mesh.distributed:  # the global batch's real rows
            rows = self._global_count(b["row_mask"].sum())
        loss, em, elen = self._loss(b, True, saug_on, gen, rows)
        with self._timed(self.meters.bwd_timer, "w2l/backward"):
            (loss * self.amp_scale).backward()
        with torch.no_grad():  # before the update moves the criterion's params
            vit, vlen = self._viterbi(em, elen)
        loss_v, finite = self._apply_update(named, loss, stats, lr, lr_crit, self.amp_scale)
        return loss_v, finite, vit, vlen

    def _step_seed(self, base: int) -> int:
        """The draws' seed of this update on this rank: a function of the
        global update index, not a running stream, and of the data index, so
        each rank draws for its own rows (the ranks of a model group compute
        one replicated activation and must draw alike)."""
        return rank_seed(update_seed(base, self.updates), self.mesh.data_index)

    def _global_count(self, local) -> torch.Tensor:
        """``local`` (a count of this rank's rows or frames) summed over the
        data ranks: the divisor of a global batch's loss, and the count on
        which every rank takes the same branch."""
        n = torch.as_tensor(local, dtype=torch.float32, device=self.device).clone()
        if self.mesh.distributed:
            dist.all_reduce(n, group=self.mesh.data_group)
        return n

    def _apply_update(self, named, loss, stats, lr: float, lr_crit: Optional[float],
                      amp_scale: float = 1.0):
        """The end of an update, after the backward of ``loss * amp_scale``
        over the ``named`` parameters: unscale, sum the gradients and the loss
        over the ranks, clip by the global norm and step. A non-finite loss
        or gradient zeroes the gradients and puts back the buffers ``stats``;
        the optimizers still step (momentum moves the params), as in the JAX
        step. ``lr_crit`` None leaves the criterion's optimizer alone.
        Returns (the global batch's loss, finite)."""
        with self._timed(self.meters.optim_timer, "w2l/optimizer"):
            rep = [p.grad for n, p in named if p.grad is not None and n not in self.sharded]
            shard = [p.grad for n, p in named if p.grad is not None and n in self.sharded]
            if amp_scale != 1.0:
                torch._foreach_mul_(rep + shard, 1.0 / amp_scale)
            loss = loss.detach().reshape(1).clone()
            with record_function("w2l/all_reduce"):
                all_reduce_grads(self.mesh, rep + [loss], shard)
            # global norm over network and criterion, after the reduction; a
            # NaN or Inf anywhere in the gradients shows in it, so it also
            # serves the non-finite guard, and every rank takes one branch
            gn = global_norm(self.mesh, rep, shard)
            grads = rep + shard
            loss_v, gn_v = torch.stack([loss[0], gn]).tolist()
            finite = bool(np.isfinite(loss_v) and np.isfinite(gn_v))
            if not finite:
                torch._foreach_zero_(grads)
                for b, old in zip(self.model.buffers(), stats):
                    b.copy_(old)
            elif self.cfg.maxgradnorm > 0:
                scale = min(1.0, self.cfg.maxgradnorm / (gn_v + 1e-12))
                torch._foreach_mul_(grads, scale)
            self.net_opt.step(lr)
            if lr_crit is not None:
                self.crit_opt.step(lr_crit)
        return loss_v, finite

    @torch.no_grad()
    def eval_step(self, batch):
        self.model.eval()
        self.criterion.eval()
        loss, em, elen = self._loss(self._to_device(batch), False)
        return (float(loss),) + tuple(self._viterbi(em, elen))

    # ------------------------------------------------------------------
    # meters helpers
    # ------------------------------------------------------------------
    def _update_edit_meters(self, ds_meters, vit, elen, batch):
        vit, elen = to_host_local(self.mesh, vit), to_host_local(self.mesh, elen)
        tgts, tlens = np.asarray(batch["target"]), np.asarray(batch["target_len"])
        sidx = np.asarray(batch["sample_idx"])
        wsep = self.cfg.wordseparator
        for i in range(vit.shape[0]):
            if sidx[i] < 0:  # row padding
                continue
            hyp_toks = path_tokens(vit[i, : int(elen[i])], self.cfg, self.n_classes)
            ref_toks = target_tokens(tgts[i, : int(tlens[i])], self.cfg, self.n_classes)
            ds_meters.tkn_edit.add(ref_toks, hyp_toks)
            ref_w = tokens_to_words(
                self.token_dict.map_indices(ref_toks), wsep, self.cfg.usewordpiece)
            hyp_w = tokens_to_words(
                self.token_dict.map_indices(hyp_toks), wsep, self.cfg.usewordpiece)
            ds_meters.wrd_edit.add(ref_w, hyp_w)

    # ------------------------------------------------------------------
    # validation + checkpoint
    # ------------------------------------------------------------------
    def validate(self) -> Dict[str, float]:
        """Each rank meters its rows of every validation set; the counts are
        then summed over the data axis, so the WERs are those of the sets."""
        for tag, ds in self.valid_ds.items():
            m = self.meters.valid[tag]
            m.reset()
            it = PrefetchIterator(ds, ds.batch_specs(), num_threads=self.cfg.nthread)
            for batch in it:
                batch = pad_batch_rows(batch, 1)
                loss, vit, elen = self.eval_step(batch)
                m.loss.add(loss, int(batch["row_mask"].sum()))
                self._update_edit_meters(m, vit, elen, batch)
        sync_meters(self.meters, self.mesh, list(self.meters.valid.values()))
        return {tag: m.wrd_edit.error_rate() for tag, m in self.meters.valid.items()}

    def _full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` (a param or an optimizer slot of ``name``) at full shape:
        gathered over the model group where ``name`` is a column shard."""
        return gather_full(self.mesh, t) if name in self.sharded else t

    def _ckpt_extra(self) -> Dict:
        """Subclass hook: more state for the checkpoint's ``extra``."""
        return {}

    def save(self, tag: Optional[str] = None):
        """Collective under tensor parallelism (every rank gathers the
        shards); rank 0 writes, the others wait at a barrier."""
        if not self.rundir:
            return
        state = {n: self._full(n, t) for n, t in self.model.state_dict().items()}
        opt = self.net_opt.state_dict()
        if self.sharded:  # (novograd's 0-d nu is the whole array's already)
            opt["state"] = {slot: {n: (self._full(n, t) if t.dim() else t).cpu()
                                   for n, t in d.items()}
                            for slot, d in self.net_opt.state.items()}
        if self.mesh.rank == 0:
            ckpt = Checkpoint(
                config=self.cfg.serialize(), epoch=self.epoch, updates=self.updates,
                state_dict=state, crit_state_dict=self.criterion.state_dict(),
                opt_state=opt, crit_opt_state=self.crit_opt.state_dict(),
                extra={"amp_scale": self.amp_scale, "amp_good": self._amp_good,
                       "host_features": self.host_features, **self._ckpt_extra()})
            save_checkpoint(os.path.join(self.rundir, "model_last.bin"), ckpt)
            if tag:
                save_checkpoint(os.path.join(self.rundir, f"model_{tag}.bin"), ckpt)
        if self.mesh.distributed:
            dist.barrier()

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def run(self):
        cfg = self.cfg
        if self.rundir and self.mesh.rank == 0:
            with open(os.path.join(self.rundir, f"{self.run_idx:03d}_config"), "w") as f:
                f.write(cfg.serialize())
        report = cfg.reportiters
        self.meters.runtime.start()

        # Exact-replay resume: every batch takes exactly one update and an
        # epoch has a fixed number of batches, so the interrupted epoch and the
        # position in it follow from `updates`. Skip the consumed prefix of
        # that epoch's shuffle; the resumed run then sees the same remaining
        # data stream.
        steps_per_epoch = len(self.train_ds.batch_specs(shuffle_seed=cfg.seed + 1))
        mid_skip = 0
        if self.updates and steps_per_epoch:
            self.epoch = self.updates // steps_per_epoch  # the loop adds 1
            mid_skip = self.updates % steps_per_epoch

        while self.updates < cfg.iter:
            self.epoch += 1
            specs = self.train_ds.batch_specs(shuffle_seed=cfg.seed + self.epoch)
            if mid_skip:
                specs = specs[mid_skip:]
                mid_skip = 0
            it = PrefetchIterator(self.train_ds, specs, num_threads=cfg.nthread)
            for batch in it:
                if self.updates >= cfg.iter:
                    break
                self.meters.timer.start()
                lr = self.net_sched(self.updates, self.epoch)
                lr_crit = self.crit_sched(self.updates, self.epoch)
                seed = self._step_seed(cfg.seed + 7)
                saug_on = 0 <= cfg.saug_start_update <= self.updates
                batch = pad_batch_rows(batch, 1)
                n_rows = batch["audio_len"].shape[0]
                while True:
                    loss, finite, vit, elen = self.train_step(batch, lr, lr_crit, saug_on, seed)
                    if not cfg.fl_amp_use_mixed_precision:
                        if finite:
                            self.meters.train.loss.add(loss, n_rows)
                        else:
                            self.skipped += 1
                        break
                    # AMP overflow: halve the scale and retry the same batch;
                    # the failed attempt applied zeroed gradients and does not
                    # advance the update counter. Give up on the batch only at
                    # the scale floor of 1.
                    if finite:
                        self.meters.train.loss.add(loss, n_rows)
                        self._amp_good += 1
                        if self._amp_good % cfg.fl_amp_scale_factor_update_interval == 0:
                            self.amp_scale = min(
                                self.amp_scale * 2.0, cfg.fl_amp_max_scale_factor)
                        break
                    self._amp_good = 0
                    if self.amp_scale <= 1.0:
                        self.skipped += 1  # non-finite even unscaled: a bad batch
                        break
                    self.amp_scale = max(1.0, self.amp_scale / 2.0)
                self.updates += 1
                self.meters.speed.add_audio(float(np.sum(batch["audio_len"])) / cfg.samplerate)
                if np.random.rand() * 100.0 < cfg.pcttraineval:
                    self._update_edit_meters(self.meters.train, vit, elen, batch)
                self.meters.timer.stop()
                if report > 0 and self.updates % report == 0:
                    self._report_and_save()
            if report <= 0:
                self._report_and_save()
        self.save()
        self._log(f"training done: {self.updates} updates, {self.skipped} skipped batches")

    def _report_and_save(self):
        wers = self.validate()
        sync_meters(self.meters, self.mesh, [self.meters.train])
        line = get_log_string(
            self.meters, self.epoch, self.updates,
            self.net_sched(self.updates, self.epoch),
            self.crit_sched(self.updates, self.epoch))
        self._log(line)
        if self.rundir and self.mesh.rank == 0:
            with open(os.path.join(self.rundir, f"{self.run_idx:03d}_log"), "a") as f:
                f.write(line + "\n")
        self.save(tag=f"iter_{self.epoch:03d}")
        for tag, wer in wers.items():
            if wer <= self.best_val.get(tag, float("inf")):
                self.best_val[tag] = wer
                self.save(tag=tag)
        self.meters.reset_train()


class _Phase:
    """A named profiler range around one phase of an update that also runs the
    phase's timer; with a device, it synchronizes at both ends."""

    def __init__(self, timer, name: str, sync_device: Optional[torch.device]):
        self.timer, self.range, self.dev = timer, record_function(name), sync_device

    def _sync(self):
        if self.dev is not None and self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def __enter__(self):
        self._sync()
        self.range.__enter__()
        self.timer.start()

    def __exit__(self, *exc):
        self._sync()
        self.timer.stop()
        self.range.__exit__(*exc)
