"""Training executor (the ``fl_asr_train`` binary) — the port of
``wav2letter_tpu/runtime/train.py`` for one device and the CTC criterion.

Structure as there: mode dispatch (train|continue|fork) with "stored flags <
explicitly passed flags", dictionaries, arch build, one optimizer each for the
network and the criterion, the hot loop with LR schedule, global-norm clipping,
the non-finite guard and the AMP loss scale, periodic validation (viterbi
TER/WER meters) and self-describing checkpoints.

One update, eagerly on ``device``: featurize (K1) -> SpecAugment -> model
forward (K2, K3) in ``--compute_dtype`` with fp32 master parameters -> CTC on
fp32 emissions -> backward (K2 as dgrad, K2b, K3b) -> clip -> optimizer ->
viterbi of the train batch for the meters.

Everything random in an update (dropout, SpecAugment) is a function of
``(seed + 7, update index)``, not of a running stream, and the data order is a
function of ``(seed, epoch)``; so ``continue`` replays exactly what the
uninterrupted run would have drawn. On the CPU that makes a resumed run equal
the uninterrupted one bit for bit. On a CUDA device PyTorch's CTC backward
adds with atomics, so two runs agree only to rounding.

Not in this slice (each raises, naming the slice it waits for): the ASG and
seq2seq criterions and the attention window, data and tensor parallelism,
``--features_device=host``, plugin archs, ``--remat``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config import Config
from ..criterions import make_criterion
from ..data import AsrDataset, Lexicon, PrefetchIterator, make_token_dict
from ..data.batching import pad_batch_rows
from ..data.targets import tokens_to_words
from ..features import FeatureParams, Featurizer
from ..features.specaug import SpecAugment
from ..kernels import disable_tf32
from ..models.arch import build_arch_module
from ..ops.ctc import ctc_collapse, ctc_viterbi
from ..optim import LRSchedule, make_optimizer
from .checkpoint import (Checkpoint, find_last_checkpoint, load_checkpoint,
                         run_index_paths, save_checkpoint)
from .meters import TrainMeters, get_log_string, sync_meters
from .test import resolve_device


def _log(msg: str) -> None:
    print(msg, flush=True)


def _not_yet(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the slices of the PyTorch port so far (one device, CTC); "
        f"it comes with {slice_name}")


class Trainer:
    def __init__(self, cfg: Config, mode: str = "train", init_model_path: str = "",
                 device: str = "cuda"):
        self.device = resolve_device(device)
        disable_tf32()
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

        if explicit.get("features_device") == "host":
            raise _not_yet("--features_device=host (featurizing in the data threads)",
                           "the host-featurizer slice")
        if cfg.remat:
            raise _not_yet("--remat", "the memory slice")
        if cfg.enable_distributed or cfg.world_size > 1 or cfg.mp_axis > 1 or cfg.dp_axis > 1:
            raise _not_yet("data or tensor parallelism (--enable_distributed, --world_size, "
                           "--dp_axis, --mp_axis)", "the data-parallel slice")
        if self.rundir:
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
        self.criterion = make_criterion(cfg, self.n_classes)
        arch_path = os.path.join(cfg.archdir, cfg.arch) if cfg.archdir else cfg.arch
        if arch_path.endswith(".py") or ":" in arch_path:
            raise _not_yet("a plugin arch", "the plugin slice")
        torch.manual_seed(cfg.seed)
        self.model = build_arch_module(arch_path, self.n_feat, self.n_classes)
        if resume is not None:
            self.model.load_state_dict(resume.state_dict, strict=True)
            if resume.crit_state_dict:
                self.criterion.load_state_dict(resume.crit_state_dict, strict=True)
        self.model.to(self.device)
        self.criterion.to(self.device)

        # --- optimizers (net + criterion) ---
        self.net_sched = LRSchedule.from_config(cfg, cfg.lr)
        self.crit_sched = LRSchedule.from_config(cfg, cfg.lrcrit or cfg.lr)
        self.net_opt = make_optimizer(
            self.model.named_parameters(), cfg.netoptim, cfg.momentum, cfg.weightdecay,
            cfg.adambeta1, cfg.adambeta2, cfg.optimepsilon, cfg.optimrho)
        self.crit_opt = make_optimizer(
            self.criterion.named_parameters(), cfg.critoptim, cfg.momentum, 0.0,
            cfg.adambeta1, cfg.adambeta2, cfg.optimepsilon, cfg.optimrho)
        # AMP dynamic loss scale (hardly needed with bf16 and fp32 master
        # parameters; kept for --fl_amp_use_mixed_precision)
        self.amp_scale = cfg.fl_amp_scale_factor if cfg.fl_amp_use_mixed_precision else 1.0
        self._amp_good = 0
        if mode == "continue":
            if resume.opt_state:
                self.net_opt.load_state_dict(resume.opt_state)
            if resume.crit_opt_state:
                self.crit_opt.load_state_dict(resume.crit_opt_state)
            if cfg.fl_amp_use_mixed_precision and "amp_scale" in resume.extra:
                self.amp_scale = float(resume.extra["amp_scale"])
                self._amp_good = int(resume.extra.get("amp_good", 0))

        # --- datasets ---
        self.train_ds = AsrDataset(cfg.train, self.token_dict, self.lexicon, cfg)
        self.valid_ds: Dict[str, AsrDataset] = {}
        vbs = cfg.validbatchsize if cfg.validbatchsize > 0 else cfg.batchsize
        for tag, path in cfg.valid_sets():
            self.valid_ds[tag] = AsrDataset(
                path, self.token_dict, self.lexicon, cfg, batch_size=vbs)

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
    def _to_device(self, batch):
        return {k: torch.from_numpy(np.asarray(batch[k])).to(self.device)
                for k in ("audio", "audio_len", "target", "target_len", "row_mask")}

    def _timed(self, timer, name):
        return _Phase(timer, name, self.device if self.sync_timers else None)

    def _loss(self, b, train: bool, saug_on: bool = False,
              generator: Optional[torch.Generator] = None):
        """Masked mean of the per-sample losses, the fp32 emissions and their
        lengths. No dither: the JAX trainer passes no dither key either."""
        with self._timed(self.meters.fwd_timer, "w2l/forward"):
            with torch.no_grad():
                feats, flen = self.featurizer(b["audio"], b["audio_len"])
                if self.specaug is not None and train and saug_on:
                    feats = self.specaug(feats, generator, flen)
                feats = feats.to(self.compute_dtype)
            em, elen = self.model(feats, flen, generator=generator)
            em = em.float()
        with self._timed(self.meters.crit_fwd_timer, "w2l/criterion"):
            losses = self.criterion(em, b["target"], elen, b["target_len"])
            rm = b["row_mask"]
            loss = (losses * rm).sum() / rm.sum().clamp(min=1.0)
        return loss, em, elen

    def train_step(self, batch, lr: float, lr_crit: float, saug_on: bool, seed: int):
        """One attempt at an update on a padded batch. Returns (loss, finite,
        viterbi path, path lengths). A non-finite loss or gradient zeroes the
        gradients, and the optimizers still step (momentum moves the params),
        as in the JAX step."""
        cfg = self.cfg
        self.model.train()
        self.criterion.train()
        b = self._to_device(batch)
        torch.manual_seed(seed)  # dropout draws from the device's global generator
        gen = torch.Generator().manual_seed(seed)  # SpecAugment: flags, then SAUG layers
        params = list(self.model.parameters()) + list(self.criterion.parameters())
        for p in params:
            p.grad = None
        loss, em, elen = self._loss(b, True, saug_on, gen)
        with self._timed(self.meters.bwd_timer, "w2l/backward"):
            (loss * self.amp_scale).backward()
        with self._timed(self.meters.optim_timer, "w2l/optimizer"):
            grads = [p.grad for p in params if p.grad is not None]
            if self.amp_scale != 1.0:
                torch._foreach_mul_(grads, 1.0 / self.amp_scale)
            # global norm over network and criterion; a NaN or Inf anywhere in
            # the gradients shows in it, so it also serves the non-finite guard
            gn = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm([g.float() for g in grads])))
            loss_v, gn_v = torch.stack([loss.detach(), gn]).tolist()
            finite = bool(np.isfinite(loss_v) and np.isfinite(gn_v))
            if not finite:
                torch._foreach_zero_(grads)
            elif cfg.maxgradnorm > 0:
                scale = min(1.0, cfg.maxgradnorm / (gn_v + 1e-12))
                torch._foreach_mul_(grads, scale)
            self.net_opt.step(lr)
            self.crit_opt.step(lr_crit)
        with torch.no_grad():
            vit = ctc_viterbi(em, elen)
        return loss_v, finite, vit, elen

    @torch.no_grad()
    def eval_step(self, batch):
        self.model.eval()
        self.criterion.eval()
        loss, em, elen = self._loss(self._to_device(batch), False)
        return float(loss), ctc_viterbi(em, elen), elen

    # ------------------------------------------------------------------
    # meters helpers
    # ------------------------------------------------------------------
    def _update_edit_meters(self, ds_meters, vit, elen, batch):
        vit, elen = vit.cpu().numpy(), elen.cpu().numpy()
        tgts, tlens = np.asarray(batch["target"]), np.asarray(batch["target_len"])
        sidx = np.asarray(batch["sample_idx"])
        wsep = self.cfg.wordseparator
        for i in range(vit.shape[0]):
            if sidx[i] < 0:  # row padding
                continue
            hyp_toks = ctc_collapse([vit[i, : int(elen[i])]], self.n_classes - 1)[0]
            ref_toks = [int(t) for t in tgts[i, : int(tlens[i])]]
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
        wers = {}
        for tag, ds in self.valid_ds.items():
            m = self.meters.valid[tag]
            m.reset()
            it = PrefetchIterator(ds, ds.batch_specs(), num_threads=self.cfg.nthread)
            for batch in it:
                batch = pad_batch_rows(batch, 1)
                loss, vit, elen = self.eval_step(batch)
                m.loss.add(loss, int(batch["row_mask"].sum()))
                self._update_edit_meters(m, vit, elen, batch)
            wers[tag] = m.wrd_edit.error_rate()
        return wers

    def save(self, tag: Optional[str] = None):
        if not self.rundir:
            return
        ckpt = Checkpoint(
            config=self.cfg.serialize(), epoch=self.epoch, updates=self.updates,
            state_dict=self.model.state_dict(),
            crit_state_dict=self.criterion.state_dict(),
            opt_state=self.net_opt.state_dict(),
            crit_opt_state=self.crit_opt.state_dict(),
            extra={"amp_scale": self.amp_scale, "amp_good": self._amp_good})
        save_checkpoint(os.path.join(self.rundir, "model_last.bin"), ckpt)
        if tag:
            save_checkpoint(os.path.join(self.rundir, f"model_{tag}.bin"), ckpt)

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def run(self):
        cfg = self.cfg
        if self.rundir:
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
                # a function of the global update index, not a running stream
                seed = (cfg.seed + 7) * 1_000_003 + self.updates
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
        _log(f"training done: {self.updates} updates, {self.skipped} skipped batches")

    def _report_and_save(self):
        wers = self.validate()
        sync_meters(self.meters)
        line = get_log_string(
            self.meters, self.epoch, self.updates,
            self.net_sched(self.updates, self.epoch),
            self.crit_sched(self.updates, self.epoch))
        _log(line)
        if self.rundir:
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
