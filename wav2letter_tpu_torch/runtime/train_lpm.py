"""Local Prior Match — semi-supervised seq2seq training on unpaired audio, the
port of ``wav2letter_tpu/runtime/train_lpm.py`` (reference
``recipes/local_prior_match/Train_lpm.cpp`` with ``src/runtime/DataScheduler``
and ``src/module/LMWrapper``).

A *proposal* model (a frozen copy of the network and the criterion,
refreshed every ``--propupdate`` updates, or loaded from ``--proposalModel``)
labels each unpaired batch; each hypothesis is weighted by its LM prior
(``--lm`` through ``decoder/lm.py``, normalized over the hypotheses), and the
model trains on the best. Paired and unpaired batches interleave through the
``DataScheduler`` (``--pairediter``/``--audioiter``; ``--trainaudio=false``
drops the unpaired stream).

As in JAX, the proposal is the greedy path of the proposal model alone (one
hypothesis of weight 1): ``--lpmBeamsz``, ``--hyplenratiolb`` and
``--hyplenratioub`` are read and not applied. The proposal's greedy decode runs
on the device through ``criterions/seq2seq.py``; the updates are the
``Trainer``'s, with SpecAugment off and draws from ``(--seed + 5, update)``
and the rank's data index. On several ranks a batch is skipped only where no
rank has a hypothesis in it.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data import AsrDataset
from ..data.batching import pad_batch_rows
from ..data.scheduler import DataScheduler
from ..decoder.lm import LM, KenLM, ZeroLM
from ..parallel.sharding import dataset_shard
from .checkpoint import load_checkpoint
from .test import S2S_CRITERIONS
from .train import Trainer

LPM_DEFAULTS = dict(
    lpmBeamsz=4,
    propupdate=500,
    pairediter=1,
    audioiter=1,
    hyplenratiolb=0.3,
    hyplenratioub=3.0,
    unpairedBatchsize=0,  # 0 = batchsize
    proposalModel="",  # init the frozen proposal from this checkpoint
    trainaudio=True,  # include the unpaired-audio LPM loss (Defines.h)
)


class LPMTrainer(Trainer):
    def __init__(self, cfg: Config, lpm_flags: Optional[Dict] = None,
                 unpaired_list: str = "", lm: Optional[LM] = None, **kw):
        if cfg.criterion not in S2S_CRITERIONS:
            raise ValueError("LPM trains a seq2seq criterion (seq2seq or transformer)")
        super().__init__(cfg, **kw)
        cfg = self.cfg
        # the proposal path featurizes raw audio itself
        self.host_features = False
        self.train_ds.set_host_featurizer(None)
        for ds in self.valid_ds.values():
            ds.set_host_featurizer(None)
        self.fl = dict(LPM_DEFAULTS)
        if lpm_flags:
            self.fl.update(lpm_flags)
        self.lm: LM = lm if lm is not None else (
            KenLM(cfg.lm, usr_vocab=self.token_dict.entries()) if cfg.lm else ZeroLM())
        w_rank, w_size = dataset_shard(self.mesh)
        self.unpaired_ds = AsrDataset(
            unpaired_list or cfg.train2, self.token_dict, self.lexicon, cfg,
            allow_empty_targets=True,
            batch_size=int(self.fl["unpairedBatchsize"]) or cfg.batchsize,
            world_rank=w_rank, world_size=w_size)
        self.proposal_model = copy.deepcopy(self.model).eval()
        self.proposal_crit = copy.deepcopy(self.criterion).eval()
        for p in [*self.proposal_model.parameters(), *self.proposal_crit.parameters()]:
            p.requires_grad_(False)
        if str(self.fl["proposalModel"]):
            prop = load_checkpoint(str(self.fl["proposalModel"]))
            self.proposal_model.load_state_dict(prop.state_dict, strict=True)
            self.proposal_crit.load_state_dict(prop.crit_state_dict, strict=True)
        self.refreshed_at = []  # the updates after which the proposal was refreshed

    @torch.no_grad()
    def _refresh_proposal(self):
        self.proposal_model.load_state_dict(self.model.state_dict())
        self.proposal_crit.load_state_dict(self.criterion.state_dict())

    @torch.no_grad()
    def _proposal_tokens(self, padded):
        """The proposal model's greedy tokens and their lengths, on the host."""
        b = self._to_device(padded)
        feats, flen = self.featurizer(b["audio"], b["audio_len"])
        em, elen = self.proposal_model(feats.to(self.compute_dtype), flen)
        toks, lens = self.proposal_crit.greedy_path(em.float(), elen)
        return toks.cpu().numpy(), lens.cpu().numpy()

    def _propose(self, batch):
        """Per row, (hypotheses, their LM-prior weights normalized over them);
        ([], []) for a padding row or an empty hypothesis."""
        pb = pad_batch_rows(batch, 1)
        toks, lens = self._proposal_tokens(pb)
        out = []
        for i in range(len(batch["sample_idx"])):
            if pb["sample_idx"][i] < 0:
                out.append(([], []))
                continue
            cands = [[int(t) for t in toks[i, : int(lens[i])]]]
            kept, weights = [], []
            for h in cands:
                if not h:
                    continue
                lp = 0.0
                st = self.lm.start(False)
                for t in h:
                    st, s = self.lm.score(st, t)
                    lp += s
                _, s = self.lm.finish(st)
                lp += s
                kept.append(h)
                weights.append(lp)
            if not kept:
                out.append(([], []))
                continue
            w = np.asarray(weights)
            w = np.exp(w - w.max())
            out.append((kept, (w / w.sum()).tolist()))
        return out

    def run(self):
        cfg = self.cfg
        audioiter = int(self.fl["audioiter"]) if bool(self.fl["trainaudio"]) else 0
        sched = DataScheduler([self.train_ds, self.unpaired_ds],
                              [int(self.fl["pairediter"]), audioiter],
                              num_threads=cfg.nthread, seed=cfg.seed)
        stats = {"paired": 0, "unpaired": 0, "skipped": 0}
        for ds_idx, batch in sched:
            if self.updates >= cfg.iter:
                break
            if ds_idx == 1:
                # unpaired: the proposal's hypothesis of the largest LM weight
                proposals = self._propose(batch)
                U = batch["target"].shape[1]
                tgt = np.full_like(batch["target"], -1)
                tlen = np.zeros_like(batch["target_len"])
                got = False
                for i, (hyps, weights) in enumerate(proposals):
                    if not hyps:
                        continue
                    h = hyps[int(np.argmax(weights))][:U]
                    tgt[i, : len(h)] = h
                    tlen[i] = len(h)
                    got = True
                if not self._global_count(got):  # every rank skips alike
                    stats["skipped"] += 1
                    continue
                batch = dict(batch, target=tgt, target_len=tlen)
                stats["unpaired"] += 1
            else:
                stats["paired"] += 1
            self.train_step(pad_batch_rows(batch, 1), self.net_sched(self.updates, self.epoch),
                            self.crit_sched(self.updates, self.epoch), False,
                            self._step_seed(cfg.seed + 5))
            self.updates += 1
            if self.updates % int(self.fl["propupdate"]) == 0:
                self._refresh_proposal()
                self.refreshed_at.append(self.updates)
                self._log(f"LPM: refreshed proposal model at update {self.updates}")
        self.save()
        return stats
