"""One rank of the port's trainer for ``tests/test_torch_parallel.py``.

    python -m tests.util_torch_parallel RANK WORLD RENDEZVOUS JOBS.json

Joins a gloo group through a ``file://`` rendezvous (no port to race for),
then runs each job of the JSON list in turn: a ``Trainer`` (a
``SlimIPLTrainer`` where the job gives ``ipl`` flags, a ``CPCTrainer``
where it gives ``cpc`` flags, an ``LPMTrainer`` where it gives ``lpm``
flags, its proposals emptied where the job's ``lpm_blanks`` say) on the
CPU on the job's flags, in its mode, with the spies the job asks for (and JAX's
2^20-element split threshold lowered where the job names a
``min_shard_size``). What the test
compares goes to ``<job out>/rank<R>.pt``. Imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.nn.functional as F

from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.models.transformer import MultiHeadSelfAttention
from wav2letter_tpu_torch.parallel import sharding
from wav2letter_tpu_torch.runtime.train import Trainer
from wav2letter_tpu_torch.runtime.train_cpc import CPCTrainer
from wav2letter_tpu_torch.runtime.train_lpm import LPMTrainer
from wav2letter_tpu_torch.runtime.train_slimipl import SlimIPLTrainer


def _spy_attention(tr, calls):
    """Record (heads, seed) of every fused-attention call."""
    for mod in tr.model.modules():
        if isinstance(mod, MultiHeadSelfAttention):
            ops = mod.ops

            class _Ops:
                def __getattr__(self, name):
                    return getattr(ops, name)

                def mhsa(self, q, k, v, win, mask, heads, rate, seed):
                    calls.append((heads, seed))
                    return ops.mhsa(q, k, v, win, mask, heads, rate, seed)

            mod.ops = _Ops()


def _spy_dropout(masks):
    """Record the keep mask of every dropout in training: the mask of ones
    under the same generator state, which is then restored."""
    orig = F.dropout

    def dropout(x, p=0.5, training=True, inplace=False):
        if training and p > 0:
            state = torch.get_rng_state()
            masks.append(orig(torch.ones_like(x), p, True) != 0)
            torch.set_rng_state(state)
        return orig(x, p, training, inplace)

    F.dropout = dropout
    return orig


def spy_losses(tr, losses):
    """Record every loss the trainer meters, in order: ``("sup", v)`` and,
    for slimIPL, ``("unsup", v)``; a plain ``Trainer``'s as floats. An
    ``LPMTrainer`` meters none (as JAX's does not): its updates' losses,
    as floats."""
    if isinstance(tr, LPMTrainer):
        step = tr.train_step

        def train_step(*a, **kw):
            out = step(*a, **kw)
            losses.append(float(out[0]))
            return out
        tr.train_step = train_step
        return
    meters = [("sup", tr.meters.train)]
    if hasattr(tr, "meters_unsup"):
        meters.append(("unsup", tr.meters_unsup))
    for kind, m in meters:
        def add(v, n=1, kind=kind, orig=m.loss.add):
            losses.append((kind, float(v)) if len(meters) > 1 else float(v))
            orig(v, n)
        m.loss.add = add


def blank_lpm_proposals(tr, blanks):
    """Empty an ``LPMTrainer``'s proposals for the rows ``blanks[k]`` of the
    global batch of its k-th unpaired batch, as if its proposal model had no
    hypothesis there: the data rank r of w takes global row ``j * w + r`` as
    its row j (``data/batching.py``), so one process and every rank empty
    the same rows."""
    from wav2letter_tpu_torch.parallel.sharding import dataset_shard

    rank, world = dataset_shard(tr.mesh)
    propose, seen = tr._propose, []

    def _propose(batch):
        out = propose(batch)
        drop = set(blanks[len(seen)]) if len(seen) < len(blanks) else set()
        seen.append(len(seen))
        return [([], []) if j * world + rank in drop else p for j, p in enumerate(out)]

    tr._propose = _propose


def spy_cpc_losses(tr, losses):
    """Record every update's ``(phase, loss)`` of a ``CPCTrainer``."""
    unsup, sup = tr.unsup_step, tr.sup_step

    def unsup_step(*a, **kw):
        res = unsup(*a, **kw)
        losses.append(("unsup", res[0]))
        return res

    def sup_step(*a, **kw):
        res = sup(*a, **kw)
        losses.append(("sup", res[0]))
        return res

    tr.unsup_step, tr.sup_step = unsup_step, sup_step


def run_cpc_job(job, rank, cfg):
    tr = CPCTrainer(cfg, cpc_flags=job["cpc"], mode=job.get("mode", "train"), device="cpu")
    losses = []
    spy_cpc_losses(tr, losses)
    tr.run()
    torch.save({"losses": losses, "updates": tr.updates,
                "params": {k: v.detach().clone() for k, v in tr.net.state_dict().items()}},
               os.path.join(job["out"], f"rank{rank}.pt"))


def run_job(job, rank):
    if job.get("resume_from"):  # continue from an earlier checkpoint of another run
        run = os.path.join(job["flags"]["rundir"], job["flags"]["runname"])
        if rank == 0:
            os.makedirs(run, exist_ok=True)
            shutil.copy(job["resume_from"], os.path.join(run, "model_last.bin"))
        dist.barrier()
    if job.get("mode") == "continue":
        cfg = Config.from_sources(argv=[f"--{k}={v}" for k, v in job["flags"].items()])
    else:
        cfg = Config()
        cfg.update(job["flags"])
    if job.get("cpc") is not None:
        return run_cpc_job(job, rank, cfg)
    sharding.MIN_SHARD_SIZE = job.get("min_shard_size") or 2**20
    kw = dict(mode=job.get("mode", "train"), init_model_path=job.get("init", ""),
              device="cpu")
    if job.get("ipl"):
        tr = SlimIPLTrainer(cfg, ipl_flags=job["ipl"], **kw)
    elif job.get("lpm"):
        tr = LPMTrainer(cfg, lpm_flags=job["lpm"], **kw)
    else:
        tr = Trainer(cfg, **kw)
    if job.get("lpm_blanks"):
        blank_lpm_proposals(tr, job["lpm_blanks"])
    losses, attn, masks = [], [], []
    spy_losses(tr, losses)
    _spy_attention(tr, attn)
    orig = _spy_dropout(masks) if job.get("spy_dropout") else None
    try:
        stats = tr.run()
    finally:
        if orig is not None:
            F.dropout = orig
    torch.save({
        "losses": losses,
        "params": {k: v.detach().clone() for k, v in tr.model.state_dict().items()},
        "crit_params": {k: v.detach().clone() for k, v in tr.criterion.state_dict().items()},
        "sharded": sorted(tr.sharded),
        "valid": {t: m.tkn_edit.state() + m.wrd_edit.state() + m.loss.state()
                  for t, m in tr.meters.valid.items()},
        "attention": attn,
        "first_mask": masks[0] if masks else None,
        "updates": tr.updates,
        "lpm": dict(stats=stats, refreshed_at=tr.refreshed_at) if job.get("lpm") else None,
    }, os.path.join(job["out"], f"rank{rank}.pt"))


def main(argv):
    rank, world, rdv, jobs = int(argv[0]), int(argv[1]), argv[2], argv[3]
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        with open(jobs) as f:
            for job in json.load(f):
                os.makedirs(job["out"], exist_ok=True)
                run_job(job, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
