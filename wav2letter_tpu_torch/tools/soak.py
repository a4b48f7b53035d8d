"""Convergence soak of the PyTorch port: the top-level ``tools/soak.py``
ported, phase for phase, onto ``wav2letter_tpu_torch``'s modules and CLIs.

It trains the streaming-convnets flagship (TDS+CTC) on the 20 h synthetic
homophone corpus (``tools/synth_corpus.py``) under the JAX soak's regime
(SGD at lr 0.2, warm-up, clipping, epoch halving by ``--lr_decay``,
checkpoint rotation, a SIGKILL of the run a third of the way and a bare
``continue``), then runs the product chain on the trained model through the
port's CLIs:

  viterbi ``test``  ->  lexicon beam (no LM)  ->  beam + 3-gram LM
  ->  ``--lmweight`` sweep  ->  beam dump + rescoring / oracle
  ->  ``convert_streaming``  ->  the chunked stream

    python -m wav2letter_tpu_torch.tools.soak [--phase all|corpus,lm,b128,...]
        [--root _local/soak_torch] [--device cuda|cpu] [--iters_b128 N]
        [--iters_b32 N] [--fast]

Phases: ``corpus``, ``lm``, ``b128``, ``profile`` (one steady B = 128 update
on the card: wall, device busy, idle share, peak memory), ``product``,
``b32`` and ``report``; ``all`` runs them in that order. Each phase is
resumable and skipped when its marker ``<root>/.done_<phase>`` exists, so a
run may span several processes. Results accumulate in ``<root>/RESULTS.json``
(``report`` adds ``SUMMARY.md``). The CLIs take the soak's ``--device``
(default ``cuda``; without a card they raise, nothing falls back to the CPU).
``--fast`` keeps the JAX soak's tiny streamable arch and sizes (a smoke run,
e.g. ``--fast --device=cpu``).

Three deliberate differences from the JAX soak:

* **The arch.** The JAX soak reads the reference checkout's
  ``am_500ms_future_context.arch``, which this repository does not hold. The
  port's soak trains ``recipes/streaming_convnets/network.arch`` (the
  flagship of ``bench.py`` and of the port's ``chip_smoke.py``) minus its
  ``SAUG`` line, as the JAX soak drops ``SAUG``. So ``SOAK_RESULTS.json`` is
  a reference for correctness, not a bar on the same network.
* **No compile cache.** The JAX soak points XLA at a persistent compile
  cache; the port compiles its kernels once, into ``build/``.
* **One process for the chain.** Training runs as a ``python -m
  wav2letter_tpu_torch.cli.train`` child, which the kill needs. The chain's
  ``test``, ``decode`` and ``convert_streaming`` run through the same
  ``main`` that ``python -m wav2letter_tpu_torch.cli.<name>`` calls, in the
  soak's process (their output captured), where the JAX soak spawns each:
  the CUDA context and the kernels are set up once, not once a step.

Two measurements the JAX soak lacks, reported and not gated:

* **The stream against offline, split by cause** (``_streaming_eval``), on
  the streamed test utterances: (a) the stream (streamed features and
  emissions into the online native beam); (b) the same beam, chunk for
  chunk, fed the batch featurizer's and network's emissions (fp32, as the
  stream) cut at the stream's chunk boundaries; (c) the offline
  ``cli.decode`` of the subset (the checkpoint's compute type), and beside
  it the same beam fed (b)'s emissions whole. (a) against (b) is the
  featurizer; (b) against the whole decode the chunk-wise pruning. Also the
  largest distance between streamed and batch emissions, and the number of
  utterances whose words differ in each pair.
* **The top-k decode against the full-row decode** (``_topk_vs_full``): the
  test set decoded at ``--beamsizetoken=8``, shipped as top k and from full
  rows (``--emission_dir``); both WERs, the utterances whose words differ,
  and the frames tied at the k-th value or whose top k leaves out the blank
  or the separator.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PY = sys.executable
ARCH = os.path.join(REPO, "recipes", "streaming_convnets", "network.arch")

# JAX's tiny but streamable, multi-stage arch of ``--fast``: two chained
# future-context PD/C2 subsampling stages and asymmetric TDS blocks
FAST_ARCH = (
    "V -1 NFEAT 1 0\nPD 0 3 2\nC2 1 8 6 1 2 1 0 0\nR\n"
    "LN 1 2\nTDS 8 5 NFEAT 0.0 0 1 0\n"
    "PD 0 4 1\nC2 8 12 6 1 2 1 0 0\nR\n"
    "LN 1 2\nTDS 12 5 NFEAT 0.0 0 1 0\n"
    "TDS 12 5 NFEAT 0.0 0 0 0\n"
    "RO 2 1 0 3\nV 480 -1 1 0\nL 480 NLABEL\nV NLABEL 0 -1 1\n"
)

# n_succ=48 / n_words=2000 starve the AM of (predecessor, homophone) bigram
# coverage (~0.6 audio occurrences per bigram) while the 200k-sentence LM
# corpus covers each ~20x: the LM must earn its weight structurally
CORPUS_KW = dict(train_hours=20.0, dev_minutes=30.0, test_minutes=30.0, n_words=2000,
                 n_homophone_pairs=100, lm_sentences=200000, n_succ=48)
FAST_CORPUS_KW = dict(train_hours=0.25, dev_minutes=2.0, test_minutes=2.0, n_words=150,
                      n_homophone_pairs=15, lm_sentences=2000)

# the product chain's sizes: the dev sweep (lmweight low, high, step) at each
# wordscore, the homophone slice and its sweep, the streamed utterances
SIZES = dict(sweep=(0.0, 2.0, 0.25), wordscores=(0.0, 0.5, 1.0), homo_utts=150,
             homo_sweep=(0.0, 3.0, 0.5), stream_utts=100)
FAST_SIZES = dict(SIZES, homo_utts=20, stream_utts=8)
TOPK = 8  # --beamsizetoken of the top-k against full-row decode (22 classes)
CHUNK = 8000  # samples of a stream chunk: 500 ms at 16 kHz
# The kernel model's loss (relative error) and gradient (L2 error relative
# to the plain gradient's norm) against the plain-version model on the same
# features, modules in eval mode; also chip_smoke.py's first-batch check,
# per parameter there. A seeded, untrained model amplifies fp32 rounding
# ~1e4-fold on the way back (two plain-version runs that differ only in the
# conv's summation order differ by 2e-3 in the first blocks' weights), hence
# 1e-2 in fp32.
GRAD_TOL = {"float32": (1e-5, 1e-2), "bfloat16": (2e-2, 0.25)}
# results whose keys are the points of a grid, which differ between runs
GRID_KEYS = {"lmweight_sweep_dev", "homophone_slice_sweep"}


def log(msg):
    print(f"[soak +{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def missing_keys(want: dict, got: dict, path: str = "") -> List[str]:
    """Keys of ``want`` (the JAX soak's results) that ``got`` lacks,
    recursively through dicts and the first row of lists of dicts; the
    ``GRID_KEYS`` dicts only need to be present."""
    out = []
    for k, v in want.items():
        if k not in got:
            out.append(path + k)
        elif k in GRID_KEYS:
            continue
        elif isinstance(v, dict) and isinstance(got[k], dict):
            out += missing_keys(v, got[k], f"{path}{k}.")
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            if not got[k]:
                out.append(f"{path}{k}[0]")
            else:
                out += missing_keys(v[0], got[k][0], f"{path}{k}[0].")
    return out


class Soak:
    """The soak's state under ``root``."""

    def __init__(self, root: str, fast: bool = False, iters_b128: Optional[int] = None,
                 iters_b32: Optional[int] = None, device: str = "cuda",
                 corpus: Optional[str] = None, corpus_kw: Optional[dict] = None,
                 sizes: Optional[dict] = None):
        self.root = os.path.abspath(root)
        self.fast = fast
        self.iters_b128 = iters_b128 or (800 if fast else 5000)
        self.iters_b32 = iters_b32 or (400 if fast else 20000)
        self.device = device
        self.corpus = os.path.abspath(corpus or os.path.join(
            REPO, "_local", "corpora", "soak_fast" if fast else "soak20h"))
        self.corpus_kw = corpus_kw or (FAST_CORPUS_KW if fast else CORPUS_KW)
        self.sizes = dict(FAST_SIZES if fast else SIZES, **(sizes or {}))
        os.makedirs(self.root, exist_ok=True)
        self.results_path = os.path.join(self.root, "RESULTS.json")
        self.results: dict = {}
        if os.path.exists(self.results_path):
            with open(self.results_path) as f:
                self.results = json.load(f)

    def save(self):
        with open(self.results_path, "w") as f:
            json.dump(self.results, f, indent=1)

    def done(self, phase):
        return os.path.exists(os.path.join(self.root, f".done_{phase}"))

    def mark(self, phase):
        with open(os.path.join(self.root, f".done_{phase}"), "w") as f:
            f.write(str(time.time()))
        self.save()

    def timed(self, step: str, t0: float):
        """Record ``step``'s wall seconds since ``t0`` under ``timing``."""
        self.results.setdefault("timing", {})[step] = round(time.time() - t0, 2)
        log(f"{step}: {time.time() - t0:.1f} s")

    # ------------------------------------------------------------------
    def phase_corpus(self):
        if self.done("corpus"):
            return
        from .synth_corpus import generate

        t0 = time.time()
        log(f"corpus: generating under {self.corpus} ({self.corpus_kw})")
        self.paths = generate(self.corpus, **self.corpus_kw)
        with open(self.paths["meta"]) as f:
            meta = json.load(f)
        self.results["corpus"] = {k: meta[k] for k in
                                  ("train_hours", "vocab_size", "n_pairs")}
        self.results["corpus"]["train_utts"] = self.n_train_utts
        self.timed("corpus", t0)
        self.mark("corpus")

    @property
    def paths(self):
        if not hasattr(self, "_paths"):
            self._paths = {
                k: os.path.join(self.corpus, v) for k, v in [
                    ("train", "train.lst"), ("dev", "dev.lst"),
                    ("test", "test.lst"), ("tokens", "tokens.txt"),
                    ("lexicon", "lexicon.txt"), ("lm_corpus", "lm_corpus.txt"),
                    ("meta", "meta.json")]
            }
        return self._paths

    @paths.setter
    def paths(self, v):
        self._paths = v

    # ------------------------------------------------------------------
    def phase_lm(self):
        if self.done("lm"):
            return
        from .ngram_lm import build_binary, train_ngram_lm

        arpa = os.path.join(self.root, "lm3.arpa")
        log("lm: training 3-gram Kneser-Ney on lm_corpus.txt")
        t0 = time.time()
        train_ngram_lm(self.paths["lm_corpus"], arpa, order=3)
        log(f"lm: arpa in {time.time() - t0:.0f}s -> binary")
        lm_bin = build_binary(arpa, os.path.join(self.root, "lm3.bin"))
        self.results["lm"] = {
            "arpa_mb": round(os.path.getsize(arpa) / 1e6, 2),
            "bin_mb": round(os.path.getsize(lm_bin) / 1e6, 2),
            "train_s": round(time.time() - t0, 1),
        }
        self.mark("lm")

    # ------------------------------------------------------------------
    def arch_path(self) -> str:
        """The flagship's arch minus its ``SAUG`` line (SpecAugment's
        2x100-frame time masks delete ~30% of the letters of a synthetic tone
        utterance: label noise on this corpus), or ``--fast``'s arch."""
        if self.fast:
            arch = os.path.join(self.root, "fast.arch")
            with open(arch, "w") as f:
                f.write(FAST_ARCH)
            return arch
        arch = os.path.join(self.root, "flagship_nosaug.arch")
        with open(ARCH) as f, open(arch, "w") as g:
            g.writelines(line for line in f if not line.startswith("SAUG"))
        return arch

    def _train_flags(self, runname, batch, lr, iters, report,
                     lr_decay=0, lr_decay_step=1000000):
        flags = [
            f"--train={self.paths['train']}",
            f"--valid=dev:{self.paths['dev']}",
            f"--tokens={self.paths['tokens']}",
            f"--lexicon={self.paths['lexicon']}",
            f"--rundir={self.root}", f"--runname={runname}",
            f"--arch={self.arch_path()}",
            "--criterion=ctc", "--mfsc=true", "--filterbanks=80",
            f"--batchsize={batch}", f"--lr={lr}", "--momentum=0.0",
            "--netoptim=sgd", "--maxgradnorm=0.5", "--onorm=target",
            "--sqnorm=true", "--nthread=4",
            f"--iter={iters}", f"--reportiters={report}",
            "--warmup=300", "--pcttraineval=1",
            # epoch-based halving for the final stretch of the run (the
            # reference's --lr_decay regime); thresholds are per regime
            f"--lr_decay={lr_decay}", f"--lr_decay_step={lr_decay_step}",
            "--compute_dtype=bfloat16", "--seed=11",
            "--pad_multiple=256",
        ]
        if self.fast:
            flags += ["--filterbanks=40", "--warmup=10", "--lr_decay=0",
                      "--compute_dtype=float32", "--pad_multiple=64"]
        return flags

    def _env(self):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        return env

    def _spawn_train(self, mode_args, logf):
        with open(logf, "ab") as out:
            return subprocess.Popen(
                [PY, "-m", "wav2letter_tpu_torch.cli.train", *mode_args,
                 f"--device={self.device}"],
                stdout=out, stderr=subprocess.STDOUT, cwd=REPO, env=self._env(),
                start_new_session=True)

    @staticmethod
    def _last_update(rundir_log):
        """The biggest ``nupdates:`` seen across run logs."""
        best = 0
        for p in rundir_log:
            if not os.path.exists(p):
                continue
            with open(p, errors="replace") as f:
                for line in f:
                    m = re.search(r"nupdates:\s*(\d+)", line)
                    if m:
                        best = max(best, int(m.group(1)))
        return best

    def _train_regime(self, name, batch, lr, iters, report, kill_at=None,
                      lr_decay=0, lr_decay_step=1000000):
        if self.done(f"train_{name}"):
            return
        from ..runtime.checkpoint import load_checkpoint

        rundir = os.path.join(self.root, name)
        logf = os.path.join(self.root, f"{name}.console")
        flags = self._train_flags(name, batch, lr, iters, report,
                                  lr_decay, lr_decay_step)
        t0 = time.time()
        killed, resumed_from, stamps = False, None, {1: [], 2: []}
        log1 = os.path.join(rundir, "001_log")
        if kill_at:
            log(f"train[{name}]: start (will SIGKILL at ~{kill_at} updates "
                "and resume with `continue`)")
            ckpt = os.path.join(rundir, "model_last.bin")

            def ready(u):
                # kill only once the checkpoint of a report at or past
                # kill_at is whole: the report's log line is written first,
                # then model_last.bin is renamed into place
                return (u >= kill_at and os.path.exists(ckpt)
                        and os.path.getmtime(ckpt) >= os.path.getmtime(log1))

            p = self._spawn_train(["train", *flags], logf)
            killed = self._wait(p, log1, stamps[1], ready)
            if not killed and p.returncode != 0:
                raise RuntimeError(f"train[{name}] died before kill point; "
                                   f"see {logf}")
            resumed_from = load_checkpoint(ckpt).updates
            log(f"train[{name}]: {'SIGKILLed' if killed else 'ended'} at "
                f"{self._last_update([log1])} logged updates; continue from "
                f"checkpoint update {resumed_from}")
            # resume: bare continue — stored flags must carry everything
            p = self._spawn_train(
                ["continue", f"--rundir={self.root}", f"--runname={name}"], logf)
            self._wait(p, os.path.join(rundir, "002_log"), stamps[2])
            if p.returncode != 0:
                raise RuntimeError(f"train[{name}] continue failed; see {logf}")
        else:
            log(f"train[{name}]: start")
            p = self._spawn_train(["train", *flags], logf)
            self._wait(p, log1, stamps[1])
            if p.returncode != 0:
                raise RuntimeError(f"train[{name}] failed; see {logf}")
        wall = time.time() - t0
        traj = self._trajectory(rundir)
        ckpts = sorted(f for f in os.listdir(rundir)
                       if f.startswith("model_") and f.endswith(".bin"))
        res = {
            "batch": batch, "lr": lr, "iters": iters,
            "wall_s": round(wall, 1), "killed_and_resumed": killed,
            "checkpoints": len(ckpts),
            "trajectory": traj,
            "final_dev_wer": traj[-1]["dev_wer"] if traj else None,
            "runs": [_rate(i, st) for i, st in stamps.items() if len(st) >= 2],
        }
        if kill_at:
            first = next((r["updates"] for r in traj if r["run"] == 2), None)
            res.update(killed_at_update=max([r["updates"] for r in traj if r["run"] == 1],
                                            default=0),
                       resumed_from_update=resumed_from, first_resumed_update=first)
            if first is not None and first <= resumed_from:
                raise RuntimeError(f"train[{name}]: continue logged update {first}, "
                                   f"not above its checkpoint's {resumed_from}")
        self.results[f"train_{name}"] = res
        self.mark(f"train_{name}")

    @staticmethod
    def _trajectory(rundir):
        rows = []
        for i in (1, 2, 3):
            p = os.path.join(rundir, f"{i:03d}_log")
            if not os.path.exists(p):
                continue
            with open(p, errors="replace") as f:
                for line in f:
                    mu = re.search(r"nupdates:\s*(\d+)", line)
                    ml = re.search(r"loss:\s*([0-9.]+)", line)
                    mw = re.search(r"dev-WER:\s*([0-9.]+)", line)
                    mlr = re.search(r"lr:\s*([0-9.]+)", line)
                    if mu and ml:
                        rows.append({
                            "updates": int(mu.group(1)),
                            "loss": float(ml.group(1)),
                            "lr": float(mlr.group(1)) if mlr else None,
                            "dev_wer": float(mw.group(1)) if mw else None,
                            "run": i,
                        })
        return rows

    def _wait(self, p, logp, stamps, stop=None) -> bool:
        """Wait for the training child ``p``, stamping each new report line
        of its log ``logp`` with the wall clock (``stamps``: (update, time));
        SIGKILL its process group, and return True, once ``stop(update)``."""
        seen = 0
        while p.poll() is None:
            time.sleep(0.25)
            u = self._last_update([logp])
            if u > seen:
                stamps.append((u, time.time()))
                seen = u
            if stop is not None and stop(u):
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
                return True
        u = self._last_update([logp])
        if u > seen:
            stamps.append((u, time.time()))
        return False

    @property
    def n_train_utts(self):
        """Train-set size, counted from the list file (the epoch/lr_decay
        math must track the generated corpus, not a hardcoded count)."""
        if not hasattr(self, "_n_train"):
            with open(self.paths["train"]) as f:
                self._n_train = sum(1 for _ in f)
        return self._n_train

    def phase_b128(self):
        b, iters = (8 if self.fast else 128), self.iters_b128
        # lr 0.2 (~n_train/128 updates an epoch): halving engages for the
        # final ~40% of the run (3 halvings by the end)
        ep = max(1, iters * b // self.n_train_utts)
        self._train_regime("b128", b, 0.2 if not self.fast else 0.4,
                           iters, max(1, iters // (8 if self.fast else 12)),
                           kill_at=max(1, iters // 3),
                           lr_decay=max(1, int(ep * 0.58)),
                           lr_decay_step=max(1, int(ep * 0.16)))

    def phase_b32(self):
        b, iters = (4 if self.fast else 32), self.iters_b32
        # linear batch-size LR scaling from the B=128 regime
        ep = max(1, iters * b // self.n_train_utts)
        self._train_regime("b32", b, 0.05 if not self.fast else 0.4,
                           iters, max(1, iters // (4 if self.fast else 12)),
                           lr_decay=max(1, int(ep * 0.58)),
                           lr_decay_step=max(1, int(ep * 0.16)))

    # ------------------------------------------------------------------
    def phase_profile(self, name="b128", steady=5):
        """The regime ``name``'s updates on the card, in this process, from
        its last checkpoint, at the train set's largest and median batches (by padded frames x rows):
        after two warm-up updates at lr 0, the wall ms of a steady update
        (device drained), its device busy ms (profiler), idle share and peak
        memory, and the host's ms to read and pad the batch. At the largest
        batch also the launches of one update, and the kernels against their
        plain versions in bf16 and fp32: K1's features against the plain
        featurizer's, and the loss and gradients of the kernel model against
        the plain-version model on K1's features (modules in eval mode), held
        to ``GRAD_TOL``. Skipped on the CPU."""
        if self.done(f"profile_{name}") or not self.device.startswith("cuda"):
            return
        import numpy as np
        import torch
        from torch.profiler import ProfilerActivity, profile

        from .. import kernels
        from ..config import Config
        from ..data.batching import pad_batch_rows
        from ..runtime.train import Trainer

        t_phase = time.time()
        # the trained run as `continue` loads it; nothing is written
        tr = Trainer(Config().update({"rundir": self.root, "runname": name}),
                     mode="continue", device=self.device)
        specs = tr.train_ds.batch_specs()
        sizes = np.asarray([s.max_input_frames * len(s.indices) for s in specs])
        picks = {"largest": int(np.argmax(sizes)),
                 "median": int(np.argsort(sizes)[len(sizes) // 2])}
        out = {}
        for tag, i in picks.items():
            t0 = time.perf_counter()
            batch = pad_batch_rows(tr.train_ds.materialize(specs[i]), 1)
            read_ms = 1e3 * (time.perf_counter() - t0)
            args = (batch, 0.0, 0.0, False, 12345)
            torch.cuda.reset_peak_memory_stats()
            for _ in range(2):
                tr.train_step(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steady):
                tr.train_step(*args)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / steady
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tr.train_step(*args)
                torch.cuda.synchronize()
            busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            out[tag] = {"batch": list(batch["audio"].shape),
                        "frames": specs[i].max_input_frames, "read_ms": read_ms,
                        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                        "idle_share": 1.0 - busy_ms / wall_ms,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            log(f"profile[{name}] {tag}: {json.dumps(out[tag])}")
            if tag == "largest":
                kernels.reset_launches()
                tr.train_step(*args)
                torch.cuda.synchronize()
                out["launches_per_update"] = dict(kernels.LAUNCHES)
                out["kernels_vs_plain"] = self._kernels_vs_plain(tr, batch)
                log(f"profile[{name}] launches {json.dumps(out['launches_per_update'])}, "
                    f"against the plain versions {json.dumps(out['kernels_vs_plain'])}")
        del tr
        torch.cuda.empty_cache()
        self.results.setdefault(f"train_{name}", {})["profile"] = out
        self.timed(f"profile_{name}", t_phase)
        self.mark(f"profile_{name}")

    @staticmethod
    def _kernels_vs_plain(tr, batch):
        """See :meth:`phase_profile`; raises past ``GRAD_TOL``."""
        import torch

        from .. import kernels
        from ..features import FeatureParams, Featurizer
        from ..models.arch import build_arch_module

        b = tr._to_device(batch)
        arch = os.path.join(tr.cfg.archdir, tr.cfg.arch) if tr.cfg.archdir else tr.cfg.arch
        plain = build_arch_module(arch, tr.n_feat, tr.n_classes, ops=kernels.PLAIN)
        plain.load_state_dict(tr.model.state_dict())
        plain.to(tr.device)
        model, featurizer, dtype = tr.model, tr.featurizer, tr.compute_dtype
        with torch.no_grad():
            feats = featurizer(b["audio"], b["audio_len"])
            plain_feats = Featurizer(FeatureParams.from_config(tr.cfg), ops=kernels.PLAIN).to(
                tr.device)(b["audio"], b["audio_len"])
        res = {"features_max_abs": (feats[0] - plain_feats[0]).abs().max().item()}
        try:
            for dt, (loss_tol, grad_tol) in GRAD_TOL.items():
                tr.compute_dtype = getattr(torch, dt)
                got = {}
                for side, m in (("kernel", model), ("plain", plain)):
                    tr.model, tr.featurizer = m, (lambda audio, audio_len: feats)
                    m.eval()
                    for p in m.parameters():
                        p.grad = None
                    loss, _, _ = tr._loss(b, train=False)
                    loss.backward()
                    got[side] = (loss.item(), torch.cat([p.grad.float().flatten()
                                                         for p in m.parameters()]))
                (kl, kg), (pl, pg) = got["kernel"], got["plain"]
                res[dt] = {"loss": kl, "loss_rel_err": abs(kl - pl) / abs(pl),
                           "grad_rel_err": ((kg - pg).norm() / pg.norm()).item()}
                if not (res[dt]["loss_rel_err"] <= loss_tol
                        and res[dt]["grad_rel_err"] <= grad_tol):
                    raise RuntimeError(f"the kernels part from their plain versions at "
                                       f"{list(batch['audio'].shape)}: {json.dumps(res)}")
        finally:
            tr.model, tr.featurizer, tr.compute_dtype = model, featurizer, dtype
            model.train()
            for p in model.parameters():
                p.grad = None
        return res

    # ------------------------------------------------------------------
    def _run_cli(self, cli, flags, tag):
        """One of the port's CLIs (``test``, ``decode``, ``convert_streaming``)
        through its ``main`` in this process, with ``flags`` (and
        ``--device`` where it takes one); its standard output is appended to
        ``<root>/<tag>.console`` and returned. A CLI's error propagates."""
        if cli != "convert_streaming":
            flags = [*flags, f"--device={self.device}"]
        main = importlib.import_module(f"wav2letter_tpu_torch.cli.{cli}").main
        t0 = time.time()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                main(list(flags))
        finally:
            with open(os.path.join(self.root, f"{tag}.console"), "a") as f:
                f.write(buf.getvalue())
        self.timed(tag, t0)
        return buf.getvalue()

    @staticmethod
    def _parse_wer(text):
        ms = re.findall(r"WER:\s*([0-9.]+)%", text)
        return float(ms[-1]) if ms else None

    def _pair_words(self):
        with open(self.paths["meta"]) as f:
            meta = json.load(f)
        return {w for p in meta["pairs"] for w in p}

    def _slice_rates(self, sclite_base):
        """Overall and homophone-slice word error rates from sclite
        ``.hyp``/``.ref``: of the ref tokens that are homophone-pair words
        (resolvable only from context), how many did this decode get wrong?"""
        from ..ops.editdistance import align

        pair_words = self._pair_words()
        hyps, refs = _read_sclite(f"{sclite_base}.hyp"), _read_sclite(f"{sclite_base}.ref")
        pair_err = pair_tot = err = tot = 0
        for sid, ref in refs.items():
            for r, h in align(ref, hyps.get(sid, [])):
                if r is None:
                    err += 1  # insertion
                    continue
                tot += 1
                wrong = int(r != h)
                err += wrong
                if r in pair_words:
                    pair_tot += 1
                    pair_err += wrong
        return {
            "wer": round(100.0 * err / max(tot, 1), 2),
            "homophone_tokens": pair_tot,
            "homophone_err_rate": round(100.0 * pair_err / max(pair_tot, 1), 2),
        }

    def _sweep(self, common, lst, lm, lo, hi, step, ws, emdir, tag):
        """{lmweight: WER} of ``cli.decode``'s sweep over one emission cache."""
        out = self._run_cli("decode", [
            *common, f"--test={lst}", f"--lm={lm}", f"--lmweight_low={lo}",
            f"--lmweight_high={hi}", f"--lmweight_step={step}",
            f"--wordscore={ws}", f"--emission_dir={emdir}"], tag)
        wers = re.findall(r"\[Decode .*?\] WER: ([0-9.]+)%", out)
        return {round(lo + step * i, 2): float(w) for i, w in enumerate(wers)}

    def phase_product(self, run="b128"):
        if self.done("product"):
            return
        t_phase = time.time()
        am = os.path.join(self.root, run, "model_last.bin")
        lm = os.path.join(self.root, "lm3.arpa")
        test, dev = self.paths["test"], self.paths["dev"]
        lex = self.paths["lexicon"]
        sz = self.sizes
        prod = {}

        # 1. viterbi test WER (cli.test) + homophone slice
        log("product: viterbi test")
        sc_vit = os.path.join(self.root, "sclite_vit")
        out = self._run_cli("test", [f"--am={am}", f"--test={test}",
                                     "--nthread=2", f"--sclite={sc_vit}"], "viterbi")
        prod["viterbi_test_wer"] = self._parse_wer(out)
        prod["viterbi_slice"] = self._slice_rates(
            os.path.join(sc_vit, os.path.basename(test)))

        common = [f"--am={am}", f"--lexicon={lex}", "--uselexicon=true",
                  "--beamsize=50", "--beamthreshold=100", "--smearing=max",
                  "--nthread_decoder=4", "--nthread=2", "--decodertype=wrd"]

        # 2. lexicon beam, no LM
        log("product: lexicon beam (ZeroLM)")
        sc_nolm = os.path.join(self.root, "sclite_nolm")
        out = self._run_cli("decode", [*common, f"--test={test}",
                                       f"--sclite={sc_nolm}"], "zerolm")
        prod["beam_nolm_test_wer"] = self._parse_wer(out)
        prod["beam_nolm_slice"] = self._slice_rates(
            os.path.join(sc_nolm, os.path.basename(test)))

        # 3. joint lmweight x wordscore sweep on dev (one emission cache)
        log("product: lmweight sweep on dev")
        emdir = os.path.join(self.root, "em_dev")
        sweep = {}
        best_w, best_ws, best_wer = 0.0, 0.5, 1e9
        for ws in sz["wordscores"]:
            for lw, w in self._sweep(common, dev, lm, *sz["sweep"], ws, emdir,
                                     f"sweep_ws{ws}").items():
                sweep[f"lm{lw}_ws{ws}"] = w
                if w < best_wer:
                    best_wer, best_w, best_ws = w, lw, ws
        prod["lmweight_sweep_dev"] = sweep
        prod["best_lmweight"] = best_w
        prod["best_wordscore"] = best_ws

        # 4. beam+LM on test at the dev-optimal weights + homophone slice
        log(f"product: beam+LM on test at lmweight={best_w} ws={best_ws}")
        sc_lm = os.path.join(self.root, "sclite_lm")
        out = self._run_cli("decode", [
            *common, f"--test={test}", f"--lm={lm}",
            f"--lmweight={best_w}", f"--wordscore={best_ws}",
            f"--sclite={sc_lm}"], "beamlm")
        prod["beam_lm_test_wer"] = self._parse_wer(out)
        prod["beam_lm_slice"] = self._slice_rates(
            os.path.join(sc_lm, os.path.basename(test)))

        # 4b. homophone-heavy eval slice: the same chain on sentences
        # rejection-sampled to >= 2 pair tokens each
        from .synth_corpus import generate_homophone_slice

        homo = os.path.join(self.corpus, "homo_eval.lst")
        if not os.path.exists(homo):
            log("product: generating homophone-heavy eval slice")
            homo = generate_homophone_slice(self.corpus, n_utts=sz["homo_utts"])
        log("product: homophone slice viterbi vs beam vs beam+LM")
        sc_hv = os.path.join(self.root, "sclite_homo_vit")
        out = self._run_cli("test", [f"--am={am}", f"--test={homo}",
                                     "--nthread=2", f"--sclite={sc_hv}"], "homo_viterbi")
        hv = self._slice_rates(os.path.join(sc_hv, "homo_eval.lst"))
        hv["wer_overall"] = self._parse_wer(out)
        sc_hn = os.path.join(self.root, "sclite_homo_nolm")
        out = self._run_cli("decode", [*common, f"--test={homo}",
                                       f"--sclite={sc_hn}"], "homo_nolm")
        hn = self._slice_rates(os.path.join(sc_hn, "homo_eval.lst"))
        hn["wer_overall"] = self._parse_wer(out)
        sc_hl = os.path.join(self.root, "sclite_homo_lm")
        out = self._run_cli("decode", [
            *common, f"--test={homo}", f"--lm={lm}",
            f"--lmweight={best_w}", f"--wordscore={best_ws}",
            f"--sclite={sc_hl}"], "homo_lm")
        hl = self._slice_rates(os.path.join(sc_hl, "homo_eval.lst"))
        hl["wer_overall"] = self._parse_wer(out)
        prod["homophone_slice_eval"] = {
            "viterbi": hv, "beam_nolm": hn, "beam_lm": hl}
        # WER(lmweight) on the slice (its own emission cache): the LM's
        # leverage where the corpus is ambiguous; the dev-tuned numbers above
        # stay the protocol
        prod["homophone_slice_sweep"] = self._sweep(
            common, homo, lm, *sz["homo_sweep"], best_ws,
            os.path.join(self.root, "em_homo"), "homo_sweep")

        # 5. beam dump + rescoring grid + oracle WER on dev
        log("product: beam dump + rescore")
        sclite = os.path.join(self.root, "sclite")
        self._run_cli("decode", [
            *common, f"--test={dev}", f"--lm={lm}",
            f"--lmweight={best_w}", f"--wordscore={best_ws}",
            "--isbeamdump=true", f"--sclite={sclite}",
            f"--emission_dir={emdir}"], "beamdump")
        t0 = time.time()
        prod["rescore"] = self._rescore(sclite, dev, lm)
        self.timed("rescore", t0)

        # 6. streaming: convert + chunked decode against offline, by cause
        log("product: convert + streaming WER")
        prod["streaming"] = self._streaming_eval(am, best_w, best_ws,
                                                 n_utts=sz["stream_utts"])

        # 7. the top-k decode against the full-row decode
        log(f"product: top-{TOPK} against full rows")
        prod["topk_vs_full"] = self._topk_vs_full(common, best_w, best_ws)

        self.results["product"] = prod
        self.timed("product", t_phase)
        self.mark("product")

    def _rescore(self, sclite_dir, dev_lst, lm):
        from ..decoder.lm import ArpaLM
        from ..ops.editdistance import edit_distance
        from .rescore import grid_search_weights, load_beam_dump, oracle_wer, rescore_beams

        base = os.path.join(sclite_dir, os.path.basename(dev_lst))
        beams = load_beam_dump(base + ".beams")
        refs = {}
        with open(dev_lst) as f:
            for line in f:
                parts = line.split(None, 3)
                refs[parts[0]] = parts[3].split() if len(parts) > 3 else []
        o = oracle_wer(beams, refs)
        lm_fn = ArpaLM(lm).score_sentence
        w, _ = grid_search_weights(beams, refs, lm_fn)
        hyps = rescore_beams(beams, lm_fn, w)
        errs = tot = 0
        for sid, ref in refs.items():
            errs += edit_distance(ref, hyps.get(sid, []))
            tot += len(ref)
        return {"oracle_wer": round(o, 2),
                "rescored_wer": round(100.0 * errs / max(tot, 1), 2),
                "grid_weights": [float(x) for x in w], "n_beams": len(beams)}

    def _online_decoder(self, n_tokens, sil, blank, lmweight, wordscore):
        """A factory of the JAX soak's online beam: the native decoder, a
        trie of the lexicon (scores 0, smeared by max), the 3-gram ARPA."""
        from ..data.dictionary import Lexicon, make_word_dict
        from ..decoder import CriterionType, DecoderOptions
        from ..decoder.native import NativeBeamDecoder, NativeLM, NativeTrie

        lexicon = Lexicon.from_file(self.paths["lexicon"])
        word_dict = make_word_dict(lexicon)
        lm = NativeLM(os.path.join(self.root, "lm3.arpa"), usr_vocab=word_dict.entries())
        trie = NativeTrie(n_tokens)
        for w, sps in lexicon.entries.items():
            widx = word_dict.get_index(w)
            for sp in sps:
                ids = [self._tok_dict.get_index(t) for t in sp if self._tok_dict.contains(t)]
                if ids:
                    trie.insert(ids, widx, 0.0)
        trie.smear("max")
        opts = DecoderOptions(beam_size=50, beam_threshold=100.0, lm_weight=lmweight,
                              word_score=wordscore, criterion_type=CriterionType.CTC)
        unk = word_dict.get_index("<unk>") if word_dict.contains("<unk>") else -1

        def make():
            return NativeBeamDecoder(opts, trie, lm, sil, blank, unk, n_tokens)

        return make, word_dict

    def _streaming_eval(self, am, lmweight, wordscore=0.5, n_utts=100):
        """Convert the checkpoint, stream the first ``n_utts`` test
        utterances in 500 ms chunks through the online beam (each chunk's
        best words, then ``prune(0)``; the transcript is the concatenation
        of the per-chunk partials, as the reference's ``AudioToWords``), and
        split the gap to the offline decode by cause (the module's
        docstring: (a), (b), (c))."""
        import numpy as np
        import torch

        from ..config import Config
        from ..data import read_list_file
        from ..data.audio import load_audio
        from ..data.dictionary import Dictionary
        from ..inference import StreamingFeaturizer, load_streaming_bundle
        from ..ops.editdistance import edit_distance
        from ..runtime.test import Evaluator

        bundle = os.path.join(self.root, "am.stream")
        self._run_cli("convert_streaming", [f"--am={am}", f"--out={bundle}"], "convert")
        t0 = time.time()
        net, featp, meta = load_streaming_bundle(bundle, self.device)
        self._tok_dict = Dictionary([str(t) for t in meta["tokens"]])
        n_tokens = len(self._tok_dict)
        blank, sil = n_tokens - 1, self._tok_dict.get_index("|")
        make, word_dict = self._online_decoder(n_tokens, sil, blank, lmweight, wordscore)
        # the batch path in fp32, as the stream: the checkpoint's featurizer
        # and network
        cfg = Config()
        cfg.update({"am": am})
        ev = Evaluator(cfg, device=self.device)
        ev.dtype = torch.float32
        samples = read_list_file(self.paths["test"])[:n_utts]

        def words(ids):
            return [word_dict.get_entry(w) for w in ids if w >= 0]

        def online(chunks):
            """Feed each chunk's emissions, take the best words, prune(0)."""
            dec = make()
            dec.decode_begin()
            hyp: List[int] = []
            for y in chunks[:-1]:
                if len(y):
                    dec.decode_step(y)
                    hyp += [w for w in dec.get_results(1)[0].words if w >= 0]
                    dec.prune(0)
            if len(chunks[-1]):
                dec.decode_step(chunks[-1])
            dec.decode_end()
            return words(hyp + [w for w in dec.get_results(1)[0].words if w >= 0])

        hyps: Dict[str, Dict[str, List[str]]] = {k: {} for k in ("a", "b", "c_whole")}
        refs = {}
        em_dist = em_same = 0.0
        for s in samples:
            audio = load_audio(s.audio_path, 16000)
            sf = StreamingFeaturizer(featp, self.device)
            fstate, states = sf.start(), net.start(1)
            chunks, feats = [], []
            for off in range(0, len(audio), CHUNK):
                fstate, f = sf.run(fstate, audio[off:off + CHUNK])
                y = np.zeros((0, n_tokens), np.float32)
                if len(f):
                    feats.append(f)
                    states, yt = net.run(states, f[None, :, :, None])
                    y = yt[0, :, 0, :].float().cpu().numpy()
                chunks.append(y)
            states, yt = net.finish(states)
            chunks.append(np.zeros((0, n_tokens), np.float32) if yt is None
                          else yt[0, :, 0, :].float().cpu().numpy())
            streamed = np.concatenate(chunks)
            # (b): the batch featurizer and network on the whole utterance,
            # cut where the stream's chunks ended; and the batch network on
            # the streamed features (the stream's own yardstick)
            x = torch.from_numpy(audio)[None].to(ev.device)
            with torch.no_grad():
                bf, _ = ev.featurizer(x)
                batch_em = ev.model(bf.float())[0][0].float().cpu().numpy()
                same = ev.model(torch.cat(feats)[None].float())[0][0].float().cpu().numpy()
            if batch_em.shape != streamed.shape or same.shape != streamed.shape:
                raise RuntimeError(f"stream {s.sample_id}: emissions {streamed.shape}, "
                                   f"batch {batch_em.shape}, on stream features {same.shape}")
            em_dist = max(em_dist, float(np.abs(streamed - batch_em).max()))
            em_same = max(em_same, float(np.abs(streamed - same).max()))
            cuts = np.cumsum([len(c) for c in chunks])[:-1]
            hyps["a"][s.sample_id] = online(chunks)
            hyps["b"][s.sample_id] = online(np.split(batch_em, cuts))
            hyps["c_whole"][s.sample_id] = online([batch_em])
            refs[s.sample_id] = s.transcript.split()

        def wer(h):
            errs = sum(edit_distance(refs[k], h[k]) for k in refs)
            return round(100.0 * errs / max(sum(len(r) for r in refs.values()), 1), 2)

        self.timed("stream", t0)
        # (c): the offline decode CLI on the same subset
        sub = os.path.join(self.root, "test_sub.lst")
        with open(sub, "w") as f:
            for s in samples:
                f.write(f"{s.sample_id} {s.audio_path} {s.duration_ms} "
                        f"{s.transcript}\n")
        sc_off = os.path.join(self.root, "sclite_offline_sub")
        out = self._run_cli("decode", [
            f"--am={am}", f"--lexicon={self.paths['lexicon']}",
            "--uselexicon=true", "--beamsize=50", "--beamthreshold=100",
            "--smearing=max", "--nthread_decoder=4", "--decodertype=wrd",
            f"--test={sub}", f"--lm={os.path.join(self.root, 'lm3.arpa')}",
            f"--lmweight={lmweight}", f"--wordscore={wordscore}",
            f"--sclite={sc_off}"], "offline_sub")
        hyps["c"] = _read_sclite(os.path.join(sc_off, "test_sub.lst.hyp"))

        def differ(x, y):
            return sum(hyps[x][k] != hyps[y].get(k) for k in refs)

        return {"streaming_wer": wer(hyps["a"]),
                "offline_wer": self._parse_wer(out),
                "n_utts": len(samples),
                "batch_emissions_chunked_wer": wer(hyps["b"]),
                "batch_emissions_whole_wer": wer(hyps["c_whole"]),
                "max_abs_stream_vs_batch": em_dist,
                "max_abs_stream_vs_batch_on_stream_features": em_same,
                "utts_differ": {"a_b": differ("a", "b"), "b_c": differ("b", "c"),
                                "a_c": differ("a", "c"),
                                "b_c_whole": differ("b", "c_whole"),
                                "c_whole_c": differ("c_whole", "c")}}

    def _topk_vs_full(self, common, lmweight, wordscore):
        """The test set decoded at ``--beamsizetoken=TOPK`` twice: shipped as
        top k, and from full rows (``--emission_dir``). Counts as
        ``chip_smoke.py``'s decode phase: frames whose k-th and (k+1)-th
        values tie, and frames whose top k leaves out the blank or the
        separator (which bypass ``--beamsizetoken`` in the beam)."""
        import numpy as np

        from ..data import read_list_file

        test = self.paths["test"]
        base = [*common, f"--test={test}", f"--lm={os.path.join(self.root, 'lm3.arpa')}",
                f"--lmweight={lmweight}", f"--wordscore={wordscore}",
                f"--beamsizetoken={TOPK}"]
        emdir = os.path.join(self.root, "em_test_full")
        res, hyps = {}, {}
        for tag, extra in (("topk", []), ("full", [f"--emission_dir={emdir}"])):
            sc = os.path.join(self.root, f"sclite_{tag}{TOPK}")
            out = self._run_cli("decode", [*base, *extra, f"--sclite={sc}"], f"{tag}{TOPK}")
            res[f"{tag}_wer"] = self._parse_wer(out)
            hyps[tag] = _read_sclite(os.path.join(sc, os.path.basename(test) + ".hyp"))
        with open(self.paths["tokens"]) as f:
            tokens = [l.strip() for l in f if l.strip()]
        sep, blank = tokens.index("|"), len(tokens)
        tied = blank_out = sep_out = frames = 0
        for s in read_list_file(test):
            e = np.load(os.path.join(emdir, f"{s.sample_id}.npz"))["emission"]
            top = -np.partition(-e, TOPK, axis=1)[:, :TOPK + 1]
            top.sort(axis=1)
            kth, next_ = top[:, 1], top[:, 0]
            frames += len(e)
            tied += int((kth == next_).sum())
            blank_out += int((e[:, blank] < kth).sum())
            sep_out += int((e[:, sep] < kth).sum())
        res.update(beamsizetoken=TOPK, n_utts=len(hyps["full"]),
                   utts_differ=sum(hyps["topk"].get(k) != v for k, v in hyps["full"].items()),
                   frames=frames, tied_frames=tied, blank_outside_k=blank_out,
                   separator_outside_k=sep_out)
        return res

    # ------------------------------------------------------------------
    def phase_report(self):
        r = self.results
        lines = ["# Soak results", ""]
        for k in ("corpus", "lm", "train_b128", "train_b32", "product", "timing"):
            if k in r:
                lines.append(f"## {k}\n```json\n{json.dumps(r[k], indent=1)}\n```\n")
        with open(os.path.join(self.root, "SUMMARY.md"), "w") as f:
            f.write("\n".join(lines))
        log(f"report written: {self.root}/SUMMARY.md")
        print(json.dumps(r.get("product", {}), indent=1))


def _rate(run, stamps):
    """Wall ms an update between a run's first and last report (its
    validation passes and checkpoints included), from the wall clock."""
    (u0, t0), (u1, t1) = stamps[0], stamps[-1]
    return {"run": run, "from": u0, "to": u1, "wall_s": round(t1 - t0, 1),
            "wall_ms_per_update": round(1e3 * (t1 - t0) / max(u1 - u0, 1), 2)}


def _read_sclite(path):
    """{sample id: words} of an sclite ``.hyp`` or ``.ref`` file."""
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"(.*)\(([^)]+)\)\s*$", line)
            if m:
                out[m.group(2)] = m.group(1).split()
    return out


PHASES = ["corpus", "lm", "b128", "profile", "product", "b32", "report"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", default="all",
                    help=f"all, or a comma-separated list of {','.join(PHASES)}")
    ap.add_argument("--root", default=os.path.join(REPO, "_local", "soak_torch"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--iters_b128", type=int, default=None)
    ap.add_argument("--iters_b32", type=int, default=None)
    a = ap.parse_args(argv)
    s = Soak(a.root, fast=a.fast, iters_b128=a.iters_b128, iters_b32=a.iters_b32,
             device=a.device)
    # product (the trained-model evidence) runs before the B=32 regime, so a
    # cut-off costs the less valuable phase
    phases = PHASES if a.phase == "all" else a.phase.split(",")
    for p in phases:
        if p not in PHASES:
            raise SystemExit(f"unknown phase {p!r}: {', '.join(PHASES)}")
        getattr(s, f"phase_{p}")()
        s.save()
    return s


if __name__ == "__main__":
    main()
