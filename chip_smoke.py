#!/usr/bin/env python3
"""Drive the PyTorch port (``wav2letter_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--seed N]

Run from the root of a checkout on a machine with a CUDA card. Phases:

1. the device: name, count, ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``wav2letter_tpu_torch/csrc``;
3. hold each kernel (K1 MFSC, K2 time conv, K3 residual LayerNorm, K4 fused
   attention) against its plain PyTorch version at the shapes of the serving
   paths' largest batch (fp32, and bf16 for K2-K4); K1 also at the training
   row (B=16) and at ``K1_EDGES`` (8 kHz, 40 mels, and a stride the tensor
   cores do not take, which runs K1's CUDA-core route), K3 at ``LN_EDGES``
   (D = 100, 1, 9000, R = 1, an unaligned view: its shared-memory route
   where the register route does not take them), each K1 and K3 row with
   its route, K1's with its tile and the TFLOP/s of its dense products,
   K3's with its warps a row and its library call (x + y, then
   ``F.layer_norm``) beside ``F.layer_norm`` of a precomputed sum; and the
   backward kernels
   (K2 as dgrad, K2b time-conv weight gradient, K3b residual LayerNorm
   backward, K4b attention backward) and the three autograd functions at the
   shapes of the training paths' largest batch; K4 and K4b also at T=188
   unmasked, at the gate's edge T=460, at the conformer's H=4, Dh=128,
   T=240 and at T=17 and 65, which cut K4's tiles raggedly, without dropout
   and at rate 0.2 with the same keep mask on both sides; K4b alone also at
   the long-context update (B=2, T=1712), at T=17, 65, 188 and the last T it
   takes at Dh = 192, and at Dh = 8, 64, 128, 256 (``check_attention_bwd``),
   and at the training row its time by launch and by tile height; K2b and K4b twice for equal bits; time kernel, plain version, one PyTorch call of the same
   function where there is one, and the bound; K4 also at each tile height
   (query rows a block) that fits, with the one it picks, its blocks and its
   TFLOP/s; K2, its dgrad and K2b also at ``CONV_EDGES`` (C = 1 with 20
   taps, a ragged strided tile, F = 40, the largest weight the route
   admits), each row with its route (tensor cores, in bf16 or in fp32 as
   3xTF32, or CUDA cores), the schedule it launches (frames a tile, tiles a
   block, warps, blocks; fp32's split taps), TFLOP/s and share of the
   bound; times are device times with the inputs in HBM (cold L2), the
   kernel's also with L2-warm inputs; fp32 bounds count operations at
   3xTF32's 165 TFLOP/s (``PEAK_FLOPS``);
4. the main path at full width: the streaming-convnets flagship
   (``recipes/streaming_convnets/network.arch``, 80 filterbanks, 9998
   classes, 96,660,482 parameters, seeded weights) serves ~8 synthesized
   utterances of 4-15 s through the port's ``run_test`` (``Evaluator`` set-up,
   then ``evaluate``, timed apart) at batch 4, in bf16 and then fp32, with
   the launch counts of each run checked (1 K1, 15 K2, 22 K3 per batch) and
   its emissions held against the plain-version forward on the card; then
   ``PASSES`` more passes of the loaded model give the steady-state rate;
5. one profiled bf16 forward: device time by kernel;
6. training at full width: the same flagship takes ``TRAIN_UPDATES`` updates
   in bf16 (fp32 master parameters) and then in fp32 through the port's
   ``Trainer`` on 32 synthesized utterances at batch 16 (SGD momentum 0.9,
   gradient clipping, dropout and SpecAugment as the arch says, one validation
   pass and checkpoints), with the launch counts of every update checked
   (1 K1, 15 K2 + 14 dgrad, 15 K2b, 22 K3, 22 K3b), every loss finite, and
   with dropout and SpecAugment off the first batch's loss and every
   parameter's gradient held against the plain path on the card; then
   ``cli.train continue`` takes 2 more updates from ``model_last.bin``, and
   ``run_test`` serves the result; one profiled update of each type gives
   the split into forward, backward and optimizer, the idle share and the
   peak memory;
7. phases 4-6 again for the transformer (``recipes/transformer_ctc/
   network.arch`` at full width and depth, 97,670,462 parameters): served at
   batch 4 (1 K1, 12 K4, 24 K3 and no K2 per batch), trained at batch 8 with
   adam, gradient clipping at 0.1, dropout 0.2 and layerdrop 0.1 (per update
   12 K4, 12 K4b, 24 K3, 24 K3b; the loss must fall), resumed and served;
8. the conformer (``recipes/conformer_ctc/network.arch`` at full width, 4 of
   its 16 layers): two updates and a validation pass on utterances of 4-6.3 s
   (K4 and K4b once per layer), emissions against the plain path, and a batch
   of 15 s utterances, beyond the relative-position table, that must take the
   unfused path with no K4 launch;
9. the transformer at full width, 2 of its layers, with a table of 2000
   relative positions: one bf16 update on two 134-136 s utterances (T up to
   1712 after the pools) launches K4 and K4b once per layer; serving the
   same batch takes K4;
10. the lexicon beam decode of phase 4's flagship checkpoints through
   ``cli.decode`` with ``W2L_REQUIRE_NATIVE=1`` (the native decoder built by
   ``g++`` from ``wav2letter_tpu_torch/ops/native/decoder.cpp``), a 3-gram
   ARPA of the list's transcripts and its probing ``.bin``, in bf16 and
   fp32 at batch 4, beam 100, ``--beamsizetoken=100``: the top-k-shipped
   decode (timed: audio s per wall s, the forward's device time, the beam's
   host time), the full-row decode that fills ``--emission_dir`` and the
   ``.bin`` over that cache, with the launch counts checked (1 K1, 15 K2, 22
   K3 per batch), the emissions held against the plain-version forward, the
   shipped top-k's words against the host's cut of the full rows on every
   utterance without a tie at the k-th value (tied frames, and frames whose
   top k leaves out the blank or the separator, counted), the ``.bin``'s
   words against the ARPA's, and the native beam's against the Python
   beam's on the two shortest utterances;
11. chunked streaming inference: phase 4's fp32 checkpoint through
   ``cli.convert_streaming``, the list streamed at batch 1 in 500 ms chunks
   through the Python API (``StreamingFeaturizer``, ``StreamingNetwork``)
   into the online Python beam (phase 10's lexicon and ARPA, beam 100,
   ``beamSizeToken`` 100, threshold 25, ``prune`` to 250 ms after every
   chunk), with every chunk's launches checked (1 K1 when frames come out, a
   K2 for each conv and TDS block that emits frames, two K3 for each such
   block), the streamed emissions against the batch fp32 forward on the same
   features (max 1e-4), the streamed features against the batch featurizer's
   K1 with its local CMVN in float64 (2e-3; the distance to its fp32 CMVN is
   reported), the streamed words against the same beam fed the batch emissions
   cut at the stream's chunk boundaries, ``cli.streaming_asr`` (a
   subprocess, the shortest utterance) and ``cli.streaming_asr_multi`` (the
   4 shortest, 4 threads) against the single-stream words, and K1, K2 and
   K3 at a steady chunk's shapes against their plain versions (K2's dgrad
   and K2b there too, checked and timed though a chunk runs no backward,
   K2b twice for equal bits); the device time of a steady chunk's 15 K2
   launches replayed from one CUDA graph; the real-time factor, each
   chunk's latency (featurizer, network, beam; p50 and p95) and one
   utterance's device busy time and idle share.

It prints ``{"kernels": [...]}``, then the ``nvidia-smi`` line, then as the
last line ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line. Without a card, or outside a checkout, it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ARCH = os.path.join(REPO, "recipes", "streaming_convnets", "network.arch")
TR_ARCH = os.path.join(REPO, "recipes", "transformer_ctc", "network.arch")
CFR_ARCH = os.path.join(REPO, "recipes", "conformer_ctc", "network.arch")
N_FEAT, N_TOKENS, BATCH = 80, 9997, 4
TRAIN_UTTS = 32
TRAIN_UPDATES = {"bfloat16": 6, "float32": 4}
CONTINUE_UPDATES = 2
CFR_LAYERS = 4  # of the conformer recipe's 16
# K2 and K2b at the edges of the bf16 tensor-core route, (B, T, F, C, CO, K,
# stride, pads), beside the path's shapes: C = 1 with 20 taps (two 16-tap
# steps); stride 2 with a ragged last tile (Tout = 50); F = 40, not a
# multiple of a block's 16 positions; the largest weight the route admits
# (12 x 36 x 36, 62 KB in fp32)
CONV_EDGES = [(4, 400, 24, 1, 8, 20, 1, (10, 9)), (4, 101, 80, 16, 20, 11, 2, (8, 1)),
              (4, 300, 40, 20, 24, 11, 1, (5, 5)), (4, 300, 80, 36, 36, 12, 1, (6, 5))]
# the long-context transformer: a table of 2000 positions, T = 1712 after the pools
LONG_LAYERS, LONG_BPTT = 2, 2000
# The two model families driven at full width. ``per_forward``: launches of
# one forward (a serving or validation batch, or an update's forward);
# ``per_backward``: what an update launches on top of that. The flagship's
# first conv takes the features and has no dgrad: 14 K2 launches, not 15.
# Layerdrop scales a layer's branch by 0 and does not skip the layer, so the
# transformer's counts are fixed. The transformer trains with its recipe's
# flags, but the learning rate and warm-up (0.03 after 32000 updates) are cut
# to what a few updates can show; SpecAugment starts at update 10000 there.
FLAGSHIP = dict(
    name="flagship", arch=ARCH, n_params=96_660_482, flags=dict(localnrmlleftctx=300),
    per_forward={"mfsc": 1, "time_conv": 15, "residual_ln": 22},
    per_backward={"time_conv": 14, "time_conv_wgrad": 15, "residual_ln_bwd": 22},
    train=dict(batchsize=16, netoptim="sgd", lr=0.05, momentum=0.9, maxgradnorm=0.5),
    opt_slot="trace")
TRANSFORMER = dict(
    name="transformer", arch=TR_ARCH, n_params=97_670_462, flags={},
    per_forward={"mfsc": 1, "mhsa": 12, "residual_ln": 24},
    per_backward={"mhsa_bwd": 12, "residual_ln_bwd": 24},
    train=dict(batchsize=8, netoptim="adam", adambeta1=0.9, adambeta2=0.98, lr=5e-4,
               warmup=2, lr_sched="inv_sqrt", lr_step_decay=50000, maxgradnorm=0.1,
               saug_start_update=10000),
    opt_slot="mu", loss_falls=True)
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
PASSES = 5  # steady-state passes over the served list per type
TF32_PEAK = 495e12  # H100 SXM, dense
# The least time for a function's operations, H100 SXM, dense. fp32 counts at
# the fastest fp32-accurate rate the card has: 3xTF32 on the tensor cores
# (three TF32 products a product, 495 / 3 TFLOP/s), above the CUDA cores' 67.
PEAK_FLOPS = {"float32": TF32_PEAK / 3, "bfloat16": 989e12}
TPU_KERNELS = {
    "mfsc": ("wav2letter_tpu/ops/pallas/mel.py:65", "wav2letter_tpu_torch/csrc/mfsc.cu"),
    "time_conv": ("wav2letter_tpu/ops/pallas/tconv.py:155",
                  "wav2letter_tpu_torch/csrc/tconv.cu"),
    "time_conv_wgrad": ("wav2letter_tpu/ops/pallas/tconv.py:232",
                        "wav2letter_tpu_torch/csrc/tconv_wgrad.cu"),
    "residual_ln": ("wav2letter_tpu/ops/pallas/layernorm.py:77",
                    "wav2letter_tpu_torch/csrc/layernorm.cu"),
    "residual_ln_bwd": ("wav2letter_tpu/ops/pallas/layernorm.py:111",
                        "wav2letter_tpu_torch/csrc/layernorm.cu"),
    "mhsa": ("wav2letter_tpu/ops/pallas/attention.py:236",
             "wav2letter_tpu_torch/csrc/attention.cu"),
    "mhsa_bwd": ("wav2letter_tpu/ops/pallas/attention.py:267",
                 "wav2letter_tpu_torch/csrc/attention.cu"),
}
# kernel vs plain version, |got - want| <= atol + rtol * |want|
TOL = {
    ("mfsc", "float32"): (1e-4, 1e-4),       # 400-term fp32 sums, log features
    ("time_conv", "float32"): (1e-4, 1e-4),  # <= 336-term fp32 sums
    ("time_conv", "bfloat16"): (1e-2, 1e-2),  # one bf16 rounding of the output
    ("residual_ln", "float32"): (1e-5, 1e-5),
    ("residual_ln", "bfloat16"): (2e-2, 1e-2),
    ("time_conv_dgrad", "float32"): (1e-4, 1e-4),  # <= 336-term fp32 sums
    ("time_conv_dgrad", "bfloat16"): (1e-2, 1e-2),  # one bf16 rounding of the output
    # dw sums N = B*Tout*F <= 1e6 products of O(1) values, exact in fp32 for
    # either input type, in fp32 on both sides but in another order. Entries
    # are O(sqrt N) = 1e3; the worst case of fp32 summation is
    # eps * N * E|x*dy| = 6e-8 * 1e6 * 0.64 = 0.04, and ordered blocked sums
    # stay far below it: half of that, plus 1e-4 relative
    ("time_conv_wgrad", "float32"): (1e-4, 2e-2),
    ("time_conv_wgrad", "bfloat16"): (1e-4, 2e-2),
    ("residual_ln_bwd", "float32"): (1e-5, 1e-5),
    ("residual_ln_bwd", "bfloat16"): (2e-2, 1e-2),
    # attention: fp32 sums of Dh <= 192 and T <= 460 terms in another order,
    # outputs O(0.1-1); in bf16 one rounding of the output, and of p and ds
    # where the fp32 values behind them differ in the last bit
    ("mhsa", "float32"): (1e-4, 1e-5),
    ("mhsa", "bfloat16"): (2e-2, 1e-2),
    # the gradients, each held as a share of its largest entry (``_worst``):
    # dk and dv sum T, dPwin up to B*H*T = 6144 products per entry; in bf16 p
    # and ds are rounded before their products, and the autograd of the plain
    # forward, which the function is also held against, rounds neither
    ("mhsa_bwd", "float32"): (1e-4, 1e-4),
    ("mhsa_bwd", "bfloat16"): (2e-2, 2e-2),
}
# the autograd functions against autograd of the plain forward. The two
# forwards round a few outputs of ~0 to different sides of 0 (one or two of
# 2e7 in fp32, more in bf16), so their ReLU masks differ there: one dy term
# more or less in K*C entries of dx (measured: up to 9% of the largest entry,
# in 4e-5 of the entries), in the dw of one output channel and in one dbias
# entry (0.3% of the largest). The kernels themselves are held to TOL above;
# this check is for the wiring (mask, bias, which gradient goes where), whose
# faults are of order 1. Hence an elementwise bound (rtol, atol as a share
# of the gradient's largest entry) wide enough for a few flipped terms in dw
# and dbias, and a share of entries allowed outside it for dx.
FN_TOL = {"float32": (1e-3, 2e-2, 1e-3), "bfloat16": (5e-2, 2e-2, 2e-3)}
# First training batch on the card, dropout and SpecAugment off: the kernel
# path's loss (relative) and each parameter's gradient (L2 error relative to
# the larger of that gradient's L2 norm and 1% of the whole gradient's).
# GRAD_TOL: against the plain-version model on the same features. This
# seeded, untrained model amplifies fp32 rounding ~1e4-fold on the way back
# (two plain-version runs that differ only in the conv's summation order differ
# by 2e-3 in the first blocks' weights), hence 1e-2 in fp32.
# GRAD_TOL_FEATS: against the whole plain path, features included. K1 and its
# plain version agree to 1e-4, but local CMVN divides the first frames by the
# std of windows of 1-8 frames, which carries that rounding into the first
# layers' gradients at a few percent.
GRAD_TOL = {"float32": (1e-5, 1e-2), "bfloat16": (2e-2, 0.25)}
GRAD_TOL_FEATS = {"float32": (1e-4, 0.1), "bfloat16": (2e-2, 0.25)}
# emissions of the kernel path vs the plain path, full model: (max, mean) abs
EM_TOL = {"float32": (2e-3, 1e-4), "bfloat16": (0.25, 0.02)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def cuda_ms(fn, iters=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """Kernels and copies on the card, without the profiler's own entries."""
    import torch

    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.key.startswith("Activity Buffer")):
            yield evt


PROFILE_TRIES = 10


def profile_device(fn):
    """``fn()`` under the profiler, device activities only; returns the
    profiler. Now and then one comes back without any device event (seen once
    in some thousand uses, and once three in a row); such a reading is taken
    again after a pause, never kept, and each retry is logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if any(True for _ in device_events(prof)):
            return prof
        log(f"[profiler] reading {attempt + 1} held no device event; taken again")
        time.sleep(0.5)
    fail(f"the profiler reported no device event {PROFILE_TRIES} times in a row")


def device_ms(fn, args, cold=True, iters=20) -> float:
    """Device time per call of ``fn(*args)``: the time of the kernels it
    launches, from the profiler, without the host's launch overhead."""
    return sum(device_split(fn, args, cold, iters).values())


def device_split(fn, args, cold=True, iters=20) -> dict:
    """``device_ms`` by kernel: {the profiler's name of a kernel: ms per call}.

    Cold (the default), the calls cycle through copies of ``args`` that
    together exceed twice the L2 cache, so each call reads its inputs from
    HBM, as the bound assumes. Warm, every call reuses the same inputs, which
    stay in L2 between calls."""
    import torch

    sets = [args]
    if cold:
        nbytes = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
        sets = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]
        iters = max(iters, 2 * len(sets))
    fn(*args)
    torch.cuda.synchronize()

    def calls():
        for i in range(iters):
            fn(*sets[i % len(sets)])

    prof = profile_device(calls)
    return {e.key: e.self_device_time_total / 1e3 / iters for e in device_events(prof)}


# K4b's four launches, by a piece of the kernel's name
K4B_LAUNCHES = (("mhsa_bwd_rows", "rows"), ("mhsa_bwd_keys", "keys"),
                ("mhsa_bwd_pos_sum", "pos_sum"), ("mhsa_bwd_pos", "pos"))


def k4b_split(b_args) -> dict:
    """K4b's cold device time per call by launch (anything else: ``other``)."""
    from wav2letter_tpu_torch import kernels

    out = {}
    for key, ms in device_split(kernels.mhsa_bwd, b_args).items():
        name = next((n for piece, n in K4B_LAUNCHES if piece in key), "other")
        out[name] = out.get(name, 0.0) + ms
    return out


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, dtype, got, want):
    import torch

    rtol, atol = TOL[(name, dtype)]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rel = (err / want.abs().clamp(min=1e-6)).max().item()
    ok = bool(torch.all(err <= atol + rtol * want.abs())) and bool(torch.isfinite(got).all())
    return err.max().item(), rel, ok


# ---------------------------------------------------------------------------
# data, model and checkpoints
# ---------------------------------------------------------------------------
def synth_dataset(root: str, seed: int, n_utts: int = 8, name: str = "test", vocab=None,
                  dur=(4.0, 15.0)):
    """Utterances of ``dur`` seconds (4-15 s unless said): white noise loud enough that no mel band sits at
    the log floor, under a slow random envelope; ~1.5 words per second from a
    200-word lexicon spelled with 9996 word pieces plus the separator. A second
    list takes the first one's ``vocab`` (tokens and lexicon files)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    if vocab is None:
        pieces = [f"p{i:04d}" for i in range(N_TOKENS - 1)]
        words = {f"w{i:03d}": [pieces[j] for j in rng.choice(len(pieces), rng.randint(1, 4))]
                 for i in range(200)}
        tokens = os.path.join(root, "tokens.txt")
        with open(tokens, "w") as f:
            f.write("|\n" + "\n".join(pieces) + "\n")
        lexicon = os.path.join(root, "lexicon.txt")
        with open(lexicon, "w") as f:
            f.writelines(f"{w}\t{' '.join(sp)} |\n" for w, sp in words.items())
    else:
        tokens, lexicon = vocab
    lines, secs = [], 0.0
    for i in range(n_utts):
        n = int(16000 * rng.uniform(*dur))
        env = np.interp(np.arange(n), np.linspace(0, n, 20), rng.uniform(0.4, 1.0, 20))
        wav = (0.5 * env * rng.randn(n)).astype(np.float32)
        path = os.path.join(root, f"{name}{i:03d}.npy")
        np.save(path, wav)
        ws = [f"w{rng.randint(200):03d}" for _ in range(max(1, int(1.5 * n / 16000)))]
        lines.append(f"{name}{i:03d} {path} {1000.0 * n / 16000:.1f} {' '.join(ws)}")
        secs += n / 16000
    lst = os.path.join(root, f"{name}.lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lst, tokens, lexicon, secs


def save_model(spec, root, seed, tokens, lexicon):
    """Seeded weights of ``spec``'s arch as two port checkpoints, bf16 and fp32."""
    import torch

    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.checkpoint import Checkpoint, save_checkpoint

    torch.manual_seed(seed)
    model = build_arch_module(spec["arch"], N_FEAT, N_TOKENS + 1)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != spec["n_params"]:
        fail(f"{spec['name']} has {n_params} parameters, expected {spec['n_params']}")
    paths = {}
    for dtype in ("bfloat16", "float32"):
        cfg = Config(arch=spec["arch"], tokens=tokens, lexicon=lexicon, criterion="ctc",
                     mfsc=True, filterbanks=N_FEAT, compute_dtype=dtype, batchsize=BATCH,
                     nthread=2, **spec["flags"])
        paths[dtype] = os.path.join(root, f"{spec['name']}_{dtype}.pt")
        save_checkpoint(paths[dtype], Checkpoint(cfg.serialize(), 0, 0, model.state_dict()))
    return paths, n_params


def batch_shapes(lst, tokens, lexicon, batch=BATCH):
    """(number of batches, feature frames T and audio samples S of the
    largest batch) of the batches ``run_test`` or the trainer builds from
    ``lst`` at batch size ``batch``."""
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset, Lexicon, make_token_dict

    cfg = Config(arch=ARCH, tokens=tokens, lexicon=lexicon, criterion="ctc",
                 mfsc=True, filterbanks=N_FEAT, batchsize=batch)
    ds = AsrDataset(lst, make_token_dict(tokens, "ctc", 0, False),
                    Lexicon.from_file(lexicon), cfg, batch_size=batch)
    specs = ds.batch_specs()
    T = max(s.max_input_frames for s in specs)
    return len(specs), T, ds.audio_samples_for_frames(T)


def pooled_frames(T: int) -> int:
    """Frames after the transformer recipe's three stride-2 pools."""
    for _ in range(3):
        T = -(-T // 2)
    return T


def path_calls(model, B, T):
    """The K2 and K3 calls of one forward of ``model`` on (B, T, 80) features,
    walked from its layers: [(B, T, F, C, CO, K, stride, pads)], [(R, D)]."""
    from wav2letter_tpu_torch.kernels.tconv import out_frames
    from wav2letter_tpu_torch.models.layers import Conv2D, TDSBlock

    convs, lns, t = [], [], T
    for mod in model.seq.children():
        if isinstance(mod, Conv2D):
            pads = mod.pads(t)
            convs.append((B, t, N_FEAT, mod.in_ch, mod.out_ch, mod.wx, mod.sx, pads))
            t = out_frames(t, mod.wx, mod.sx, pads)
        elif isinstance(mod, TDSBlock):
            convs.append((B, t, mod.f, mod.c, mod.c, mod.w, 1, mod.time_pads))
            lns += [(B * t, mod.c * mod.f)] * 2
    return convs, lns


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
# K1 beside the paths' rows, (sample rate, mels, stride ms, B, S): 8 kHz
# with S % 4 != 0 (4-byte audio copies), 40 mels, a stride of 100 samples
# (the CUDA-core route); checked, timed warm, counted 0 times
K1_EDGES = [(8000, 40, 10.0, 4, 123457), (16000, 40, 10.0, 4, 64000),
            (16000, 80, 6.25, 4, 64000)]


def _mfsc_row(f, B, S, tag, timed=True):
    """K1 at one shape against its plain version: time, route, tile, the
    TFLOP/s of its dense products and their ceiling on the TF32 tensor
    cores, beside the function's own bound."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.kernels.mfsc import TENSOR_CORES, dense_flops, route, tile_frames

    p = f.p
    g = torch.Generator(device="cuda").manual_seed(B + S)
    pre = 0.5 * torch.randn((B, S), device="cuda", generator=g)
    frame, stride = p.frame_samples, p.stride_samples
    args = (pre, f.cos_mat, f.sin_mat, f.mel_fb, frame, stride, p.mel_floor)
    nb, nm = f.mel_fb.shape
    way = route(frame, stride, nb, nm)
    got = kernels.mfsc(*args)
    torch.cuda.synchronize()
    want = kernels.mfsc_plain(*args)
    err, rel, ok = compare("mfsc", "float32", got, want)
    T = got.shape[1]
    nbytes = 4 * (B * S + 2 * frame * nb + nb * nm + B * T * nm)
    # the operations the function needs per frame, not the dense products
    # the kernel does: a real FFT of n_fft points (2.5 N log2 N), the
    # magnitude of each bin, a multiply-add per nonzero of the triangular
    # filterbank, and the log of each mel
    n_fft = p.n_fft
    nnz = int((f.mel_fb != 0).sum())
    flops = B * T * (2.5 * n_fft * math.log2(n_fft) + 4 * nb + 2 * nnz + nm)
    b_ms, b_by = bound(nbytes, flops, "float32")
    dense = dense_flops(B, T, frame, nb, nm)
    if timed:
        ms, warm = device_ms(kernels.mfsc, args), device_ms(kernels.mfsc, args, cold=False)
        plain = device_ms(kernels.mfsc_plain, args)
    else:
        ms = warm = cuda_ms(lambda: kernels.mfsc(*args))
        plain = None
    row = dict(name="mfsc", dtype="float32", shape=[B, S, T], tag=tag, max_abs_err=err,
               max_rel_err=rel, tol=TOL[("mfsc", "float32")], ok=ok, ms=ms, warm_ms=warm,
               plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
               calls=1 if timed else 0, route=way,
               tile=tile_frames(B, T, torch.cuda.get_device_properties(0).multi_processor_count)
               if way == TENSOR_CORES else 32,
               frame=frame, stride=stride, n_mels=nm, dense_gflop=dense / 1e9,
               dense_tflops=dense / ms / 1e9, dense_ceiling_ms=dense / TF32_PEAK * 1e3)
    log(f"[K1] {tag} {[B, S, T]} frame {frame} stride {stride} mels {nm}: {way}, tile "
        f"{row['tile']}, {ms:.4f} ms cold, {warm:.4f} warm; dense products "
        f"{row['dense_tflops']:.1f} TFLOP/s (ceiling {row['dense_ceiling_ms']:.4f} ms at the "
        f"TF32 peak); function bound {b_ms:.4f} ms ({b_by}); max err {err:.2e}")
    return row


def check_mfsc(B, S, details, tag="serve"):
    """K1 at a path's row, on the route it takes."""
    from wav2letter_tpu_torch.features import FeatureParams, Featurizer

    f = Featurizer(FeatureParams(n_filterbanks=N_FEAT)).cuda()
    row = _mfsc_row(f, B, S, tag)
    details.append(row)
    return [row]


def check_mfsc_edges(details):
    """K1 at ``K1_EDGES``, each on the route it takes."""
    from wav2letter_tpu_torch.features import FeatureParams, Featurizer

    for rate, mels, stride_ms, B, S in K1_EDGES:
        f = Featurizer(FeatureParams(sample_rate=rate, n_filterbanks=mels,
                                     frame_stride_ms=stride_ms)).cuda()
        row = _mfsc_row(f, B, S, f"edge_{rate}_{mels}_{f.p.stride_samples}", timed=False)
        row["edge"] = True
        details.append(row)


def _conv_log(row, tag):
    """One line per K2, dgrad or K2b row: route, schedule, time, TFLOP/s, bound
    share."""
    log(f"[{tag}] {row['name']} {row['dtype']} {row['shape']} calls={row['calls']}: "
        f"{row['route']} {json.dumps(row['schedule'])}, {row['ms']:.4f} ms (library "
        f"{row['library_ms']:.4f}), {row['tflops']:.1f} TFLOP/s, "
        f"{row['bound_ms'] / row['ms']:.3f} of the bound")


def _conv_layout(dtype, key, kind, Tout):
    """The route of one K2 (``kind`` "conv" or "dgrad") or K2b ("wgrad") call
    at ``key`` and, on the tensor cores, the schedule it launches."""
    import torch

    from wav2letter_tpu_torch.kernels.tconv import route, schedule

    B, T, Fq, C, CO, K, s = key[:7]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    frames = T if kind == "dgrad" else Tout
    return dict(route=route(dtype, C, CO, K, s, Fq, kind),
                schedule=schedule(dtype, B, frames, C, CO, K, s, Fq, sms, kind))


def check_time_conv(convs, dtype_name, details, edges=()):
    """K2 at every conv shape of one forward, and at ``edges`` (not on the
    path: timed, counted 0 times)."""
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    dtype = getattr(torch, dtype_name)
    rows = []
    for key in sorted(set(convs), key=convs.index) + list(edges):
        B, T, Fq, C, CO, K, s, pads = key
        g = torch.Generator(device="cuda").manual_seed(T + K)
        x = torch.randn((B, T, Fq * C), device="cuda", generator=g).to(dtype)
        w = (0.1 * torch.randn((K, C, CO), device="cuda", generator=g)).to(dtype)
        bias = torch.randn((CO,), device="cuda", generator=g)
        args = (x, w, Fq, s, pads, bias, True)
        got = kernels.time_conv(*args)
        torch.cuda.synchronize()
        err, rel, ok = compare("time_conv", dtype_name, got, kernels.time_conv_plain(*args))
        # one PyTorch call of the same conv: conv2d on the NCHW layout, with
        # the time pads and the layout change done before the timing
        xn = F.pad(x.view(B, T, Fq, C).permute(0, 3, 2, 1), pads).contiguous()
        wn = w.permute(2, 1, 0).unsqueeze(2).contiguous()
        bn = bias.to(dtype)
        lib_ms = device_ms(lambda a, b_, c: F.conv2d(a, b_, c, stride=(1, s)), (xn, wn, bn))
        Tout = got.shape[1]
        item = x.element_size()
        nbytes = item * (x.numel() + w.numel() + got.numel()) + 4 * CO
        flops = 2 * B * Tout * Fq * CO * K * C
        b_ms, b_by = bound(nbytes, flops, dtype_name)
        ms = device_ms(kernels.time_conv, args)
        row = dict(name="time_conv", dtype=dtype_name, shape=list(key[:7]) + [list(pads)],
                   max_abs_err=err, max_rel_err=rel, tol=TOL[("time_conv", dtype_name)],
                   ok=ok, ms=ms,
                   warm_ms=device_ms(kernels.time_conv, args, cold=False),
                   plain_ms=None if key in edges else device_ms(kernels.time_conv_plain, args),
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   calls=convs.count(key), tflops=flops / ms / 1e9, edge=key in edges,
                   **_conv_layout(dtype, key, "conv", Tout))
        _conv_log(row, "K2")
        rows.append(row)
        details.append(row)
    return [r for r in rows if not r["edge"]]


def _ln_log(row):
    log(f"[K3] {row['dtype']} {row['shape']} calls={row['calls']}: {row['route']}"
        + (f", {row['warps_per_row']} warps a row" if row["route"] == "registers" else "")
        + f", {row['ms']:.4f} ms cold, {row['warm_ms']:.4f} warm; x + y and F.layer_norm "
        f"{row['library_ms']}, F.layer_norm of the sum {row.get('layer_norm_ms')}; bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']})")


def _ln_inputs(R, D, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((R, D), device="cuda", generator=g).to(dtype)
    y = torch.randn((R, D), device="cuda", generator=g).to(dtype)
    return x, y, torch.tensor([1.3], device="cuda"), torch.tensor([-0.2], device="cuda")


def _ln_compare(dtype_name, got, want):
    import torch

    err, rel, ok = compare("residual_ln", dtype_name, got[0], want[0])
    ok = ok and torch.allclose(got[1], want[1], rtol=1e-5, atol=1e-5) \
        and torch.allclose(got[2], want[2], rtol=1e-5, atol=1e-5)
    return err, rel, bool(ok)


def _ln_layout(x):
    from wav2letter_tpu_torch.kernels.layernorm import REGISTERS, route, warps_per_row

    D = x.shape[1]
    way = route(D, x.element_size(), x.data_ptr() % 16 == 0)
    return dict(route=way, warps_per_row=warps_per_row(D, x.element_size())
                if way == REGISTERS else 0)


def check_residual_ln(lns, dtype_name, details):
    """K3 at every row shape of one forward, on the route it takes. Its
    library call is K3's own function unfused: x + y, then ``F.layer_norm``
    (two launches); ``F.layer_norm`` of a precomputed sum, which reads one
    tensor where K3 reads two, stands beside it as ``layer_norm_ms``."""
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    dtype = getattr(torch, dtype_name)
    rows = []
    for key in sorted(set(lns), key=lns.index):
        R, D = key
        x, y, w, b = _ln_inputs(R, D, dtype, R + D)
        got = kernels.residual_ln(x, y, w, b)
        torch.cuda.synchronize()
        want = kernels.residual_ln_plain(x, y, w, b)
        err, rel, ok = _ln_compare(dtype_name, got, want)
        wd, bd = w.to(dtype).expand(D).contiguous(), b.to(dtype).expand(D).contiguous()
        lib_ms = device_ms(lambda a, a2, c, d: F.layer_norm(a + a2, (D,), c, d, 1e-5),
                           (x, y, wd, bd))
        ln_ms = device_ms(lambda a, c, d: F.layer_norm(a, (D,), c, d, 1e-5), (x + y, wd, bd))
        item = x.element_size()
        nbytes = 3 * R * D * item + 8 * R + 8
        flops = 8 * R * D
        b_ms, b_by = bound(nbytes, flops, "float32")  # statistics in fp32
        args = (x, y, w, b)
        row = dict(name="residual_ln", dtype=dtype_name, shape=[R, D], max_abs_err=err,
                   max_rel_err=rel, tol=TOL[("residual_ln", dtype_name)], ok=ok,
                   ms=device_ms(kernels.residual_ln, args),
                   warm_ms=device_ms(kernels.residual_ln, args, cold=False),
                   plain_ms=device_ms(kernels.residual_ln_plain, args),
                   library_ms=lib_ms, layer_norm_ms=ln_ms, bound_ms=b_ms, bound_by=b_by,
                   calls=lns.count(key), **_ln_layout(x))
        _ln_log(row)
        rows.append(row)
        details.append(row)
    return rows


# K3 beside the paths' rows, (R, D): D not a multiple of 8 (bf16 through
# shared memory), D = 1, D past the register route (8192 bf16, 4096 fp32),
# R = 1, and a view one element past an aligned start (through shared
# memory); checked, timed warm, counted 0 times
LN_EDGES = [(256, 100), (256, 1), (64, 9000), (1, 1280), ("unaligned", 1280)]


def check_residual_ln_edges(dtype_name, details):
    import torch

    from wav2letter_tpu_torch import kernels

    dtype = getattr(torch, dtype_name)
    for R, D in LN_EDGES:
        if R == "unaligned":
            R = 50
            x, y, w, b = _ln_inputs(R * D + 1, 1, dtype, D)
            x = x.view(-1)[1:].view(R, D)
            y = y.view(-1)[1:].view(R, D)
        else:
            x, y, w, b = _ln_inputs(R, D, dtype, R + D)
        got = kernels.residual_ln(x, y, w, b)
        torch.cuda.synchronize()
        err, rel, ok = _ln_compare(dtype_name, got, kernels.residual_ln_plain(x, y, w, b))
        ms = cuda_ms(lambda: kernels.residual_ln(x, y, w, b))
        b_ms, b_by = bound(3 * R * D * x.element_size() + 8 * R + 8, 8 * R * D, "float32")
        row = dict(name="residual_ln", dtype=dtype_name, shape=[R, D], max_abs_err=err,
                   max_rel_err=rel, tol=TOL[("residual_ln", dtype_name)], ok=ok, ms=ms,
                   warm_ms=ms, plain_ms=None, library_ms=None, layer_norm_ms=None,
                   bound_ms=b_ms, bound_by=b_by, calls=0, edge=True,
                   aligned=x.data_ptr() % 16 == 0, **_ln_layout(x))
        _ln_log(row)
        details.append(row)


def _conv_inputs(key, dtype):
    """x, w, bias and dy of one K2 call, seeded by its shape."""
    import torch

    from wav2letter_tpu_torch.kernels.tconv import out_frames

    B, T, Fq, C, CO, K, s, pads = key
    g = torch.Generator(device="cuda").manual_seed(T + K + C)
    x = torch.randn((B, T, Fq * C), device="cuda", generator=g).to(dtype)
    w = (0.1 * torch.randn((K, C, CO), device="cuda", generator=g)).to(dtype)
    bias = torch.randn((CO,), device="cuda", generator=g)
    Tout = out_frames(T, K, s, pads)
    dy = torch.randn((B, Tout, Fq * CO), device="cuda", generator=g).to(dtype)
    return x, w, bias, dy


def _function_errors(got, want, dtype_name):
    """Share of entries of each gradient outside the elementwise bound of
    ``FN_TOL``, and the largest error as a share of the largest entry."""
    rtol, ashare, _ = FN_TOL[dtype_name]
    out = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        top = w.abs().max().clamp(min=1e-30)
        outside = (err > ashare * top + rtol * w.abs()).float().mean().item()
        out.append((outside, (err.max() / top).item()))
    return out


def check_time_conv_backward(convs, dtype_name, details, edges=()):
    """K2 as dgrad, K2b, and the autograd function (with bias and ReLU) at
    every conv shape of one training forward, and at ``edges`` (counted 0
    times); K2b twice for equal bits."""
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    dtype = getattr(torch, dtype_name)
    rows = {"time_conv_dgrad": [], "time_conv_wgrad": []}
    for n, key in enumerate(sorted(set(convs), key=convs.index) + list(edges)):
        B, T, Fq, C, CO, K, s, pads = key
        x, w, bias, dy = _conv_inputs(key, dtype)
        Tout, item = dy.shape[1], x.element_size()
        flops = 2 * B * Tout * Fq * CO * K * C  # the products the data needs
        shape = list(key[:7]) + [list(pads)]
        # the library's calls on the stored NCHW layout, pads and layout
        # changes done before the timing
        xn = F.pad(x.view(B, T, Fq, C).permute(0, 3, 2, 1), pads).contiguous()
        dyn = dy.view(B, Tout, Fq, CO).permute(0, 3, 2, 1).contiguous()
        wn = w.permute(2, 1, 0).unsqueeze(2).contiguous()

        # dgrad; the first conv of the model takes the features and has none
        if n > 0:
            args = (dy, w, Fq, T, s, pads)
            got = kernels.time_conv_dgrad(*args)
            torch.cuda.synchronize()
            err, rel, ok = compare("time_conv_dgrad", dtype_name, got,
                                   kernels.time_conv_dgrad_plain(*args))
            lib_ms = device_ms(
                lambda a, b_: torch.nn.grad.conv2d_input(xn.shape, b_, a, stride=(1, s)),
                (dyn, wn))
            b_ms, b_by = bound(item * (dy.numel() + w.numel() + x.numel()), flops, dtype_name)
            ms = device_ms(kernels.time_conv_dgrad, args)
            rows["time_conv_dgrad"].append(dict(
                name="time_conv_dgrad", dtype=dtype_name, shape=shape, max_abs_err=err,
                max_rel_err=rel, tol=TOL[("time_conv_dgrad", dtype_name)], ok=ok,
                ms=ms, warm_ms=device_ms(kernels.time_conv_dgrad, args, cold=False),
                plain_ms=(None if key in edges
                          else device_ms(kernels.time_conv_dgrad_plain, args)),
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, calls=convs.count(key),
                tflops=flops / ms / 1e9, edge=key in edges,
                **_conv_layout(dtype, key, "dgrad", Tout)))
            _conv_log(rows["time_conv_dgrad"][-1], "K2 dgrad")

        args = (x, dy, K, Fq, s, pads)
        got = kernels.time_conv_wgrad(*args)
        torch.cuda.synchronize()
        err, rel, ok = compare("time_conv_wgrad", dtype_name, got,
                               kernels.time_conv_wgrad_plain(*args))
        ok = ok and torch.equal(got, kernels.time_conv_wgrad(*args))  # ordered sums
        lib_ms = device_ms(
            lambda a, b_: torch.nn.grad.conv2d_weight(a, wn.shape, b_, stride=(1, s)),
            (xn, dyn))
        b_ms, b_by = bound(item * (x.numel() + dy.numel()) + 4 * K * C * CO, flops, dtype_name)
        ms = device_ms(kernels.time_conv_wgrad, args)
        row = dict(
            name="time_conv_wgrad", dtype=dtype_name, shape=shape, max_abs_err=err,
            max_rel_err=rel, tol=TOL[("time_conv_wgrad", dtype_name)], ok=bool(ok),
            ms=ms, warm_ms=device_ms(kernels.time_conv_wgrad, args, cold=False),
            plain_ms=None if key in edges else device_ms(kernels.time_conv_wgrad_plain, args),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, calls=convs.count(key),
            tflops=flops / ms / 1e9, edge=key in edges, **_conv_layout(dtype, key, "wgrad", Tout))
        _conv_log(row, "K2b")

        # the whole function against autograd of the plain forward
        grads = {}
        for side, fn in (("kernel", kernels.time_conv), ("plain", kernels.time_conv_plain)):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
            out = fn(leaves[0], leaves[1], Fq, s, pads, leaves[2], True)
            grads[side] = torch.autograd.grad(out, leaves, dy)
        errs = _function_errors(grads["kernel"], grads["plain"], dtype_name)
        row["function_outside_share"] = [e[0] for e in errs]  # dx, dw, dbias
        row["function_max_err_share"] = [e[1] for e in errs]
        row["ok"] = row["ok"] and all(e[0] <= FN_TOL[dtype_name][2] for e in errs)
        rows["time_conv_wgrad"].append(row)
    for v in rows.values():
        details.extend(v)
    return {k: [r for r in v if not r["edge"]] for k, v in rows.items()}


def check_residual_ln_bwd(lns, dtype_name, details):
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    dtype = getattr(torch, dtype_name)
    rows = []
    for key in sorted(set(lns), key=lns.index):
        R, D = key
        g = torch.Generator(device="cuda").manual_seed(R + D + 1)
        x, y, dout = (torch.randn((R, D), device="cuda", generator=g).to(dtype)
                      for _ in range(3))
        w = torch.tensor([1.3], device="cuda")
        b = torch.tensor([-0.2], device="cuda")
        _, mu, rsig = kernels.residual_ln(x, y, w, b)
        args = (dout, x, y, mu, rsig, w)
        dz, row_g, row_gz = kernels.residual_ln_bwd(*args)
        torch.cuda.synchronize()
        want = kernels.residual_ln_bwd_plain(*args)
        err, rel, ok = compare("residual_ln_bwd", dtype_name, dz, want[0])
        # fp32 row sums of <= 2240 O(1) terms
        ok = ok and torch.allclose(row_g, want[1], rtol=1e-4, atol=1e-3) \
            and torch.allclose(row_gz, want[2], rtol=1e-4, atol=1e-3)
        # the library's call: autograd of layer_norm on a precomputed x + y
        z = (x + y).requires_grad_(True)
        wd = w.to(dtype).expand(D).contiguous().requires_grad_(True)
        bd = b.to(dtype).expand(D).contiguous().requires_grad_(True)
        ln_out = F.layer_norm(z, (D,), wd, bd, 1e-5)
        lib_ms = device_ms(
            lambda a: torch.autograd.grad(ln_out, (z, wd, bd), a, retain_graph=True), (dout,))
        item = x.element_size()
        b_ms, b_by = bound(4 * R * D * item + 16 * R + 4, 12 * R * D, "float32")
        row = dict(name="residual_ln_bwd", dtype=dtype_name, shape=[R, D], max_abs_err=err,
                   max_rel_err=rel, tol=TOL[("residual_ln_bwd", dtype_name)],
                   ms=device_ms(kernels.residual_ln_bwd, args),
                   warm_ms=device_ms(kernels.residual_ln_bwd, args, cold=False),
                   plain_ms=device_ms(kernels.residual_ln_bwd_plain, args),
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, calls=lns.count(key))
        # the whole function against autograd of the plain forward
        grads = {}
        for side, fn in (("kernel", kernels.residual_ln), ("plain", kernels.residual_ln_plain)):
            leaves = [t.clone().requires_grad_(True) for t in (x, y, w, b)]
            grads[side] = torch.autograd.grad(fn(*leaves)[0], leaves, dout)
        errs = _function_errors(grads["kernel"][:2], grads["plain"][:2], dtype_name)
        # dw, db: fp32 sums over R*D <= 3e7 terms of O(1) on both sides, in
        # another order; held as a share of their spread sqrt(R*D)
        scalar_tol = 1e-3 if dtype_name == "float32" else 2e-2
        scale = math.sqrt(R * D)
        scalars = [abs(float(a) - float(c)) / scale
                   for a, c in zip(grads["kernel"][2:], grads["plain"][2:])]
        row["function_outside_share"] = [e[0] for e in errs]  # dx, dy
        row["function_scalar_err"] = scalars  # dw, db over sqrt(R*D)
        row["ok"] = bool(ok) and all(e[0] <= FN_TOL[dtype_name][2] for e in errs) \
            and all(e <= scalar_tol for e in scalars)
        rows.append(row)
        details.append(row)
    return rows


def _attention_inputs(B, T, H, Dh, masked, dtype):
    """q (scaled as the model scales it), k, v, g (B, T, H*Dh), the window of
    the relative-position table and a ragged key mask, seeded by the shape."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(B * 1000 + T + Dh)
    q, k, v, dout = (0.5 * torch.randn((B, T, H * Dh), device="cuda", generator=g)
                     for _ in range(4))
    pos = 0.1 * torch.randn((2 * T - 1, Dh), device="cuda", generator=g)
    mask = torch.zeros((B, T), device="cuda")
    if masked:  # the first row full, the others 50-100% valid
        lens = torch.randint(T // 2, T + 1, (B,), device="cuda", generator=g)
        lens[0] = T
        mask = (torch.arange(T, device="cuda")[None] >= lens[:, None]).float() * -1e30
    return tuple(t.to(dtype) for t in (q, k, v, pos)) + (mask, dout.to(dtype))


def _worst(name, dtype_name, got, want):
    """Several outputs against their references: the largest absolute error,
    the largest error as a share of its output's largest entry, and whether
    every entry is within ``rtol * |want| + atol * max(1, max |want|)``: the
    gradients are sums of up to 1e5 terms whose size grows with the shape, so
    the absolute part scales with the output."""
    import torch

    rtol, atol = TOL[(name, dtype_name)]
    worst, share, ok = 0.0, 0.0, True
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        top = max(1.0, b.abs().max().item())
        worst, share = max(worst, err.max().item()), max(share, err.max().item() / top)
        ok = ok and bool(torch.all(err <= atol * top + rtol * b.abs())) \
            and bool(torch.isfinite(a).all())
    return worst, share, ok


def check_attention(shapes, dtype_name, details):
    """K4, K4b and the autograd function against their plain versions at
    every shape of ``shapes`` [(tag, B, T, H, Dh, masked, calls)], without
    dropout and at rate 0.2 (the same seed on both sides: the same keep mask);
    K4b twice for equal bits. Times at the rate the path runs the shape with:
    0 for the serving shape's forward, 0.2 for the rest. The library's call is
    ``scaled_dot_product_attention`` on pre-split heads with the relative-
    position bias and the key mask passed as ``attn_mask``, and its autograd
    for q, k, v (it has no gradient for the table)."""
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.kernels import attention
    from wav2letter_tpu_torch.kernels.attention import mhsa_flops

    dtype = getattr(torch, dtype_name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {"mhsa": [], "mhsa_bwd": []}
    for tag, B, T, H, Dh, masked, calls in shapes:
        q, k, v, pos, mask, dout = _attention_inputs(B, T, H, Dh, masked, dtype)
        errs = {"mhsa": [0.0, 0.0, True], "mhsa_bwd": [0.0, 0.0, True]}

        def note(name, res):
            e = errs[name]
            errs[name] = [max(e[0], res[0]), max(e[1], res[1]), e[2] and bool(res[2])]

        for rate in (0.0, 0.2):
            seed = 1000 + T
            got = kernels.mhsa(q, k, v, pos, mask, H, rate, seed)
            torch.cuda.synchronize()
            note("mhsa", compare("mhsa", dtype_name, got,
                                 kernels.mhsa_plain(q, k, v, pos, mask, H, rate, seed)))
            back = kernels.mhsa_bwd(q, k, v, pos, mask, dout, H, rate, seed)
            torch.cuda.synchronize()
            want = kernels.mhsa_bwd_plain(q, k, v, pos, mask, dout, H, rate, seed)
            note("mhsa_bwd", _worst("mhsa_bwd", dtype_name, back, want))
            again = kernels.mhsa_bwd(q, k, v, pos, mask, dout, H, rate, seed)
            same = all(torch.equal(a, b) for a, b in zip(back, again))  # ordered sums
            # the function: K4 + K4b under autograd against autograd of the plain forward
            grads = {}
            for side, fn in (("kernel", kernels.mhsa), ("plain", kernels.mhsa_plain)):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v, pos)]
                out = fn(*leaves, mask, H, rate, seed)
                grads[side] = torch.autograd.grad(out, leaves, dout)
            res = _worst("mhsa_bwd", dtype_name, grads["kernel"], grads["plain"])
            note("mhsa_bwd", (res[0], res[1], res[2] and same))
            del got, back, want, again, grads

        rate_f = 0.0 if tag == "serve" else 0.2
        item = q.element_size()
        qh, kh, vh = (t.view(B, T, H, Dh).transpose(1, 2).contiguous() for t in (q, k, v))
        ar = torch.arange(T, device="cuda")
        idx = (ar[None, :] - ar[:, None] + T - 1).expand(B, H, T, T)
        bias = torch.einsum("bhtd,rd->bhtr", qh.float(), pos.float()).gather(-1, idx)
        bias = (bias + mask[:, None, None, :]).to(dtype).contiguous()

        def sdpa(a, b_, c, m, rate=rate_f):
            return F.scaled_dot_product_attention(a, b_, c, attn_mask=m, dropout_p=rate,
                                                  scale=1.0)

        f_args = (q, k, v, pos, mask, H, rate_f, 7)
        nbytes = item * (4 * q.numel() + pos.numel()) + 4 * mask.numel()
        b_ms, b_by = bound(nbytes, mhsa_flops(B, T, H, Dh), dtype_name)
        e = errs["mhsa"]
        # K4's tile: the query rows a block it picks, and each height that fits, timed
        tile = attention.fwd_tile_rows(B, H, T, Dh, item, sms)
        rows_ms = {r: device_ms(lambda *a, r=r: attention._launch_fwd(*a, rows=r), f_args)
                   for r in attention.FWD_ROWS
                   if attention.fwd_smem_bytes(r, T, Dh, item) <= kernels._build.MAX_SMEM_BYTES}
        ms = device_ms(kernels.mhsa, f_args)
        rows["mhsa"].append(dict(
            name="mhsa", tag=tag, dtype=dtype_name, shape=[B, T, H, Dh], rate=rate_f,
            max_abs_err=e[0], max_rel_err=e[1], tol=TOL[("mhsa", dtype_name)], ok=e[2],
            ms=ms, warm_ms=device_ms(kernels.mhsa, f_args, cold=False),
            plain_ms=device_ms(kernels.mhsa_plain, f_args),
            library_ms=device_ms(sdpa, (qh, kh, vh, bias)),
            bound_ms=b_ms, bound_by=b_by, calls=calls, tile_rows=tile,
            blocks=-(-T // tile) * H * B, tflops=mhsa_flops(B, T, H, Dh) / ms / 1e9,
            rows_ms=rows_ms))
        log(f"[K4] {tag} {dtype_name} B={B} T={T} H={H} Dh={Dh}: {tile} rows a block, "
            f"{rows['mhsa'][-1]['blocks']} blocks, {ms:.4f} ms, "
            f"{rows['mhsa'][-1]['tflops']:.1f} TFLOP/s; by rows {rows_ms}")

        b_args = (q, k, v, pos, mask, dout, H, 0.2, 7)
        leaves = [t.requires_grad_(True) for t in (qh, kh, vh)]
        lib_out = sdpa(*leaves, bias, 0.2)
        gh = dout.view(B, T, H, Dh).transpose(1, 2).contiguous()
        nbytes = item * (7 * q.numel() + pos.numel()) + 4 * (mask.numel() + pos.numel())
        b_ms, b_by = bound(nbytes, mhsa_flops(B, T, H, Dh, backward=True), dtype_name)
        e = errs["mhsa_bwd"]
        split = k4b_split(b_args)
        # K4b's first launch at each tile height that fits, at the training row
        b_rows_ms = {r: device_ms(lambda *a, r=r: attention._launch_bwd(*a, rows=r), b_args)
                     for r in attention.BWD_ROWS if tag == "train"
                     and attention.bwd_smem_bytes(r, T, Dh, item) <= kernels._build.MAX_SMEM_BYTES}
        rows["mhsa_bwd"].append(dict(
            name="mhsa_bwd", tag=tag, dtype=dtype_name, shape=[B, T, H, Dh], rate=0.2,
            max_abs_err=e[0], max_rel_err=e[1], tol=TOL[("mhsa_bwd", dtype_name)], ok=e[2],
            ms=sum(split.values()), split_ms=split,
            warm_ms=device_ms(kernels.mhsa_bwd, b_args, cold=False),
            plain_ms=device_ms(kernels.mhsa_bwd_plain, b_args),
            library_ms=device_ms(
                lambda a: torch.autograd.grad(lib_out, leaves, a, retain_graph=True), (gh,)),
            bound_ms=b_ms, bound_by=b_by, calls=calls, rows_ms=b_rows_ms,
            tile_rows=attention.fwd_tile_rows(B, H, T, Dh, item, sms, attention.BWD_ROWS)))
        r = rows["mhsa_bwd"][-1]
        log(f"[K4b] {tag} {dtype_name} B={B} T={T} H={H} Dh={Dh}: {r['ms']:.4f} ms by launch "
            f"{json.dumps({k: round(v, 4) for k, v in split.items()})}; autograd of SDPA "
            f"{r['library_ms']:.4f} ms; {mhsa_flops(B, T, H, Dh, True) / r['ms'] / 1e9:.1f} "
            f"TFLOP/s; by rows {b_rows_ms}")
        del lib_out, leaves, bias, idx
        torch.cuda.empty_cache()
    for v_ in rows.values():
        details.extend(v_)
    return rows


def check_attention_bwd(shapes, dtype_name, details):
    """K4b alone against its plain version at shapes [(tag, B, T, H, Dh)]
    beyond the paths' (the long-context transformer's update, ragged T, the
    last T it takes, the head widths), masked, without dropout and at rate
    0.2; twice for equal bits; its time at rate 0.2 from CUDA events, warm
    (``ms``), which spares the profiler."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.kernels.attention import mhsa_flops, mhsa_takes

    dtype = getattr(torch, dtype_name)
    out = []
    for tag, B, T, H, Dh in shapes:
        if not mhsa_takes(B, T, H, Dh, dtype, backward=True):
            fail(f"K4b {tag}: mhsa_takes refuses B={B} T={T} H={H} Dh={Dh} {dtype_name}")
        q, k, v, pos, mask, dout = _attention_inputs(B, T, H, Dh, True, dtype)
        err = [0.0, 0.0, True]
        for rate in (0.0, 0.2):
            args = (q, k, v, pos, mask, dout, H, rate, 1000 + T)
            got = kernels.mhsa_bwd(*args)
            torch.cuda.synchronize()
            res = _worst("mhsa_bwd", dtype_name, got, kernels.mhsa_bwd_plain(*args))
            same = all(torch.equal(a, b) for a, b in zip(got, kernels.mhsa_bwd(*args)))
            err = [max(err[0], res[0]), max(err[1], res[1]), err[2] and res[2] and same]
            del got
            torch.cuda.empty_cache()
        ms = cuda_ms(lambda: kernels.mhsa_bwd(q, k, v, pos, mask, dout, H, 0.2, 7))
        item = q.element_size()
        nbytes = item * (7 * q.numel() + pos.numel()) + 4 * (mask.numel() + pos.numel())
        b_ms, b_by = bound(nbytes, mhsa_flops(B, T, H, Dh, backward=True), dtype_name)
        out.append(dict(name="mhsa_bwd", tag=tag, dtype=dtype_name, shape=[B, T, H, Dh],
                        rate=0.2, max_abs_err=err[0], max_rel_err=err[1],
                        tol=TOL[("mhsa_bwd", dtype_name)], ok=err[2], ms=ms, timing="events",
                        bound_ms=b_ms, bound_by=b_by, calls=0,
                        tflops=mhsa_flops(B, T, H, Dh, True) / ms / 1e9))
        log(f"[K4b] {tag} {dtype_name} B={B} T={T} H={H} Dh={Dh}: {ms:.4f} ms, "
            f"{out[-1]['tflops']:.1f} TFLOP/s, error share {err[1]:.2e}, ok {err[2]}")
        del q, k, v, pos, mask, dout
        torch.cuda.empty_cache()
    details.extend(out)
    return out


def k4b_edges(dtype_name):
    """The shapes of ``check_attention_bwd``: the long-context update, T that
    cut the tiles raggedly, the last T K4b takes at Dh = 192, head widths."""
    last = 2728 if dtype_name == "bfloat16" else 2648
    return [("long_context", 2, 1712, 4, 192), ("edge_T17", 2, 17, 4, 192),
            ("edge_T65", 2, 65, 4, 192), ("edge_T188", 2, 188, 4, 192),
            ("edge_limit", 1, last, 4, 192), ("edge_Dh8", 2, 150, 4, 8),
            ("edge_Dh64", 2, 150, 4, 64), ("edge_Dh128", 2, 150, 4, 128),
            ("edge_Dh256", 2, 150, 2, 256)]


def per_forward(rows):
    """Sum a kernel's rows over one forward, weighting each shape by its calls."""
    out = {k: 0.0 for k in ("ms", "warm_ms", "plain_ms", "bound_ms")}
    lib = 0.0 if all(r["library_ms"] is not None for r in rows) else None
    for r in rows:
        for k in out:
            out[k] += r[k] * r["calls"]
        if lib is not None:
            lib += r["library_ms"] * r["calls"]
    ops = sum(r["calls"] for r in rows if r["bound_by"] == "operations")
    out["bound_by"] = "operations" if ops * 2 > sum(r["calls"] for r in rows) else "bytes"
    out["library_ms"] = lib
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def plain_path_emissions(am, lst):
    """Per-utterance emissions of the plain-version forward on the card, on
    the batches ``run_test`` builds; also the forward times of both paths."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset
    from wav2letter_tpu_torch.features import FeatureParams, Featurizer
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.test import Evaluator

    ev = Evaluator(Config(am=am, test=lst, batchsize=BATCH), device="cuda")
    feat = Featurizer(FeatureParams.from_config(ev.cfg), ops=kernels.PLAIN).cuda()
    model = build_arch_module(ev.cfg.arch, N_FEAT, ev.n_classes, ops=kernels.PLAIN)
    model.load_state_dict(ev.model.state_dict())
    model.cuda().eval()
    ds = AsrDataset(ev.cfg.test, ev.token_dict, ev.lexicon, ev.cfg,
                    batch_size=ev.cfg.batchsize)
    out, times = {}, {"kernel_ms": [], "plain_ms": []}
    for spec in ds.batch_specs():
        batch = ds.materialize(spec)
        audio = torch.from_numpy(batch["audio"]).cuda()
        alen = torch.from_numpy(batch["audio_len"]).cuda()

        def plain():
            with torch.no_grad():
                f, fl = feat(audio, alen)
                return model(f.to(ev.dtype), fl)

        em, elen = plain()
        for i, idx in enumerate(batch["sample_idx"]):
            out[ds.samples[int(idx)].sample_id] = em[i, : int(elen[i])].float()
        times["kernel_ms"].append(cuda_ms(lambda: ev.emissions(batch), iters=5, warmup=1))
        times["plain_ms"].append(cuda_ms(plain, iters=5, warmup=1))
    return out, times, ev, ds


def main_path(spec, paths, lst, secs, emdir, n_batches):
    import numpy as np
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.runtime.test import Evaluator, evaluate

    results, evaluators = {}, {}
    # the first run pays for CUDA library set-up; it is checked, not kept
    for run, dtype_name in enumerate(("bfloat16", "bfloat16", "float32")):
        em_dir = os.path.join(emdir, spec["name"], dtype_name)
        # --batchsize is an evaluation flag: as in the JAX package, the command
        # line's value (default 1) replaces the checkpoint's
        cfg = Config(am=paths[dtype_name], test=lst, emission_dir=em_dir, batchsize=BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        # run_test(cfg) in its two parts: set-up (checkpoint load, model build,
        # copy to the card), then one pass over the list
        t0 = time.perf_counter()
        ev = Evaluator(cfg, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = evaluate(ev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        want = expected_launches(spec, 0, n_batches)
        if launches != want:
            fail(f"{spec['name']} {dtype_name} main path launches {launches}, expected {want}")
        if run == 0:
            log(f"[main {spec['name']} warm-up {dtype_name}] {t2 - t0:.3f} s, "
                f"launches {launches}")
            continue
        # steady state: more passes of the loaded model over the same list,
        # without the optional emission dumps
        ev.cfg.update({"emission_dir": ""})
        t3 = time.perf_counter()
        for _ in range(PASSES):
            evaluate(ev)
        torch.cuda.synchronize()
        pass_s = (time.perf_counter() - t3) / PASSES
        ref, times, ev, ds = plain_path_emissions(paths[dtype_name], lst)
        evaluators[dtype_name] = (ev, ds)
        errs, n_frames = [], 0
        for sid, want_em in ref.items():
            got = torch.from_numpy(np.load(os.path.join(em_dir, f"{sid}.npz"))["emission"])
            got = got.cuda()
            if got.shape != want_em.shape or got.shape[1] != N_TOKENS + 1:
                fail(f"{dtype_name} {sid}: emissions {tuple(got.shape)} vs "
                     f"{tuple(want_em.shape)}")
            if not torch.isfinite(got).all():
                fail(f"{dtype_name} {sid}: non-finite emissions")
            errs.append((got - want_em).abs())
            n_frames += got.shape[0]
        err = torch.cat([e.flatten() for e in errs])
        max_err, mean_err = err.max().item(), err.mean().item()
        tol = EM_TOL[dtype_name]
        ok = max_err <= tol[0] and mean_err <= tol[1]
        results[dtype_name] = dict(
            utterances=len(ref), audio_s=secs, setup_s=t1 - t0, first_pass_s=t2 - t1,
            steady_pass_s=pass_s, steady_passes=PASSES, steady_x_real_time=secs / pass_s,
            TER=res["TER"], WER=res["WER"],
            loss=res["loss"], peak_mem_gib=peak / 2**30, launches=launches,
            em_frames=n_frames, em_max_abs_err=max_err, em_mean_abs_err=mean_err,
            em_tol=tol, forward_kernel_ms=times["kernel_ms"],
            forward_plain_ms=times["plain_ms"], ok=ok)
        log(f"[main {spec['name']} {dtype_name}] {json.dumps(results[dtype_name])}")
        if not ok:
            fail(f"{spec['name']} {dtype_name} emissions differ from the plain path: max {max_err} mean "
                 f"{mean_err} (tolerance {tol})")
    return (results, *evaluators["bfloat16"])


def profile_forward(ev, ds):
    """Device time by kernel over one bf16 forward of the largest batch."""
    import torch

    spec = max(ds.batch_specs(), key=lambda s: s.max_input_frames)
    batch = ds.materialize(spec)
    ev.emissions(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev.emissions(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3  # without the profiler's overhead
    prof = profile_device(lambda: ev.emissions(batch))
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in device_events(prof)), reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(dtype=str(ev.dtype), batch=[len(spec.indices), spec.max_input_frames],
                wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
                top=[dict(ms=round(ms, 4), kernel=k[:90], count=c) for ms, k, c in rows[:14]])


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------
def train_flags(spec, lst, valid_lst, tokens, lexicon, rundir, dtype_name, n_updates):
    return dict(
        train=lst, valid=f"dev:{valid_lst}", tokens=tokens, lexicon=lexicon, rundir=rundir,
        runname=f"{spec['name']}_{dtype_name}", arch=spec["arch"], criterion="ctc", mfsc=True,
        filterbanks=N_FEAT, compute_dtype=dtype_name, validbatchsize=BATCH, nthread=2,
        onorm="target", sqnorm=True, iter=n_updates, reportiters=n_updates, seed=0,
        **spec["flags"], **spec["train"])


def expected_launches(spec, updates, valid_batches):
    """Launches of ``updates`` updates and ``valid_batches`` validation or
    serving forwards, as ``spec``'s arch implies them (flagship: per update 1
    K1, 15 K2 forward + 14 as dgrad, 15 K2b, 22 K3, 22 K3b; transformer: 1 K1,
    12 K4, 12 K4b, 24 K3, 24 K3b). Viterbi launches no kernel of ours."""
    from wav2letter_tpu_torch.kernels import LAUNCHES

    return {k: spec["per_forward"].get(k, 0) * (updates + valid_batches)
            + spec["per_backward"].get(k, 0) * updates for k in LAUNCHES}


def first_batch_gradients(spec, cfg_flags, dtype_name):
    """Loss and parameter gradients of the first training batch with dropout
    and SpecAugment off (the modules in eval mode, autograd on), same weights:
    the kernel path against the plain-version model on the same features (K1's),
    and against the whole plain path, features included."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.features import FeatureParams, Featurizer
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.train import Trainer

    cfg = Config()
    cfg.update(dict(cfg_flags, rundir="", runname=""))
    tr = Trainer(cfg, device="cuda")
    first = tr.train_ds.batch_specs(shuffle_seed=cfg.seed + 1)[0]
    batch = tr._to_device(pad_batch_rows(tr.train_ds.materialize(first), 1))
    plain = build_arch_module(spec["arch"], N_FEAT, tr.n_classes, ops=kernels.PLAIN)
    plain.load_state_dict(tr.model.state_dict())
    plain.cuda()
    with torch.no_grad():
        k1_feats = tr.featurizer(batch["audio"], batch["audio_len"])
    sides = {
        "kernel": (tr.model, tr.featurizer),
        "plain_model": (plain, lambda audio, audio_len: k1_feats),
        "plain_path": (plain, Featurizer(FeatureParams.from_config(cfg),
                                         ops=kernels.PLAIN).cuda()),
    }
    out = {}
    for side, (tr.model, tr.featurizer) in sides.items():
        tr.model.eval()
        for p in tr.model.parameters():
            p.grad = None
        kernels.reset_launches()
        loss, _, _ = tr._loss(batch, train=False)
        loss.backward()
        torch.cuda.synchronize()
        out[side] = (loss.item(), {k: p.grad for k, p in tr.model.named_parameters()},
                     dict(kernels.LAUNCHES))
    kl, kg, klaunch = out["kernel"]
    want = expected_launches(spec, 1, 0)
    if klaunch != want or any(out["plain_path"][2].values()):
        fail(f"{spec['name']} {dtype_name} first-batch launches {klaunch} (kernel path), "
             f"{out['plain_path'][2]} (plain path), expected {want} and none")
    # (a bias on the keys shifts every score of a row alike: softmax does not
    # see it and its gradient is rounding, possibly exactly 0)
    zero = [k for k, g in kg.items()
            if g is None or not torch.isfinite(g).all()
            or not (g.abs().max() > 0 or k.endswith("attn.wk.bias"))]
    if zero:
        fail(f"{dtype_name}: parameters without a finite, non-zero gradient: {zero}")
    res = dict(loss_kernel=kl, n_params=len(kg), launches=klaunch, ok=math.isfinite(kl))
    for side, tols in (("plain_model", GRAD_TOL), ("plain_path", GRAD_TOL_FEATS)):
        pl, pg, _ = out[side]
        # A leaf's error is held against its own norm, but not against less
        # than 1% of the whole gradient's: the LayerNorm biases inside a TDS
        # block are followed by another LayerNorm, which takes a constant shift
        # out again, so their true gradient is ~0 and what is left is rounding
        # of either path.
        total = torch.sqrt(sum(g.float().pow(2).sum() for g in pg.values())).item()
        diff = torch.sqrt(sum((kg[k] - pg[k]).float().pow(2).sum() for k in pg)).item()
        leaves = sorted(((kg[k] - g).norm().item() / max(g.norm().item(), 0.01 * total), k)
                        for k, g in pg.items())[::-1]
        loss_tol, grad_tol = tols[dtype_name]
        cmp = dict(loss=pl, loss_rel_err=abs(kl - pl) / abs(pl), grad_norm=total,
                   grad_rel_l2=diff / total,
                   worst_leaves=[dict(name=k, rel_l2=r) for r, k in leaves[:3]],
                   tol=[loss_tol, grad_tol])
        cmp["ok"] = bool(cmp["loss_rel_err"] <= loss_tol and leaves[0][0] <= grad_tol)
        res[side] = cmp
        res["ok"] = res["ok"] and cmp["ok"]
    log(f"[train grads {spec['name']} {dtype_name}] {json.dumps(res)}")
    if not res["ok"]:
        fail(f"{spec['name']} {dtype_name} first-batch loss or gradients differ from the plain path")
    return res


class _ProfiledPhase:
    """Wraps a phase of ``Trainer.train_step`` in a profiler of its own and
    adds the device time of the kernels it saw to ``busy[name]``."""

    def __init__(self, phase, name, busy):
        from torch.profiler import ProfilerActivity, profile

        self.phase, self.name, self.busy = phase, name, busy
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        self.phase.__enter__()

    def __exit__(self, *exc):
        self.phase.__exit__(*exc)  # drains the device: the trainer's timers are synced
        self.prof.__exit__(*exc)
        ms = sum(e.self_device_time_total for e in device_events(self.prof)) / 1e3
        self.busy[self.name] = self.busy.get(self.name, 0.0) + ms


def profile_update(tr, batch):
    """More updates of a trained ``Trainer`` on ``batch`` at learning rate 0:
    one with the device drained at the phase boundaries, for the split by phase
    (host clock around drained work, and device time of each phase's kernels
    from one profiler per phase); one free-running for the wall time; one
    free-running under the profiler for device busy time, idle share and the
    kernels by device time."""
    import torch

    args = (batch, 0.0, 0.0, False, 12345)
    tr.train_step(*args)
    tr.meters.reset_train()
    busy, timed = {}, tr._timed
    tr._timed = lambda timer, name: _ProfiledPhase(timed(timer, name), name[4:], busy)
    tr.sync_timers = True
    tr.train_step(*args)
    tr.sync_timers = False
    tr._timed = timed
    m = tr.meters
    host = {"forward": m.fwd_timer.avg_ms(), "criterion": m.crit_fwd_timer.avg_ms(),
            "backward": m.bwd_timer.avg_ms(), "optimizer": m.optim_timer.avg_ms()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_step(*args)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_device(lambda: tr.train_step(*args))
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in device_events(prof)), reverse=True)
    total = sum(r[0] for r in rows)
    return dict(dtype=str(tr.compute_dtype), batch=list(batch["audio"].shape),
                drained_ms_by_phase=host, device_ms_by_phase=busy, wall_ms=wall_ms,
                device_busy_ms=total, idle_share=1 - total / wall_ms,
                top=[dict(ms=round(ms, 4), kernel=k[:90], count=c) for ms, k, c in rows[:16]])


def training_path(spec, tmp, train_lst, serve_lst, tokens, lexicon, valid_batches):
    """The trainer at full width on ``spec``'s arch, bf16 then fp32;
    ``continue``; ``run_test``."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.train import main as train_main
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint
    from wav2letter_tpu_torch.runtime.test import run_test
    from wav2letter_tpu_torch.runtime.train import Trainer

    rundir = os.path.join(tmp, "runs")
    results = {}
    for dtype_name, n_updates in TRAIN_UPDATES.items():
        flags = train_flags(spec, train_lst, serve_lst, tokens, lexicon, rundir, dtype_name,
                            n_updates)
        runname = flags["runname"]
        grads = first_batch_gradients(spec, flags, dtype_name)
        cfg = Config()
        cfg.update(flags)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(cfg, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        steps, step = [], tr.train_step

        def timed_step(batch, *a):
            # launches of this update alone; the time between the ends of two
            # updates is one whole iteration (data, update, viterbi, meters)
            before = dict(kernels.LAUNCHES)
            res = step(batch, *a)
            torch.cuda.synchronize()
            steps.append(dict(
                end=time.perf_counter(), loss=res[0], finite=res[1],
                audio_s=float(batch["audio_len"].sum()) / 16000,
                frames=int(batch["audio"].shape[1]),
                launches={k: v - before[k] for k, v in kernels.LAUNCHES.items()}))
            return res

        tr.train_step = timed_step
        kernels.reset_launches()
        tr.run()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        want = expected_launches(spec, n_updates, valid_batches)
        if launches != want:
            fail(f"{runname} training launches {launches}, expected {want}")
        per_update = expected_launches(spec, 1, 0)
        bad = [s for s in steps if s["launches"] != per_update or not s["finite"]
               or not math.isfinite(s["loss"])]
        if len(steps) != n_updates or bad:
            fail(f"{runname} training: {len(steps)} updates, faulty: {bad[:2]}")
        # (not gated for the flagship, whose SAUG line blanks nearly every cell)
        if spec.get("loss_falls") and not steps[-1]["loss"] < steps[0]["loss"]:
            fail(f"{runname}: the loss did not fall: {[s['loss'] for s in steps]}")
        last = os.path.join(rundir, runname, "model_last.bin")
        ckpt = load_checkpoint(last)
        if ckpt.updates != n_updates or not ckpt.opt_state["state"][spec["opt_slot"]]:
            fail(f"{runname}: model_last.bin holds update {ckpt.updates}")
        span = steps[-1]["end"] - steps[0]["end"]  # steady state: after the first update
        steady_audio = sum(s["audio_s"] for s in steps[1:])
        res = dict(
            updates=n_updates, batch=spec["train"]["batchsize"], setup_s=setup_s,
            losses=[s["loss"] for s in steps], frames=[s["frames"] for s in steps],
            iteration_s=[b["end"] - a["end"] for a, b in zip(steps, steps[1:])],
            updates_per_s=(n_updates - 1) / span, audio_s_per_s=steady_audio / span,
            s_per_update=span / (n_updates - 1), peak_mem_gib=peak / 2**30,
            launches=launches, launches_per_update=per_update, first_batch=grads)
        tr.train_step = step
        largest = max(tr.train_ds.batch_specs(), key=lambda s: s.max_input_frames)
        res["profile"] = profile_update(tr, pad_batch_rows(tr.train_ds.materialize(largest), 1))
        results[dtype_name] = res
        log(f"[train {runname}] {json.dumps(res)}")
        del tr
        torch.cuda.empty_cache()

    # continue: 2 more bf16 updates from model_last.bin, through the command line's main
    n0 = TRAIN_UPDATES["bfloat16"]
    kernels.reset_launches()
    runname = f"{spec['name']}_bfloat16"
    tr = train_main(["continue", f"--rundir={rundir}", f"--runname={runname}",
                     f"--iter={n0 + CONTINUE_UPDATES}", f"--reportiters={n0 + CONTINUE_UPDATES}"])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = expected_launches(spec, CONTINUE_UPDATES, valid_batches)
    last = os.path.join(rundir, runname, "model_last.bin")
    ckpt = load_checkpoint(last)
    if (tr.updates, ckpt.updates, tr.run_idx) != (n0 + CONTINUE_UPDATES,) * 2 + (2,) \
            or launches != want or tr.skipped:
        fail(f"continue ended at update {tr.updates} (checkpoint {ckpt.updates}, run index "
             f"{tr.run_idx}, skipped {tr.skipped}), launches {launches}, expected {want}")
    del tr
    torch.cuda.empty_cache()

    # slice 1's test binary serves the trained checkpoint
    kernels.reset_launches()
    served = run_test(Config(am=last, test=serve_lst, batchsize=BATCH), device="cuda")
    launches = dict(kernels.LAUNCHES)
    want = expected_launches(spec, 0, valid_batches)
    if launches != want or not math.isfinite(served["loss"]):
        fail(f"run_test on the trained checkpoint: {served}, launches {launches}")
    results["continue"] = dict(updates=ckpt.updates, launches=launches)
    results["served"] = served
    log(f"[train {spec['name']} continue+serve] updates {ckpt.updates}, served {json.dumps(served)}")
    return results


# ---------------------------------------------------------------------------
# the conformer: a short phase at full width
# ---------------------------------------------------------------------------
def conformer_path(tmp, tokens, lexicon, seed):
    """``recipes/conformer_ctc`` at full width and ``CFR_LAYERS`` of its 16
    layers. 8 utterances of 4-6.3 s (batches are padded to a multiple of 128
    feature frames, so at most 640, which the stride-3 conv takes to 214,
    within the arch's 240 relative positions): two bf16 updates and a
    validation pass through ``Trainer`` with K4 and K4b launched once per
    layer, then emissions of the kernel path against the plain path. A batch
    of 15 s utterances (500 frames) is beyond the table: attention takes the
    unfused PyTorch path, K4 is launched no time, and both paths agree."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.train import Trainer

    with open(CFR_ARCH) as f:
        lines = [l for l in f.read().splitlines() if l.strip() and not l.startswith("#")]
    layers = [l for l in lines if l.startswith("CFR")]
    arch = os.path.join(tmp, "conformer_cut.arch")
    with open(arch, "w") as f:
        f.write("\n".join([l for l in lines if not l.startswith("CFR")][:-1]
                          + layers[:CFR_LAYERS] + [lines[-1]]) + "\n")
    root = os.path.join(tmp, "data")
    lst, _, _, secs = synth_dataset(root, seed + 2, 8, "cfr", (tokens, lexicon), (4.0, 6.3))
    long_lst, _, _, _ = synth_dataset(root, seed + 3, 4, "cfrlong", (tokens, lexicon),
                                      (14.9, 15.0))
    spec = dict(name="conformer", arch=arch, flags={},
                per_forward={"mfsc": 1, "mhsa": CFR_LAYERS},
                per_backward={"mhsa_bwd": CFR_LAYERS},
                train=dict(batchsize=8, netoptim="adam", lr=5e-4, warmup=2,
                           lr_sched="inv_sqrt", lr_step_decay=20000, maxgradnorm=0.5))
    cfg = Config()
    cfg.update(train_flags(spec, lst, lst, tokens, lexicon, os.path.join(tmp, "runs"),
                           "bfloat16", 2))
    tr = Trainer(cfg, device="cuda")
    n_params = sum(p.numel() for p in tr.model.parameters())
    losses, step = [], tr.train_step

    def recording(*a):
        res = step(*a)
        losses.append(res[0])
        return res

    tr.train_step = recording
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = expected_launches(spec, 2, 2)  # 8 utterances validate as 2 batches of 4
    if launches != want or len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        fail(f"conformer: launches {launches}, expected {want}; losses {losses}")

    plain = build_arch_module(arch, N_FEAT, tr.n_classes, ops=kernels.PLAIN)
    plain.load_state_dict(tr.model.state_dict())
    plain.cuda().eval()
    tr.model.eval()
    out = {}
    for name, path, fused in (("short", lst, True), ("long", long_lst, False)):
        cfg_l = Config()
        cfg_l.update(dict(cfg.asdict(), train=path, batchsize=4))
        ds = AsrDataset(path, tr.token_dict, tr.lexicon, cfg_l, batch_size=4)
        spec_b = max(ds.batch_specs(), key=lambda b: b.max_input_frames)
        b = tr._to_device(pad_batch_rows(ds.materialize(spec_b), 1))
        res = {}
        for dtype in (torch.bfloat16, torch.float32):
            with torch.no_grad():
                feats, flen = tr.featurizer(b["audio"], b["audio_len"])
                kernels.reset_launches()
                got, glen = tr.model(feats.to(dtype), flen)
                n_k4 = kernels.LAUNCHES["mhsa"]
                ref, _ = plain(feats.to(dtype), flen)
            torch.cuda.synchronize()
            if n_k4 != (CFR_LAYERS if fused else 0):
                fail(f"conformer {name}: {n_k4} K4 launches at {got.shape[1]} frames")
            err = (got.float() - ref.float()).abs()
            dt = str(dtype).split(".")[1]
            tol = EM_TOL[dt]
            res[dt] = dict(frames=int(got.shape[1]), k4_launches=n_k4,
                           em_max_abs_err=err.max().item(), em_mean_abs_err=err.mean().item(),
                           tol=tol)
            if not (torch.isfinite(got).all() and err.max().item() <= tol[0]
                    and err.mean().item() <= tol[1]):
                fail(f"conformer {name} {dt}: emissions differ from the plain path: {res[dt]}")
        out[name] = res
    result = dict(layers=CFR_LAYERS, n_params=n_params, audio_s=secs, losses=losses,
                  run_s=run_s, launches=launches, **out)
    log(f"[conformer] {json.dumps(result)}")
    return result


def long_context_path(tmp, tokens, lexicon, seed):
    """``recipes/transformer_ctc`` at full width, ``LONG_LAYERS`` of its 12
    layers, with a relative-position table of ``LONG_BPTT`` frames: two
    utterances of 134-136 s give T = 1680-1712 after the pools, inside the
    table and inside K4b's limit (K4's: T <= 2728 in bf16 at Dh = 192). One
    bf16 update through ``Trainer`` launches K4 and K4b once per layer, its
    validation pass K4 once per layer; emissions of the kernel path against
    the plain path."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.train import Trainer

    with open(TR_ARCH) as f:
        lines = [l for l in f.read().splitlines() if l.strip() and not l.startswith("#")]
    layers = [l.split() for l in lines if l.startswith("TR")][:LONG_LAYERS]
    for fields in layers:
        fields[4] = str(LONG_BPTT)
    arch = os.path.join(tmp, "transformer_long.arch")
    with open(arch, "w") as f:
        f.write("\n".join([l for l in lines if not l.startswith("TR")][:-1]
                          + [" ".join(x) for x in layers] + [lines[-1]]) + "\n")
    root = os.path.join(tmp, "data")
    lst, _, _, secs = synth_dataset(root, seed + 4, 2, "long", (tokens, lexicon), (134.0, 136.0))
    spec = dict(name="long_context", arch=arch, flags={},
                per_forward={"mfsc": 1, "mhsa": LONG_LAYERS, "residual_ln": 2 * LONG_LAYERS},
                per_backward={"mhsa_bwd": LONG_LAYERS, "residual_ln_bwd": 2 * LONG_LAYERS},
                train=dict(batchsize=2, netoptim="adam", lr=5e-4, warmup=2,
                           lr_sched="inv_sqrt", lr_step_decay=20000, maxgradnorm=0.1))
    cfg = Config()
    cfg.update(train_flags(spec, lst, lst, tokens, lexicon, os.path.join(tmp, "runs"),
                           "bfloat16", 1))
    tr = Trainer(cfg, device="cuda")
    losses, step = [], tr.train_step

    def recording(*a):
        res = step(*a)
        losses.append(res[0])
        return res

    tr.train_step = recording
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = expected_launches(spec, 1, 1)
    if launches != want or len(losses) != 1 or not math.isfinite(losses[0]):
        fail(f"long context: launches {launches}, expected {want}; losses {losses}")

    plain = build_arch_module(arch, N_FEAT, tr.n_classes, ops=kernels.PLAIN)
    plain.load_state_dict(tr.model.state_dict())
    plain.cuda().eval()
    tr.model.eval()
    cfg_l = Config()
    cfg_l.update(dict(cfg.asdict(), batchsize=2))
    ds = AsrDataset(lst, tr.token_dict, tr.lexicon, cfg_l, batch_size=2)
    b = tr._to_device(pad_batch_rows(ds.materialize(ds.batch_specs()[0]), 1))
    with torch.no_grad():
        feats, flen = tr.featurizer(b["audio"], b["audio_len"])
        kernels.reset_launches()
        got, _ = tr.model(feats.to(torch.bfloat16), flen)
        n_k4 = kernels.LAUNCHES["mhsa"]
        ref, _ = plain(feats.to(torch.bfloat16), flen)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    tol = EM_TOL["bfloat16"]
    result = dict(layers=LONG_LAYERS, bptt=LONG_BPTT, audio_s=secs, frames=int(got.shape[1]),
                  loss=losses[0], run_s=run_s, launches=launches, serve_k4_launches=n_k4,
                  em_max_abs_err=err.max().item(), em_mean_abs_err=err.mean().item(), tol=tol)
    log(f"[long context] {json.dumps(result)}")
    if not (torch.isfinite(got).all() and n_k4 == LONG_LAYERS and got.shape[1] >= 1680
            and err.max().item() <= tol[0] and err.mean().item() <= tol[1]):
        fail(f"long context: serving at T >= 1680 through K4: {result}")
    return result



# ---------------------------------------------------------------------------
# phase 10: the lexicon beam decode
# ---------------------------------------------------------------------------
DECODE_K = 100  # --beamsizetoken: the top-k the producer ships of 9998 classes
DECODE_FLAGS = [f"--batchsize={BATCH}", "--beamsize=100", f"--beamsizetoken={DECODE_K}",
                "--beamthreshold=25", "--lmweight=1", "--wordscore=0.5", "--smearing=max",
                "--nthread_decoder=2"]
PY_BEAM = 20  # the Python beam's width on the two shortest utterances


def read_hyps(sclite_dir, lst):
    """{sample id: hypothesis words} of a decode's sclite ``.hyp``."""
    with open(os.path.join(sclite_dir, os.path.basename(lst) + ".hyp")) as f:
        rows = [l.rsplit(" (", 1) for l in f.read().splitlines()]
    return {sid.rstrip(")"): words.split() for words, sid in rows}


def decode_path(paths, lst, secs, tmp, n_batches, smi_line):
    """The flagship through ``cli.decode`` (``W2L_REQUIRE_NATIVE=1``) with a
    3-gram ARPA of the list's transcripts, per type: (A) the top-k-shipped
    decode, timed; (B) the full-row decode that fills ``--emission_dir``;
    (C) the probing ``.bin`` of the LM over that cache. Checks the launches of
    A and B (1 K1, 15 K2, 22 K3 per batch, none in C), the decoder's class,
    B's emissions against the plain-version forward, C's words against B's,
    A's words against the decode of B's rows cut to their top k on the host
    on every utterance without a tie at the k-th value, and the native beam's
    words against the Python beam's on the two shortest utterances."""
    import numpy as np
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.decode import main as decode_main
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.decoder.native import NativeBeamDecoder
    from wav2letter_tpu_torch.runtime.decode import build_decoder, result_to_words, sparse_rows
    from wav2letter_tpu_torch.tools.ngram_lm import build_binary, train_ngram_lm

    t_phase = time.perf_counter()
    os.environ["W2L_REQUIRE_NATIVE"] = "1"
    root = os.path.join(tmp, "decode")
    os.makedirs(root, exist_ok=True)
    corpus = os.path.join(root, "corpus.txt")
    with open(lst) as f, open(corpus, "w") as out:
        out.writelines(" ".join(line.split()[3:]) + "\n" for line in f)
    arpa = os.path.join(root, "lm.arpa")
    t0 = time.perf_counter()
    train_ngram_lm(corpus, arpa, order=3)
    lm_bin = build_binary(arpa, os.path.join(root, "lm.bin"))  # builds decoder.cpp
    prep_s = time.perf_counter() - t0
    serve = expected_launches(FLAGSHIP, 0, n_batches)
    results = {}
    for dt in ("bfloat16", "float32"):
        d = os.path.join(root, dt)
        em_dir = os.path.join(d, "em")
        base = [f"--am={paths[dt]}", f"--test={lst}", *DECODE_FLAGS]
        runs = {}
        for name, extra, want in (
                ("topk", [f"--lm={arpa}"], serve),
                ("full", [f"--lm={arpa}", f"--emission_dir={em_dir}"], serve),
                ("bin", [f"--lm={lm_bin}", f"--emission_dir={em_dir}"],
                 {k: 0 for k in serve})):
            torch.cuda.synchronize()
            kernels.reset_launches()
            res = decode_main(base + extra + [f"--sclite={os.path.join(d, name)}"])
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            if launches != want:
                fail(f"decode {dt} {name}: launches {launches}, expected {want}")
            if res["decoder"] != "NativeBeamDecoder":
                fail(f"decode {dt} {name}: the beam ran on {res['decoder']}")
            runs[name] = dict(res, launches=launches,
                              hyps=read_hyps(os.path.join(d, name), lst))
        if runs["bin"]["hyps"] != runs["full"]["hyps"]:
            fail(f"decode {dt}: the .bin LM decodes otherwise than the ARPA")
        # B's emissions against the plain-version forward on the card
        ref, _, ev, ds = plain_path_emissions(paths[dt], lst)
        ems, err_max, err_sum, n = {}, 0.0, 0.0, 0
        for sid, want_em in ref.items():
            got = np.load(os.path.join(em_dir, f"{sid}.npz"))["emission"]
            if got.shape != tuple(want_em.shape) or not np.isfinite(got).all():
                fail(f"decode {dt} {sid}: emissions {got.shape} vs {tuple(want_em.shape)}")
            e = (torch.from_numpy(got).cuda() - want_em).abs()
            err_max, err_sum, n = max(err_max, e.max().item()), err_sum + e.sum().item(), \
                n + e.numel()
            ems[sid] = got
        tol = EM_TOL[dt]
        if err_max > tol[0] or err_sum / n > tol[1]:
            fail(f"decode {dt}: emissions differ from the plain path: max {err_max} "
                 f"mean {err_sum / n} (tolerance {tol})")
        # device time of the top-k forward, summed over the list's batches
        fwd_ms = 0.0
        for spec in ds.batch_specs():
            batch = ds.materialize(spec)
            ev.emissions_topk(batch, DECODE_K)
            prof = profile_device(lambda: ev.emissions_topk(batch, DECODE_K))
            fwd_ms += sum(e.self_device_time_total for e in device_events(prof)) / 1e3
        # the top-k cut against the full rows, utterance by utterance
        cfg = Config()
        cfg.update(ev.cfg.asdict())
        cfg.update(dict(lm=arpa, beamsize=100, beamsizetoken=DECODE_K, beamthreshold=25.0,
                        lmweight=1.0, wordscore=0.5, smearing="max"))
        dec, word_dict = build_decoder(cfg, ev.token_dict, ev.lexicon)
        if not isinstance(dec, NativeBeamDecoder):
            fail(f"decode {dt}: build_decoder gave {type(dec).__name__}")
        blank, sep = ev.n_classes - 1, ev.token_dict.get_index(cfg.wordseparator)
        per_utt, bad = {}, []
        for sid, e in ems.items():
            top = -np.partition(-e, DECODE_K, axis=1)[:, :DECODE_K + 1]
            top.sort(axis=1)
            kth, next_ = top[:, 1], top[:, 0]  # the k-th and (k+1)-th largest
            vals, idx = torch.topk(torch.from_numpy(e), DECODE_K, dim=-1)
            cut = sparse_rows(vals.numpy(), idx.to(torch.int32).numpy(), ev.n_classes)
            words = result_to_words(dec.decode(cut)[0], word_dict, ev.token_dict, cfg,
                                    ev.n_classes)
            row = dict(frames=len(e), tied_frames=int((kth == next_).sum()),
                       blank_outside_k=int((e[:, blank] < kth).sum()),
                       separator_outside_k=int((e[:, sep] < kth).sum()),
                       topk_equals_host_cut=words == runs["topk"]["hyps"][sid],
                       topk_equals_full=runs["topk"]["hyps"][sid] == runs["full"]["hyps"][sid])
            per_utt[sid] = row
            if row["tied_frames"] == 0 and not row["topk_equals_host_cut"]:
                bad.append(sid)
        if bad:
            fail(f"decode {dt}: the shipped top-k decodes otherwise than the host's cut "
                 f"on {bad}, which tie at no k-th value")
        # the native beam against the Python beam at width PY_BEAM
        cfg.update(dict(beamsize=PY_BEAM))
        nat, _ = build_decoder(cfg, ev.token_dict, ev.lexicon)
        py, _ = build_decoder(cfg, ev.token_dict, ev.lexicon, use_native=False)
        py_rows = []
        for sid in sorted(ems, key=lambda k: len(ems[k]))[:2]:
            t0 = time.perf_counter()
            rn = nat.decode(ems[sid])[0]
            t1 = time.perf_counter()
            rp = py.decode(ems[sid])[0]
            t2 = time.perf_counter()
            wn, wp = (result_to_words(r, word_dict, ev.token_dict, cfg, ev.n_classes)
                      for r in (rn, rp))
            py_rows.append(dict(sid=sid, frames=len(ems[sid]), words=len(wn),
                                score_diff=abs(rn.score - rp.score), native_s=t1 - t0,
                                python_s=t2 - t1))
            if wn != wp or abs(rn.score - rp.score) > 1e-3 * max(1.0, abs(rp.score)):
                fail(f"decode {dt} {sid}: native {wn} ({rn.score}) vs Python {wp} "
                     f"({rp.score})")
        del ev, ds, ref, dec, nat, py
        torch.cuda.empty_cache()
        a = runs["topk"]
        decode_s = a["wall_s"] - a["setup_s"]
        results[dt] = dict(
            utterances=len(ems), audio_s=secs, lm_prep_s=prep_s,
            decode_s=decode_s, audio_s_per_wall_s=secs / decode_s,
            setup_s=a["setup_s"], forward_host_s=a["forward_s"],
            forward_device_ms=fwd_ms, beam_host_s=a["beam_s"],
            WER={k: r["WER"] for k, r in runs.items()},
            launches=a["launches"], em_max_abs_err=err_max, em_mean_abs_err=err_sum / n,
            em_tol=tol, tied_frames=sum(r["tied_frames"] for r in per_utt.values()),
            frames=sum(r["frames"] for r in per_utt.values()),
            utterances_without_tie=sum(r["tied_frames"] == 0 for r in per_utt.values()),
            blank_outside_k=sum(r["blank_outside_k"] for r in per_utt.values()),
            separator_outside_k=sum(r["separator_outside_k"] for r in per_utt.values()),
            topk_equals_full=sum(r["topk_equals_full"] for r in per_utt.values()),
            per_utterance=per_utt, python_beam=py_rows)
        log(f"[decode flagship {dt}] {json.dumps(results[dt])}")
        log(f"[decode rate] {dt}: {secs / decode_s:.1f} audio s per wall s "
            f"(forward {fwd_ms:.2f} ms device, {a['forward_s']:.3f} s host; beam "
            f"{a['beam_s']:.3f} s host over 2 threads) | {smi_line}")
    results["phase_s"] = time.perf_counter() - t_phase
    log(f"[decode] phase 10 in {results['phase_s']:.1f} s")
    return results

# ---------------------------------------------------------------------------
# phase 11: chunked streaming inference
# ---------------------------------------------------------------------------
STREAM_CHUNK = 8000  # samples, 500 ms at 16 kHz
STREAM_LOOK_BACK = 25  # frames: cli.streaming_asr's prune(look_back=250 ms / 10 ms)
STREAM_DECODER = {"beamSize": 100, "beamSizeToken": DECODE_K, "beamThreshold": 25,
                  "lmWeight": 1.0, "wordScore": 0.5}
STREAM_MULTI = 4  # utterances (the shortest) and threads of cli.streaming_asr_multi
STREAM_EM_TOL = 1e-4  # max |streamed - batch| emissions (tests/test_streaming.py)
# max |streamed - batch| features (tests/test_streaming.py), on every frame,
# against the batch featurizer's K1 on the whole utterance with its local CMVN
# in float64, as the stream's. The batch featurizer's own fp32 CMVN is not the
# yardstick: its fp32 E[x^2] - E[x]^2 cancels in short or steady windows
# (ROADMAP.md queue 3), so its distance is reported beside, not held
STREAM_FEAT_TOL = 2e-3


def stream_launches(layers, frames, n_in, start=0):
    """(K2, K3, calls) of pushing ``n_in`` frames into layer ``start`` of a
    stream whose layers hold ``frames`` frames of state (updated in place):
    one K2 for each time-only conv and each TDS block that emits frames (by
    its ``out_frames``), two K3 for each such block; ``calls`` lists their
    shapes, [("time_conv", (B, T, F, C, CO, K, stride, pads))] and
    [("residual_ln", (R, D))]."""
    from wav2letter_tpu_torch.inference.streaming import StreamConv, StreamTDS

    k2 = k3 = 0
    calls, n = [], n_in
    for i in range(start, len(layers)):
        layer = layers[i]
        if not isinstance(layer, (StreamConv, StreamTDS)):
            continue
        m = frames[i] + n
        n, frames[i] = layer.out_frames(frames[i], n)
        tds = isinstance(layer, StreamTDS)
        if n and (tds or layer.module.time_only):
            k2 += 1
            mod = layer.module
            if tds:
                k3 += 2
                calls += [("time_conv", (1, m, mod.f, mod.c, mod.c, mod.w, 1, (0, 0))),
                          ("residual_ln", (n, mod.c * mod.f))]
            else:
                calls.append(("time_conv", (1, m, layer.freq_dim, mod.in_ch, mod.out_ch,
                                            mod.wx, mod.sx, (0, 0))))
    return k2, k3, calls


def finish_launches(layers, frames):
    """(K2, K3) of ``StreamingNetwork.finish``: each layer's right pad pushed
    through it and the layers after it."""
    k2 = k3 = 0
    for i, layer in enumerate(layers):
        if layer.flush_frames():
            a, b, _ = stream_launches(layers, frames, layer.flush_frames(), i)
            k2, k3 = k2 + a, k3 + b
    return k2, k3


def stream_one(net, featp, audio, dec, check=True):
    """One utterance through the streaming featurizer, network and the
    online beam at batch 1 in ``STREAM_CHUNK`` chunks, as
    ``cli.streaming_asr`` does it (best hypothesis, then ``prune``, after
    every chunk). With ``check``, every chunk's launches are held to what
    its frames imply. Returns the per-chunk rows, the features, the
    emissions, the frames each chunk emitted and the final words' result."""
    import numpy as np
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.inference import StreamingFeaturizer

    sf = StreamingFeaturizer(featp, "cuda")
    fstate, states = sf.start(), net.start(1)
    dec.decode_begin()
    rows, feats, ems, cut, calls = [], [], [], [], []
    for pos in range(0, len(audio), STREAM_CHUNK):
        t0 = time.perf_counter()
        kernels.reset_launches()
        fstate, f = sf.run(fstate, audio[pos:pos + STREAM_CHUNK])
        torch.cuda.synchronize()
        k1 = kernels.LAUNCHES["mfsc"]
        t1 = time.perf_counter()
        em = np.zeros((0, 0), np.float32)
        k2 = k3 = 0
        frames = [0 if s is None else s.shape[1] for s in states]
        if len(f):
            kernels.reset_launches()
            states, y = net.run(states, f[None, :, :, None])
            em = y[0, :, 0, :].cpu().numpy()
            k2, k3 = kernels.LAUNCHES["time_conv"], kernels.LAUNCHES["residual_ln"]
        t2 = time.perf_counter()
        if len(em):
            dec.decode_step(em)
        dec.get_best_hypothesis(0)
        dec.prune(look_back=STREAM_LOOK_BACK)
        t3 = time.perf_counter()
        if check:
            want = stream_launches(net.layers, frames, len(f))
            if k1 != int(len(f) > 0) or (k2, k3) != want[:2]:
                fail(f"stream chunk at {pos}: launches K1 {k1} K2 {k2} K3 {k3}, expected "
                     f"{int(len(f) > 0)} {want[0]} {want[1]}")
            calls.append(want[2])
        rows.append(dict(feat_ms=1e3 * (t1 - t0), net_ms=1e3 * (t2 - t1),
                         beam_ms=1e3 * (t3 - t2), frames_in=len(f), frames_out=len(em),
                         k1=k1, k2=k2, k3=k3))
        feats.append(f)
        ems.append(em)
        cut.append(len(em))
    frames = [0 if s is None else s.shape[1] for s in states]
    kernels.reset_launches()
    states, y = net.finish(states)
    got = (kernels.LAUNCHES["time_conv"], kernels.LAUNCHES["residual_ln"])
    if check and got != finish_launches(net.layers, frames):
        fail(f"stream finish: launches {got}, expected {finish_launches(net.layers, frames)}")
    tail = np.zeros((0, 0), np.float32) if y is None else y[0, :, 0, :].cpu().numpy()
    if len(tail):
        dec.decode_step(tail)
    dec.decode_end()
    ems.append(tail)
    return dict(rows=rows, feats=torch.cat(feats), em=np.concatenate([e for e in ems if len(e)]),
                cut=cut, tail=len(tail), result=dec.get_best_hypothesis(), calls=calls)


def decode_cut(dec, em, cut, tail):
    """The beam fed ``em`` cut at a stream's chunk boundaries (``cut`` frames
    a chunk, then ``tail`` at finish), with the stream's ``prune`` calls."""
    dec.decode_begin()
    pos = 0
    for n in cut:
        if n:
            dec.decode_step(em[pos:pos + n])
        dec.get_best_hypothesis(0)
        dec.prune(look_back=STREAM_LOOK_BACK)
        pos += n
    if tail:
        dec.decode_step(em[pos:pos + tail])
    dec.decode_end()
    return dec.get_best_hypothesis()


def graph_ms(fn, args, iters=20, reps=10) -> float:
    """Device time per call of ``fn(*args)``, L2-warm and back to back: CUDA
    events around replays of a CUDA graph of ``iters`` calls, so the host's
    launch cost, which exceeds these kernels' device time, is left out. The
    profiler is not used for these: at a few microseconds a call, some of its
    readings held a tenth of the launches made."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, before capture
        for _ in range(3):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def stream_conv_rows(key):
    """K2, its dgrad and K2b in fp32 at one conv of a steady stream chunk
    (B = 1, a window of state and chunk frames, no pads) against their plain
    versions and one PyTorch call each, timed by ``graph_ms``; K2b twice for
    equal bits. Only K2 runs on the stream (a chunk has no backward): the
    gradients' rows check and time the kernels at the stream's small B * T,
    where the schedule splits the taps."""
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    B, T, Fq, C, CO, K, s, pads = key
    x, w, bias, dy = _conv_inputs(key, torch.float32)
    xn = x.view(B, T, Fq, C).permute(0, 3, 2, 1).contiguous()
    wn = w.permute(2, 1, 0).unsqueeze(2).contiguous()
    Tout = dy.shape[1]
    dyn = dy.view(B, Tout, Fq, CO).permute(0, 3, 2, 1).contiguous()
    flops = 2 * B * Tout * Fq * CO * K * C
    shape = list(key[:7]) + [list(pads)]
    calls = (
        ("time_conv", "conv", (x, w, Fq, s, pads, bias, True), kernels.time_conv,
         kernels.time_conv_plain, lambda a, b_, c: F.conv2d(a, b_, c, stride=(1, s)),
         (xn, wn, bias), 4 * (x.numel() + w.numel() + dy.numel() + CO)),
        ("time_conv_dgrad", "dgrad", (dy, w, Fq, T, s, pads), kernels.time_conv_dgrad,
         kernels.time_conv_dgrad_plain,
         lambda a, b_: torch.nn.grad.conv2d_input(xn.shape, b_, a, stride=(1, s)), (dyn, wn),
         4 * (dy.numel() + w.numel() + x.numel())),
        ("time_conv_wgrad", "wgrad", (x, dy, K, Fq, s, pads), kernels.time_conv_wgrad,
         kernels.time_conv_wgrad_plain,
         lambda a, b_: torch.nn.grad.conv2d_weight(a, wn.shape, b_, stride=(1, s)), (xn, dyn),
         4 * (x.numel() + dy.numel() + w.numel())))
    rows = []
    for name, kind, args, fn, plain, lib, lib_args, nbytes in calls:
        got = fn(*args)
        err, rel, ok = compare(name, "float32", got, plain(*args))
        if kind == "wgrad":
            ok = ok and torch.equal(got, fn(*args))  # ordered sums
        b_ms, b_by = bound(nbytes, flops, "float32")
        ms = graph_ms(fn, args)
        rows.append(dict(
            name=name, dtype="float32", shape=shape, tag="stream", max_abs_err=err,
            max_rel_err=rel, tol=TOL[(name, "float32")], ok=ok, ms=ms,
            plain_ms=graph_ms(plain, args), library_ms=graph_ms(lib, lib_args), bound_ms=b_ms,
            bound_by=b_by, tflops=flops / ms / 1e9, calls=int(kind == "conv"),
            **_conv_layout(torch.float32, key, kind, Tout)))
        _conv_log(rows[-1], "stream")
    return rows


def stream_chunk_k2_ms(convs):
    """Device time of a steady chunk's K2 launches (``convs``, one per call,
    in order), replayed back to back from one CUDA graph: what the chunk's
    device time holds of K2, without the host's launch cost."""
    import torch

    from wav2letter_tpu_torch import kernels

    args = []
    for key in convs:
        x, w, bias, _ = _conv_inputs(key, torch.float32)
        args.append((x, w, key[2], key[6], key[7], bias, True))

    def chunk():
        for a in args:
            kernels.time_conv(*a)

    return graph_ms(chunk, ())


def stream_kernel_rows(featurizer, S, convs, lns, details):
    """K1 at a chunk's samples S, K2 and K3 at streaming shapes (B = 1
    windows, a few rows), against their plain versions and one PyTorch call
    of the same function where there is one, timed per launch by
    ``graph_ms``, with L2-warm inputs as a stream finds them."""
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.kernels.layernorm import route as ln_route
    from wav2letter_tpu_torch.kernels.mfsc import route as mfsc_route

    rows = []
    p = featurizer.p
    pre = 0.5 * torch.randn((1, S), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(S))
    args = (pre, featurizer.cos_mat, featurizer.sin_mat, featurizer.mel_fb, p.frame_samples,
            p.stride_samples, p.mel_floor)
    got = kernels.mfsc(*args)
    err, rel, ok = compare("mfsc", "float32", got, kernels.mfsc_plain(*args))
    nb, nm = featurizer.mel_fb.shape
    T = got.shape[1]
    nnz = int((featurizer.mel_fb != 0).sum())
    b_ms, b_by = bound(4 * (S + 2 * p.frame_samples * nb + nb * nm + T * nm),
                       T * (2.5 * p.n_fft * math.log2(p.n_fft) + 4 * nb + 2 * nnz + nm),
                       "float32")  # as _mfsc_row counts the function's work
    rows.append(dict(
        name="mfsc", dtype="float32", shape=[1, S, T], tag="stream", max_abs_err=err,
        max_rel_err=rel, tol=TOL[("mfsc", "float32")], ok=ok, ms=graph_ms(kernels.mfsc, args),
        plain_ms=graph_ms(kernels.mfsc_plain, args), library_ms=None, bound_ms=b_ms,
        bound_by=b_by, route=mfsc_route(p.frame_samples, p.stride_samples, nb, nm)))
    for key in convs:
        rows.extend(stream_conv_rows(key))
    for R, D in lns:
        x, y, w, b = _ln_inputs(R + 4, D, torch.float32, R + D)
        x, y = x[2:2 + R], y[:R].contiguous()  # the residual: a time slice of a window
        args = (x, y, w, b)
        err, rel, ok = _ln_compare("float32", kernels.residual_ln(*args),
                                   kernels.residual_ln_plain(*args))
        wd, bd = w.expand(D).contiguous(), b.expand(D).contiguous()
        b_ms, b_by = bound(12 * R * D + 8 * R + 8, 8 * R * D, "float32")
        rows.append(dict(
            name="residual_ln", dtype="float32", shape=[R, D], tag="stream", max_abs_err=err,
            max_rel_err=rel, tol=TOL[("residual_ln", "float32")], ok=ok,
            ms=graph_ms(kernels.residual_ln, args),
            plain_ms=graph_ms(kernels.residual_ln_plain, args),
            library_ms=graph_ms(lambda a, a2, c, d: F.layer_norm(a + a2, (D,), c, d, 1e-5),
                                (x, y, wd, bd)),
            bound_ms=b_ms, bound_by=b_by, route=ln_route(D, 4, x.data_ptr() % 16 == 0)))
    for r in rows:
        r["warm_ms"] = r["ms"]
        log(f"[stream kernel] {json.dumps(r)}")
        details.append(r)
    return rows


def stream_path(paths, lst, secs, tmp, smi_line):
    """Phase 11: the flagship's fp32 checkpoint through
    ``cli.convert_streaming``, then the list's utterances streamed at batch 1
    in 500 ms chunks through the Python API with the online Python beam
    (phase 10's lexicon and ARPA; beam 100, beamSizeToken 100, threshold 25).
    Checks each chunk's launches, the streamed emissions against the batch
    fp32 forward on the same features, the streamed features against the
    batch featurizer, the streamed words against the same decoder fed the
    batch emissions at the stream's chunk boundaries, ``cli.streaming_asr``
    (a subprocess) and ``cli.streaming_asr_multi`` (4 threads) against the
    in-process words, and K2 and K3 at streaming shapes against their plain
    versions."""
    import contextlib
    import io

    import numpy as np
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli import convert_streaming, streaming_asr, streaming_asr_multi
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import read_list_file
    from wav2letter_tpu_torch.data.audio import load_audio
    from wav2letter_tpu_torch.features import FeatureParams, Featurizer
    from wav2letter_tpu_torch.features.frontend import local_normalize
    from wav2letter_tpu_torch.inference import StreamingFeaturizer, load_streaming_bundle
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "stream")
    os.makedirs(root, exist_ok=True)
    bundle = os.path.join(root, "flagship.stream")
    with contextlib.redirect_stdout(io.StringIO()):
        convert_streaming.main([f"--am={paths['float32']}", f"--out={bundle}"])
    t0 = time.perf_counter()
    net, featp, meta = load_streaming_bundle(bundle, "cuda")
    opts = os.path.join(root, "decoder.json")
    with open(opts, "w") as f:
        json.dump(STREAM_DECODER, f)
    ckpt = load_checkpoint(paths["float32"])
    cfg = Config.deserialize(ckpt.config)
    dargs = {"lexicon_file": cfg.lexicon,
             "language_model_file": os.path.join(tmp, "decode", "lm.arpa"),
             "decoder_options_file": opts}
    dec, word_dict, tok_dict, blank = streaming_asr.build_decoder(dargs, meta)
    wsep = str(meta["wordseparator"])
    setup_s = time.perf_counter() - t0
    samples = read_list_file(lst)
    audio = {s.sample_id: load_audio(s.audio_path, featp.sample_rate) for s in samples}

    # warm-up (cuBLAS, the modules' re-indexed weights): 2 s, checked, not kept
    stream_one(net, featp, audio[samples[0].sample_id][:32000], dec)
    torch.cuda.synchronize()
    t_stream = time.perf_counter()
    streamed = {sid: stream_one(net, featp, a, dec) for sid, a in audio.items()}
    stream_s = time.perf_counter() - t_stream
    words = {sid: streaming_asr.result_words(r["result"], word_dict, tok_dict, blank, wsep)
             for sid, r in streamed.items()}

    # against the batch path: features, emissions, and the beam on batch emissions
    model = build_arch_module(ARCH, N_FEAT, len(meta["tokens"]))
    model.load_state_dict(ckpt.state_dict)
    model.cuda().eval()
    batch_feat = Featurizer(FeatureParams.from_config(cfg)).cuda()
    raw_feat = Featurizer(FeatureParams(n_filterbanks=N_FEAT)).cuda()
    em_err = feat_err = feat_err_head = feat_err_fp32 = 0.0
    fp32_worst = None
    ref_dec, _, _, _ = streaming_asr.build_decoder(dargs, meta)
    bad_words = []
    for sid, r in streamed.items():
        x = torch.from_numpy(audio[sid]).cuda()[None]
        with torch.no_grad():
            bf = batch_feat(x)[0][0]
            # the batch path's K1 on the whole utterance, its CMVN in float64
            bf64 = local_normalize(raw_feat(x)[0].double(), featp.local_norm_left, 0)[0]
            bem = model(r["feats"][None])[0][0].cpu().numpy()
        if bf.shape != r["feats"].shape or bem.shape != r["em"].shape:
            fail(f"stream {sid}: features {tuple(r['feats'].shape)} vs {tuple(bf.shape)}, "
                 f"emissions {r['em'].shape} vs {bem.shape}")
        if not np.isfinite(r["em"]).all():
            fail(f"stream {sid}: non-finite emissions")
        fe = (r["feats"].double() - bf64).abs()
        feat_err, feat_err_head = max(feat_err, fe[8:].max().item()), max(feat_err_head,
                                                                         fe[:8].max().item())
        e32 = (r["feats"] - bf).abs().amax(dim=1)
        if e32[8:].max().item() > feat_err_fp32:
            feat_err_fp32 = e32[8:].max().item()
            fp32_worst = dict(utterance=sid, frame=8 + int(e32[8:].argmax()),
                              frames=len(e32))
        em_err = max(em_err, float(np.abs(r["em"] - bem).max()))
        ref = decode_cut(ref_dec, bem, r["cut"], r["tail"])
        ref_words = streaming_asr.result_words(ref, word_dict, tok_dict, blank, wsep)
        if ref_words != words[sid]:
            bad_words.append(sid)
    if em_err >= STREAM_EM_TOL or max(feat_err, feat_err_head) >= STREAM_FEAT_TOL:
        fail(f"stream: emissions {em_err} (bound {STREAM_EM_TOL}) or features {feat_err}, "
             f"first 8 frames {feat_err_head} (bound {STREAM_FEAT_TOL}) differ from the "
             f"batch path")
    if bad_words:
        fail(f"stream: streamed words differ from the batch-fed beam's on {bad_words}")

    # the CLIs: streaming_asr as a subprocess on the shortest utterance,
    # streaming_asr_multi on the 4 shortest with 4 threads, in this process
    by_len = sorted(audio, key=lambda k: len(audio[k]))
    short = next(s for s in samples if s.sample_id == by_len[0])
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "wav2letter_tpu_torch.cli.streaming_asr", f"--bundle={bundle}",
         f"--input_audio_file={short.audio_path}", f"--lexicon_file={dargs['lexicon_file']}",
         f"--language_model_file={dargs['language_model_file']}",
         f"--decoder_options_file={opts}"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    cli_s = time.perf_counter() - t0
    if cli.returncode != 0:
        fail(f"cli.streaming_asr exited {cli.returncode}: {cli.stderr[-2000:]}")
    cli_words = cli.stdout.split("[final]")[-1].split()
    if cli_words != words[short.sample_id]:
        fail(f"cli.streaming_asr printed {cli_words}, the stream gave {words[short.sample_id]}")
    multi = [s for s in samples if s.sample_id in by_len[:STREAM_MULTI]]
    margs = [f"--bundle={bundle}", f"--input_files={','.join(s.audio_path for s in multi)}",
             f"--max_num_threads={STREAM_MULTI}", f"--lexicon_file={dargs['lexicon_file']}",
             f"--language_model_file={dargs['language_model_file']}", "--beam_size=100",
             "--beam_threshold=25", "--lm_weight=1", "--word_score=0.5"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        streaming_asr_multi.main(margs)
    multi_s = time.perf_counter() - t0
    printed = dict(line.split(": ", 1) for line in out.getvalue().splitlines())
    factory, _, _, _ = streaming_asr_multi.bundle_factory(
        streaming_asr_multi.parse_args(margs), meta)
    for s in multi:  # each stream's single-thread words, from its own emissions
        r = streamed[s.sample_id]
        d = factory.make()
        d.decode_begin()
        pos = 0
        for n in r["cut"] + [r["tail"]]:
            if n:
                d.decode_step(r["em"][pos:pos + n])
            pos += n
        d.decode_end()
        want = " ".join(streaming_asr.result_words(d.get_best_hypothesis(),
                                                   factory.word_dict, tok_dict, blank, wsep))
        if printed.get(s.audio_path, None) != want:
            fail(f"cli.streaming_asr_multi printed {printed.get(s.audio_path)!r} for "
                 f"{s.sample_id}, a single stream gives {want!r}")

    # device time of one utterance's featurizer and network, and their wall
    first = audio[samples[0].sample_id]
    sf = StreamingFeaturizer(featp, "cuda")

    def feat_net():
        fs, st = sf.start(), net.start(1)
        for pos in range(0, len(first), STREAM_CHUNK):
            fs, f = sf.run(fs, first[pos:pos + STREAM_CHUNK])
            if len(f):
                st, y = net.run(st, f[None, :, :, None])
                y.cpu()
        net.finish(st)

    feat_net()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feat_net()
    torch.cuda.synchronize()
    fn_wall_ms = 1e3 * (time.perf_counter() - t0)
    prof = profile_device(feat_net)
    by_kernel = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                        for e in device_events(prof)), reverse=True)
    busy = sum(r[0] for r in by_kernel)
    n_chunks = len(streamed[samples[0].sample_id]["rows"])

    # K1, K2 and K3 at the shapes of a steady chunk of the first utterance
    calls = streamed[samples[0].sample_id]["calls"][len(streamed[samples[0].sample_id]
                                                         ["calls"]) // 2]
    convs = [c for k, c in calls if k == "time_conv"]
    lns = [c for k, c in calls if k == "residual_ln"]
    details = []
    S = featp.frame_samples + featp.stride_samples * (
        max(r["frames_in"] for r in streamed[samples[0].sample_id]["rows"]) - 1)
    k_rows = stream_kernel_rows(sf.featurizer, S, [convs[0], convs[1], convs[-1]],
                                [lns[0], lns[4], lns[-1]], details)
    if not all(r["ok"] for r in k_rows):
        fail(f"stream kernels disagree with their plain versions: "
             f"{[r for r in k_rows if not r['ok']]}")
    k2_chunk_ms = stream_chunk_k2_ms(convs)
    log(f"[stream] a steady chunk's {len(convs)} K2 launches: {k2_chunk_ms:.4f} ms of device "
        f"time (graph replay) | {smi_line}")

    rows = [row for r in streamed.values() for row in r["rows"]]
    lat = {k: np.asarray([row[k] for row in rows]) for k in ("feat_ms", "net_ms", "beam_ms")}
    total = lat["feat_ms"] + lat["net_ms"] + lat["beam_ms"]

    def pct(a):
        return dict(p50=float(np.percentile(a, 50)), p95=float(np.percentile(a, 95)))

    results = dict(
        utterances=len(streamed), audio_s=secs, chunks=len(rows), setup_s=setup_s,
        stream_s=stream_s, x_real_time=secs / stream_s,
        latency_ms=dict(total=pct(total), **{k[:-3]: pct(v) for k, v in lat.items()}),
        launches={k: sum(row[k] for row in rows) for k in ("k1", "k2", "k3")},
        k2_chunk=dict(launches=len(convs), ms=k2_chunk_ms, shapes=convs),
        em_max_abs_err=em_err, em_tol=STREAM_EM_TOL, feat_max_abs_err_after_8=feat_err,
        feat_max_abs_err_first_8=feat_err_head, feat_tol=STREAM_FEAT_TOL,
        feat_max_abs_err_fp32_cmvn_after_8=feat_err_fp32, feat_fp32_cmvn_worst=fp32_worst,
        words=sum(len(w) for w in words.values()), cli_s=cli_s, multi_s=multi_s,
        multi_utterances=len(multi),
        profile=dict(utterance=samples[0].sample_id, chunks=n_chunks, wall_ms=fn_wall_ms,
                     device_busy_ms=busy, device_busy_ms_per_chunk=busy / n_chunks,
                     idle_share=1 - busy / fn_wall_ms,
                     idle_share_with_beam=1 - busy / sum(
                         row["feat_ms"] + row["net_ms"] + row["beam_ms"]
                         for row in streamed[samples[0].sample_id]["rows"]),
                     top=[dict(ms=round(ms, 4), kernel=k[:90], count=c)
                          for ms, k, c in by_kernel[:12]]),
        kernels=details, phase_s=time.perf_counter() - t_phase)
    log(f"[stream flagship float32] {json.dumps({k: v for k, v in results.items() if k != 'kernels'})}")
    log(f"[stream rate] {secs / stream_s:.1f} audio s per wall s; chunk latency p50 "
        f"{results['latency_ms']['total']['p50']:.2f} ms, p95 "
        f"{results['latency_ms']['total']['p95']:.2f} ms (featurizer "
        f"{results['latency_ms']['feat']['p50']:.2f}, network "
        f"{results['latency_ms']['net']['p50']:.2f}, beam "
        f"{results['latency_ms']['beam']['p50']:.2f} ms p50); device busy "
        f"{busy / n_chunks:.3f} ms a chunk, idle share {1 - busy / fn_wall_ms:.3f} | {smi_line}")
    log(f"[stream] phase 11 in {results['phase_s']:.1f} s")
    return results


# ---------------------------------------------------------------------------
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="directory for the detailed JSON")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        sys.exit(2)
    if not os.path.isdir(os.path.join(REPO, "wav2letter_tpu_torch")) \
            or not all(os.path.exists(a) for a in (ARCH, TR_ARCH, CFR_ARCH)):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, REPO)
    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.models import build_arch_module

    t_start = time.perf_counter()
    kernels.disable_tf32()
    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    smi_line = smi[0].strip() if smi else "nvidia-smi: no output"
    log(f"[device] {kind} x{count} | {smi_line} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = kernels._build.build()
    kernels.library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    build_log = (kernels._build.BUILD_DIR / "build.log")
    ptxas = []
    if build_log.exists():
        ptxas = [line.strip() for line in build_log.read_text().splitlines()
                 if re.search(r"Compiling entry|Used \d+ registers|spill", line)]
        for line in ptxas:
            log(f"[ptxas] {line}")

    with tempfile.TemporaryDirectory(prefix="w2l_chip_smoke_") as tmp:
        # data and flagship checkpoints for the main path
        lst, tokens, lexicon, secs = synth_dataset(os.path.join(tmp, "data"), args.seed)
        paths, n_params = save_model(FLAGSHIP, tmp, args.seed, tokens, lexicon)
        n_batches, T, S = batch_shapes(lst, tokens, lexicon)
        with torch.device("meta"):
            model = build_arch_module(ARCH, N_FEAT, N_TOKENS + 1)
        convs, lns = path_calls(model, BATCH, T)
        log(f"[shapes] largest batch B={BATCH} S={S} T={T}; {len(convs)} K2 and "
            f"{len(lns)} K3 calls per forward")

        train_lst, _, _, train_secs = synth_dataset(
            os.path.join(tmp, "data"), args.seed + 1, TRAIN_UTTS, "train", (tokens, lexicon))
        fl_batch = FLAGSHIP["train"]["batchsize"]
        _, T_train, S_train = batch_shapes(train_lst, tokens, lexicon, fl_batch)
        tconvs, tlns = path_calls(model, fl_batch, T_train)
        log(f"[shapes] largest training batch B={fl_batch} S={S_train} T={T_train}; "
            f"{train_secs:.1f} s of audio in {TRAIN_UTTS} utterances")
        # the transformer: three stride-2 pools ahead of 12 layers of H=4, Dh=192
        tr_batch = TRANSFORMER["train"]["batchsize"]
        _, T_tr_train, _ = batch_shapes(train_lst, tokens, lexicon, tr_batch)
        Ta, Ta_train = pooled_frames(T), pooled_frames(T_tr_train)
        attn_shapes = [("serve", BATCH, Ta, 4, 192, True, 12),
                       ("train", tr_batch, Ta_train, 4, 192, True, 12),
                       ("unmasked", BATCH, 188, 4, 192, False, 0),
                       ("gate_edge", 2, 460, 4, 192, True, 0),
                       ("conformer", 8, 240, 4, 128, True, 0),
                       ("ragged17", 2, 17, 4, 192, True, 0),
                       ("ragged65", 2, 65, 4, 192, True, 0)]
        tr_lns, tr_tlns = [(BATCH * Ta, 768)] * 24, [(tr_batch * Ta_train, 768)] * 24
        log(f"[shapes] transformer: attention over T={Ta} (serving, B={BATCH}) and "
            f"T={Ta_train} (training, B={tr_batch}); 12 K4 and 24 K3 calls per forward")

        # 3. kernels against their plain versions
        details = []
        rows = {"mfsc": check_mfsc(BATCH, S, details)}
        check_mfsc(fl_batch, S_train, details, "train")  # the update's K1, B = 16
        check_mfsc_edges(details)
        for dt in ("float32", "bfloat16"):
            rows[("time_conv", dt)] = check_time_conv(convs, dt, details, CONV_EDGES)
            rows[("residual_ln", dt)] = check_residual_ln(lns, dt, details)
            check_residual_ln_edges(dt, details)
            back = check_time_conv_backward(tconvs, dt, details, CONV_EDGES)
            rows[("time_conv_dgrad", dt)] = back["time_conv_dgrad"]
            rows[("time_conv_wgrad", dt)] = back["time_conv_wgrad"]
            rows[("residual_ln_bwd", dt)] = check_residual_ln_bwd(tlns, dt, details)
            rows[("residual_ln@transformer", dt)] = check_residual_ln(tr_lns, dt, details)
            rows[("residual_ln_bwd@transformer", dt)] = check_residual_ln_bwd(
                tr_tlns, dt, details)
            att = check_attention(attn_shapes, dt, details)
            check_attention_bwd(k4b_edges(dt), dt, details)
            rows[("mhsa", dt)] = [r for r in att["mhsa"] if r["tag"] == "serve"]
            rows[("mhsa_bwd", dt)] = [r for r in att["mhsa_bwd"] if r["tag"] == "train"]
            torch.cuda.empty_cache()
        for r in details:
            r["bound_share"] = r["bound_ms"] / r["ms"]
            log(f"[kernel] {json.dumps(r)}")
        # each kernel over one pass (its rows weighted by their calls), per type
        sums = []
        for key, krows in rows.items():
            name, dt = ("mfsc", "float32") if key == "mfsc" else key
            sums.append(dict(name=name, dtype=dt, calls=sum(r["calls"] for r in krows),
                             per=("update" if "bwd" in name or "grad" in name else "forward"),
                             **per_forward(krows)))
            log(f"[kernel sum] {json.dumps(sums[-1])}")
        bad = [r for r in details if not r["ok"]]
        if bad:
            fail(f"{len(bad)} kernel checks disagree with the plain versions: "
                 f"{json.dumps(bad[0])}")

        # 4. the main path: serving
        served, ev, ds_main = main_path(FLAGSHIP, paths, lst, secs, os.path.join(tmp, "em"),
                                        n_batches)

        # 5. where one bf16 forward's device time goes
        prof = profile_forward(ev, ds_main)
        log(f"[profile] {json.dumps(prof)}")
        del ev, ds_main
        torch.cuda.empty_cache()

        # 6. the main path: training
        trained = training_path(FLAGSHIP, tmp, train_lst, lst, tokens, lexicon, n_batches)

        # 7. the transformer: serving, one profiled forward, training
        tr_paths, tr_params = save_model(TRANSFORMER, tmp, args.seed, tokens, lexicon)
        log(f"[transformer] {tr_params} parameters")
        tr_served, ev, ds_main = main_path(TRANSFORMER, tr_paths, lst, secs,
                                           os.path.join(tmp, "em"), n_batches)
        tr_prof = profile_forward(ev, ds_main)
        log(f"[profile transformer] {json.dumps(tr_prof)}")
        del ev, ds_main
        torch.cuda.empty_cache()
        tr_trained = training_path(TRANSFORMER, tmp, train_lst, lst, tokens, lexicon,
                                   n_batches)

        # 8. the conformer
        conformer = conformer_path(tmp, tokens, lexicon, args.seed)

        # 9. the long-context transformer
        long_context = long_context_path(tmp, tokens, lexicon, args.seed)

        # 10. the lexicon beam decode of the flagship
        decoded = decode_path(paths, lst, secs, tmp, n_batches, smi_line)

        # 11. chunked streaming inference of the flagship
        streamed = stream_path(paths, lst, secs, tmp, smi_line)

    kernels_line = []
    fwd, upd = "forward of the largest serving batch", "update on the largest training batch"
    for name, per, model_name in (
            ("mfsc", fwd, "flagship"), ("time_conv", fwd, "flagship"),
            ("time_conv_wgrad", upd, "flagship"), ("residual_ln", fwd, "flagship"),
            ("residual_ln_bwd", upd, "flagship"), ("mhsa", fwd, "transformer"),
            ("mhsa_bwd", upd, "transformer")):
        dt = "float32" if name == "mfsc" else "bfloat16"
        agg = per_forward(rows["mfsc" if name == "mfsc" else (name, dt)])
        replaces, source = TPU_KERNELS[name]
        backward = per == upd
        path_served, path_trained = ((served, trained) if model_name == "flagship"
                                     else (tr_served, tr_trained))
        train_launches = path_trained["bfloat16"]["launches_per_update"]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces, model=model_name,
            launches=(train_launches[name] if backward
                      else path_served["bfloat16"]["launches"][name]),
            launches_per_update=train_launches[name], dtype=dt,
            max_abs_err=agg["max_abs_err"], ms=agg["ms"], warm_ms=agg["warm_ms"],
            plain_ms=agg["plain_ms"],
            bound_ms=agg["bound_ms"], bound_by=agg["bound_by"],
            library_ms=agg["library_ms"], per=per)
        if name in ("mfsc", "residual_ln"):  # which of the kernel's two routes ran
            krows = rows["mfsc" if name == "mfsc" else (name, dt)]
            entry["kernel_route"] = sorted({r["route"] for r in krows})
        if name == "residual_ln":  # F.layer_norm of a precomputed sum, the old yardstick
            entry["layer_norm_ms"] = sum(r["layer_norm_ms"] * r["calls"] for r in krows)
        if name == "time_conv":  # the same kernel as dgrad, per update
            dg = per_forward(rows[("time_conv_dgrad", dt)])
            entry["dgrad"] = {k: dg[k] for k in ("ms", "warm_ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "max_abs_err")}
        if name in ("time_conv", "time_conv_wgrad"):  # the fp32 route (3xTF32)
            parts = ([("forward", name), ("dgrad", "time_conv_dgrad")] if name == "time_conv"
                     else [("wgrad", name)])
            entry["float32"] = {}
            for part, key in parts:
                krows = rows[(key, "float32")]
                agg = per_forward(krows)
                entry["float32"][part] = dict(
                    routes=sorted({r["route"] for r in krows}),
                    **{k: agg[k] for k in ("ms", "warm_ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "max_abs_err")})
        if name == "mhsa_bwd":  # K4b's time by launch
            krows = rows[(name, dt)]
            entry["split_ms"] = {k: sum(r["split_ms"].get(k, 0.0) * r["calls"] for r in krows)
                                 for k in {k for r in krows for k in r["split_ms"]}}
        if name in ("mfsc", "time_conv", "residual_ln"):  # phase 11, per launch
            srows = [r for r in streamed["kernels"] if r["name"] == name]
            entry["stream"] = dict(
                launches=streamed["launches"][{"mfsc": "k1", "time_conv": "k2",
                                               "residual_ln": "k3"}[name]],
                dtype="float32", shapes=[r["shape"] for r in srows],
                **{k: [r[k] for r in srows]
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
                max_abs_err=max(r["max_abs_err"] for r in srows))
            if name == "time_conv":
                entry["stream"]["chunk_ms"] = streamed["k2_chunk"]["ms"]
        kernels_line.append(entry)
    summary = dict(kernels=kernels_line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi_line, ptxas=ptxas, details=details,
                           sums=sums,
                           main=served,
                           profile=prof, training=trained, kernels=kernels_line,
                           n_params=n_params,
                           transformer=dict(n_params=tr_params, main=tr_served,
                                            profile=tr_prof, training=tr_trained),
                           conformer=conformer, long_context=long_context,
                           decode=decoded, streaming=streamed,
                           seconds=time.perf_counter() - t_start), f, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(summary))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
