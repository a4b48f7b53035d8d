#!/usr/bin/env python3
"""Drive the PyTorch port (``wav2letter_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--seed N]

Run from the root of a checkout on a machine with a CUDA card. Phases:

1. the device: name, count, ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``wav2letter_tpu_torch/csrc``;
3. hold each kernel (K1 MFSC, K2 time conv, K3 residual LayerNorm) against
   its plain PyTorch version at the shapes of the main path's largest batch
   (fp32, and bf16 for K2 and K3), and time kernel, plain version, one
   PyTorch call of the same function where there is one, and the bound;
   times are device times with the inputs in HBM (cold L2), the kernel's
   also with L2-warm inputs;
4. the main path at full width: the streaming-convnets flagship
   (``recipes/streaming_convnets/network.arch``, 80 filterbanks, 9998
   classes, 96,660,482 parameters, seeded weights) serves ~8 synthesized
   utterances of 4-15 s through the port's ``run_test`` (``Evaluator`` set-up,
   then ``evaluate``, timed apart) at batch 4, in bf16 and then fp32, with
   the launch counts of each run checked (1 K1, 15 K2, 22 K3 per batch) and
   its emissions held against the plain-version forward on the card; then
   ``PASSES`` more passes of the loaded model give the steady-state rate;
5. one profiled bf16 forward: device time by kernel.

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
N_FEAT, N_TOKENS, BATCH = 80, 9997, 4
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
PASSES = 10  # steady-state passes over the served list per type
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM, dense
TPU_KERNELS = {
    "mfsc": ("wav2letter_tpu/ops/pallas/mel.py:65", "wav2letter_tpu_torch/csrc/mfsc.cu"),
    "time_conv": ("wav2letter_tpu/ops/pallas/tconv.py:155",
                  "wav2letter_tpu_torch/csrc/tconv.cu"),
    "residual_ln": ("wav2letter_tpu/ops/pallas/layernorm.py:77",
                    "wav2letter_tpu_torch/csrc/layernorm.cu"),
}
# kernel vs plain version, |got - want| <= atol + rtol * |want|
TOL = {
    ("mfsc", "float32"): (1e-4, 1e-4),       # 400-term fp32 sums, log features
    ("time_conv", "float32"): (1e-4, 1e-4),  # <= 336-term fp32 sums
    ("time_conv", "bfloat16"): (1e-2, 1e-2),  # one bf16 rounding of the output
    ("residual_ln", "float32"): (1e-5, 1e-5),
    ("residual_ln", "bfloat16"): (2e-2, 1e-2),
}
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


def device_ms(fn, args, cold=True, iters=20) -> float:
    """Device time per call of ``fn(*args)``: the time of the kernels it
    launches, from the profiler, without the host's launch overhead.

    Cold (the default), the calls cycle through copies of ``args`` that
    together exceed twice the L2 cache, so each call reads its inputs from
    HBM, as the bound assumes. Warm, every call reuses the same inputs, which
    stay in L2 between calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sets = [args]
    if cold:
        nbytes = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
        sets = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]
        iters = max(iters, 2 * len(sets))
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in device_events(prof)) / 1e3 / iters


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
def synth_dataset(root: str, seed: int, n_utts: int = 8):
    """Utterances of 4-15 s: white noise loud enough that no mel band sits at
    the log floor, under a slow random envelope; ~1.5 words per second from a
    200-word lexicon spelled with 9996 word pieces plus the separator."""
    import numpy as np

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    pieces = [f"p{i:04d}" for i in range(N_TOKENS - 1)]
    words = {f"w{i:03d}": [pieces[j] for j in rng.choice(len(pieces), rng.randint(1, 4))]
             for i in range(200)}
    lines, secs = [], 0.0
    for i in range(n_utts):
        n = int(16000 * rng.uniform(4.0, 15.0))
        env = np.interp(np.arange(n), np.linspace(0, n, 20), rng.uniform(0.4, 1.0, 20))
        wav = (0.5 * env * rng.randn(n)).astype(np.float32)
        path = os.path.join(root, f"utt{i:03d}.npy")
        np.save(path, wav)
        ws = [f"w{rng.randint(200):03d}" for _ in range(max(1, int(1.5 * n / 16000)))]
        lines.append(f"utt{i:03d} {path} {1000.0 * n / 16000:.1f} {' '.join(ws)}")
        secs += n / 16000
    lst = os.path.join(root, "test.lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    tokens = os.path.join(root, "tokens.txt")
    with open(tokens, "w") as f:
        f.write("|\n" + "\n".join(pieces) + "\n")
    lexicon = os.path.join(root, "lexicon.txt")
    with open(lexicon, "w") as f:
        f.writelines(f"{w}\t{' '.join(sp)} |\n" for w, sp in words.items())
    return lst, tokens, lexicon, secs


def save_flagship(root, seed, tokens, lexicon):
    """Seeded flagship weights as two port checkpoints, bf16 and fp32."""
    import torch

    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.checkpoint import Checkpoint, save_checkpoint

    torch.manual_seed(seed)
    model = build_arch_module(ARCH, N_FEAT, N_TOKENS + 1)
    n_params = sum(p.numel() for p in model.parameters())
    paths = {}
    for dtype in ("bfloat16", "float32"):
        cfg = Config(arch=ARCH, tokens=tokens, lexicon=lexicon, criterion="ctc",
                     mfsc=True, filterbanks=N_FEAT, localnrmlleftctx=300,
                     compute_dtype=dtype, batchsize=BATCH, nthread=2)
        paths[dtype] = os.path.join(root, f"flagship_{dtype}.pt")
        save_checkpoint(paths[dtype], Checkpoint(cfg.serialize(), 0, 0, model.state_dict()))
    return paths, n_params


def batch_shapes(lst, tokens, lexicon):
    """(number of batches, feature frames T and audio samples S of the
    largest batch) of the batches ``run_test`` builds from ``lst``."""
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset, Lexicon, make_token_dict

    cfg = Config(arch=ARCH, tokens=tokens, lexicon=lexicon, criterion="ctc",
                 mfsc=True, filterbanks=N_FEAT, batchsize=BATCH)
    ds = AsrDataset(lst, make_token_dict(tokens, "ctc", 0, False),
                    Lexicon.from_file(lexicon), cfg, batch_size=BATCH)
    specs = ds.batch_specs()
    T = max(s.max_input_frames for s in specs)
    return len(specs), T, ds.audio_samples_for_frames(T)


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
def check_mfsc(B, S, details):
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.features import FeatureParams, Featurizer

    f = Featurizer(FeatureParams(n_filterbanks=N_FEAT)).cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    pre = 0.5 * torch.randn((B, S), device="cuda", generator=g)
    args = (pre, f.cos_mat, f.sin_mat, f.mel_fb, 400, 160, 1.0)
    got = kernels.mfsc(*args)
    torch.cuda.synchronize()
    want = kernels.mfsc_plain(*args)
    err, rel, ok = compare("mfsc", "float32", got, want)
    T = got.shape[1]
    nb, nm = f.mel_fb.shape
    nbytes = 4 * (B * S + 2 * 400 * nb + nb * nm + B * T * nm)
    # the operations the function needs per frame, not the dense products
    # the kernel does: a real FFT of n_fft points (2.5 N log2 N), the
    # magnitude of each bin, a multiply-add per nonzero of the triangular
    # filterbank, and the log of each mel
    n_fft = f.p.n_fft
    nnz = int((f.mel_fb != 0).sum())
    flops = B * T * (2.5 * n_fft * math.log2(n_fft) + 4 * nb + 2 * nnz + nm)
    b_ms, b_by = bound(nbytes, flops, "float32")
    row = dict(name="mfsc", dtype="float32", shape=[B, S, T], max_abs_err=err,
               max_rel_err=rel, tol=TOL[("mfsc", "float32")], ok=ok,
               ms=device_ms(kernels.mfsc, args),
               warm_ms=device_ms(kernels.mfsc, args, cold=False),
               plain_ms=device_ms(kernels.mfsc_plain, args),
               library_ms=None, bound_ms=b_ms, bound_by=b_by, calls=1)
    details.append(row)
    return [row]


def check_time_conv(convs, dtype_name, details):
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    dtype = getattr(torch, dtype_name)
    rows = []
    for key in sorted(set(convs), key=convs.index):
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
        row = dict(name="time_conv", dtype=dtype_name, shape=list(key[:7]) + [list(pads)],
                   max_abs_err=err, max_rel_err=rel, tol=TOL[("time_conv", dtype_name)],
                   ok=ok, ms=device_ms(kernels.time_conv, args),
                   warm_ms=device_ms(kernels.time_conv, args, cold=False),
                   plain_ms=device_ms(kernels.time_conv_plain, args),
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   calls=convs.count(key))
        rows.append(row)
        details.append(row)
    return rows


def check_residual_ln(lns, dtype_name, details):
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    dtype = getattr(torch, dtype_name)
    rows = []
    for key in sorted(set(lns), key=lns.index):
        R, D = key
        g = torch.Generator(device="cuda").manual_seed(R + D)
        x = torch.randn((R, D), device="cuda", generator=g).to(dtype)
        y = torch.randn((R, D), device="cuda", generator=g).to(dtype)
        w = torch.tensor([1.3], device="cuda")
        b = torch.tensor([-0.2], device="cuda")
        out, mu, rsig = kernels.residual_ln(x, y, w, b)
        torch.cuda.synchronize()
        want = kernels.residual_ln_plain(x, y, w, b)
        err, rel, ok = compare("residual_ln", dtype_name, out, want[0])
        ok = ok and torch.allclose(mu, want[1], rtol=1e-5, atol=1e-5) \
            and torch.allclose(rsig, want[2], rtol=1e-5, atol=1e-5)
        z = x + y  # the yardstick normalizes a precomputed sum
        wd, bd = w.to(dtype).expand(D).contiguous(), b.to(dtype).expand(D).contiguous()
        lib_ms = device_ms(lambda a, b_, c: F.layer_norm(a, (D,), b_, c, 1e-5), (z, wd, bd))
        item = x.element_size()
        nbytes = 3 * R * D * item + 8 * R + 8
        flops = 8 * R * D
        b_ms, b_by = bound(nbytes, flops, "float32")  # statistics in fp32
        args = (x, y, w, b)
        row = dict(name="residual_ln", dtype=dtype_name, shape=[R, D], max_abs_err=err,
                   max_rel_err=rel, tol=TOL[("residual_ln", dtype_name)], ok=bool(ok),
                   ms=device_ms(kernels.residual_ln, args),
                   warm_ms=device_ms(kernels.residual_ln, args, cold=False),
                   plain_ms=device_ms(kernels.residual_ln_plain, args),
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, calls=lns.count(key))
        rows.append(row)
        details.append(row)
    return rows


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


def main_path(paths, lst, secs, emdir, n_batches):
    import numpy as np
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.runtime.test import Evaluator, evaluate

    results, evaluators = {}, {}
    # the first run pays for CUDA library set-up; it is checked, not kept
    for run, dtype_name in enumerate(("bfloat16", "bfloat16", "float32")):
        em_dir = os.path.join(emdir, dtype_name)
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
        want = {"mfsc": n_batches, "time_conv": 15 * n_batches,
                "residual_ln": 22 * n_batches}
        if launches != want:
            fail(f"{dtype_name} main path launches {launches}, expected {want}")
        if run == 0:
            log(f"[main warm-up {dtype_name}] {t2 - t0:.3f} s, launches {launches}")
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
        log(f"[main {dtype_name}] {json.dumps(results[dtype_name])}")
        if not ok:
            fail(f"{dtype_name} emissions differ from the plain path: max {max_err} mean "
                 f"{mean_err} (tolerance {tol})")
    return (results, *evaluators["bfloat16"])


def profile_forward(ev, ds):
    """Device time by kernel over one bf16 forward of the largest batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    spec = max(ds.batch_specs(), key=lambda s: s.max_input_frames)
    batch = ds.materialize(spec)
    ev.emissions(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev.emissions(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3  # without the profiler's overhead
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ev.emissions(batch)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in device_events(prof)), reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(dtype=str(ev.dtype), batch=[len(spec.indices), spec.max_input_frames],
                wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
                top=[dict(ms=round(ms, 4), kernel=k[:90], count=c) for ms, k, c in rows[:14]])


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
    if not os.path.isdir(os.path.join(REPO, "wav2letter_tpu_torch")) or not os.path.exists(ARCH):
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
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if re.search(r"Compiling entry|Used \d+ registers|spill", line):
                log(f"[ptxas] {line.strip()}")

    with tempfile.TemporaryDirectory(prefix="w2l_chip_smoke_") as tmp:
        # data and flagship checkpoints for the main path
        lst, tokens, lexicon, secs = synth_dataset(os.path.join(tmp, "data"), args.seed)
        paths, n_params = save_flagship(tmp, args.seed, tokens, lexicon)
        if n_params != 96_660_482:
            fail(f"flagship has {n_params} parameters, expected 96,660,482")
        n_batches, T, S = batch_shapes(lst, tokens, lexicon)
        with torch.device("meta"):
            model = build_arch_module(ARCH, N_FEAT, N_TOKENS + 1)
        convs, lns = path_calls(model, BATCH, T)
        log(f"[shapes] largest batch B={BATCH} S={S} T={T}; {len(convs)} K2 and "
            f"{len(lns)} K3 calls per forward")

        # 3. kernels against their plain versions
        details = []
        rows = {"mfsc": check_mfsc(BATCH, S, details)}
        for dt in ("float32", "bfloat16"):
            rows[("time_conv", dt)] = check_time_conv(convs, dt, details)
            rows[("residual_ln", dt)] = check_residual_ln(lns, dt, details)
        for r in details:
            r["bound_share"] = r["bound_ms"] / r["ms"]
            log(f"[kernel] {json.dumps(r)}")
        bad = [r for r in details if not r["ok"]]
        if bad:
            fail(f"{len(bad)} kernel checks disagree with the plain versions: "
                 f"{json.dumps(bad[0])}")

        # 4. the main path
        served, ev, ds_main = main_path(paths, lst, secs, os.path.join(tmp, "em"), n_batches)

        # 5. where one bf16 forward's device time goes
        prof = profile_forward(ev, ds_main)
        log(f"[profile] {json.dumps(prof)}")

    kernels_line = []
    for name, key, dt in (("mfsc", "mfsc", "float32"),
                          ("time_conv", ("time_conv", "bfloat16"), "bfloat16"),
                          ("residual_ln", ("residual_ln", "bfloat16"), "bfloat16")):
        agg = per_forward(rows[key])
        replaces, source = TPU_KERNELS[name]
        kernels_line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=served["bfloat16"]["launches"][name], dtype=dt,
            max_abs_err=agg["max_abs_err"], ms=agg["ms"], warm_ms=agg["warm_ms"],
            plain_ms=agg["plain_ms"],
            bound_ms=agg["bound_ms"], bound_by=agg["bound_by"],
            library_ms=agg["library_ms"], per="forward of the largest batch"))
    summary = dict(kernels=kernels_line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi_line, details=details, main=served,
                           profile=prof, kernels=kernels_line, n_params=n_params,
                           seconds=time.perf_counter() - t_start), f, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(summary))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
