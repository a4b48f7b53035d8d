"""K2 and K2b: time-only convolution in the (B, T, F*C) f-major chain layout
and its gradients — wrappers, the autograd function and plain versions.

The forward kernel is ``csrc/tconv.cu``; it replaces the TPU kernel
``wav2letter_tpu/ops/pallas/tconv.py::time_conv`` (``_fwd``). The gradient
with respect to x (dgrad) is the same kernel on the tap-flipped, transposed
weight, as ``tconv.py::_time_conv_bwd_rule`` does it; the gradient with
respect to w is K2b, ``csrc/tconv_wgrad.cu``, which replaces ``_wgrad``.

Each call takes one of four routes (:func:`route`): the tensor cores in
bf16 or in fp32 (3xTF32), the wide route for convs past 64 output channels
over at most 16 (tap, channel) pairs (CPC's first conv; forward and K2b,
never dgrad), or the CUDA-core kernels for what none of them takes.

On a CPU tensor every wrapper takes its plain version, which is
differentiable PyTorch code. On a CUDA tensor ``time_conv`` launches K2 and,
where a gradient is wanted, records :class:`_TimeConvFn`, whose backward
launches K2 (dgrad) and K2b."""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import _build

# Shared memory the wrapper lets one block of the CUDA-core kernels use for
# its window of input frames, on top of the weights (which take at most
# 37.6 KB at the flagship's widths). Sets the block's frequency extent Fb.
_WINDOW_BYTES = 48 * 1024
_MAX_FB = 16
CC_TT = 32  # csrc/tconv.cu, csrc/tconv_wgrad.cu: TT, output frames per block (CUDA cores)
WG_KV, WG_COV = 4, 4  # csrc/tconv_wgrad.cu: KV, COV
# the bf16 tensor-core kernels (csrc/tc_tile.cuh): frames per tile,
# positions per block, elements per ring row at C = 1, warps, units a warp
TC_TT, TC_FB, TC_TAP_PITCH, TC_WARPS, TC_UMAX = 16, 16, 24, 8, 3
TC_MAX_CO = 64  # eight n-tiles of 8
# the fp32 tensor-core kernels (3xTF32; csrc/tconv.cu, csrc/tconv_wgrad.cu):
# warps of a batch block, frames of a K2b tile, floats of a taps row in K2's
# and in K2b's ring
TF32_WARPS, TF32_WG_TT, TF32_TAP_PITCH, TF32_WG_TAP_PITCH = 8, 8, 24, 20
TF32_BLOCK_TILES = 1  # a block's fixed cost (weight, first window) in tiles' worth
# the wide route (csrc/tconv_wide.cu): CO past TC_MAX_CO over at most 16 (tap,
# channel) pairs, CPC's first conv. Threads a block (K2b: its consumers),
# channels a thread, rows a thread a K2 tile; K2b's ring of stages of at most
# 16 KB of dy and 64 frames; bytes a staged span takes past its elements; the
# mbarriers' head
WIDE_THREADS, WIDE_V, WIDE_MAX_TAPS, WIDE_FWD_ROWS = 256, 4, 16, 16
WIDE_WG_STAGES, WIDE_WG_STAGE_BYTES, WIDE_WG_MAX_TT = 4, 16384, 64
WIDE_SLOT, WIDE_HEAD = 32, 128


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def _odd_units(n: int) -> int:
    """n (a multiple of 8) raised to an odd number of 16-byte units of bf16."""
    return n if (n // 8) % 2 else n + 8


def _ring_bytes(C: int, pe: int, stride: int, span: int) -> int:
    """Bytes of a ring of window rows (``tc_tile.cuh::make_ring``): a
    tile's window and the next tile's new rows, rounded up to even."""
    rp = TC_TAP_PITCH if C == 1 else TC_FB * pe
    return 2 * rp * _pad((TC_TT - 1) * stride + span + 1 + TC_TT * stride, 2)


def tc_smem_bytes(C: int, CO: int, K: int, stride: int) -> int:
    """Dynamic shared memory of the bf16 tensor-core K2 (``csrc/tconv.cu::
    tc_layout``): the weight, K*Cp rows (C padded to 8; at C = 1 the taps
    padded to 16) of CO padded to an odd number of 16-byte units; the ring of
    window rows; the table of copy units (8 C ints)."""
    kr = _pad(K, 16) if C == 1 else K * _pad(C, 8)
    return (2 * kr * _odd_units(_pad(CO, 8)) + _ring_bytes(C, _odd_units(_pad(C, 8)), stride, K - 1)
            + 32 * C)


def tc_wgrad_units(C: int, K: int) -> Tuple[int, int]:
    """(units, classes) of the bf16 tensor-core K2b: units are (tap,
    16-channel) pairs, or 16-tap groups at C = 1; frames fall into ``classes``
    (t mod classes, a power of two up to 8), picked so that the (unit, class)
    items spread most evenly over 8 warps, at most ``TC_UMAX`` a warp."""
    units = -(-K // 16) if C == 1 else K * _pad(C, 16) // 16
    reps, best = 1, (0, 1)
    r = 1
    while r <= TC_WARPS:
        items = units * r
        per = -(-items // TC_WARPS)
        if per > TC_UMAX:
            break
        if items * best[1] > best[0] * per:
            reps, best = r, (items, per)
        r *= 2
    return units, reps


def tc_wgrad_smem_bytes(C: int, CO: int, K: int, stride: int) -> int:
    """Dynamic shared memory of the bf16 tensor-core K2b (``csrc/
    tconv_wgrad.cu::wg_layout``): the ring of x's window (as the forward's),
    the ring of two tiles of dy, and the two tables of copy units."""
    return (_ring_bytes(C, _odd_units(_pad(C, 8)), stride, K - 1)
            + _ring_bytes(CO, _odd_units(_pad(CO, 8)), 1, 0) + 32 * (C + CO))


def tc_granule(C: int, F: int) -> int:
    """Bytes of one cp.async of the tensor-core kernels' loaders: the largest
    of 16, 8, 4 that divides a position's C channels (at C = 1, positions are
    copied together) and a row of F*C; 0 where none does."""
    return next((g for g in (16, 8, 4)
                 if (2 * F * C) % g == 0 and (C == 1 or (2 * C) % g == 0)), 0)


def tf32_granule(C: int, F: int, taps: Optional[bool] = None) -> int:
    """Bytes of one cp.async of the fp32 tensor-core kernels' loaders: the
    largest of 16, 8, 4 that divides a position's 4 C bytes and a row's 4 F C;
    in the taps mode (C = 1 in x's ring, the default there) positions are
    copied together and only the row counts. Never 0: a float is 4 bytes."""
    taps = C == 1 if taps is None else taps
    return next(g for g in (16, 8, 4) if (4 * F * C) % g == 0 and (taps or (4 * C) % g == 0))


def tf32_smem_bytes(C: int, CO: int, K: int, stride: int, mw: int, mt: int, ks: int) -> int:
    """Dynamic shared memory of the fp32 tensor-core K2 (``csrc/tconv.cu::
    tf32_layout``) under a schedule of ``mw`` warps along the frames, ``mt``
    frames a warp and ``ks`` warps splitting the taps: the weight twice (its
    big and small TF32 halves), K*Cp rows (C padded to 8; at C = 1 the taps
    padded to 8) of CO padded to an odd multiple of 8; the ring of window rows,
    16 positions pad8(C) + 4 floats apart (24 floats at C = 1), a tile's
    window and the next tile's rows (K rows where the taps are split); the
    split sums."""
    tt = mw * mt
    kr = _pad(K, 8) if C == 1 else K * _pad(C, 8)
    rp = TF32_TAP_PITCH if C == 1 else TC_FB * (_pad(C, 8) + 4)
    nr = K if ks > 1 else _pad((tt - 1) * stride + K + tt * stride, 2)
    part = (ks - 1) * tt * TC_FB * _pad(CO, 8)
    return 4 * (2 * kr * _odd_units(_pad(CO, 8)) + nr * rp + part)


def tf32_steps(C: int, K: int) -> int:
    """k8 steps of the fp32 K2's reduction: taps at C = 1, else (k, 8 channels)."""
    return -(-K // 8) if C == 1 else K * -(-C // 8)


def tf32_tiles_per_block(B: int, Tout: int, F: int, slots: int, tt: int) -> int:
    """Tiles of ``tt`` frames an fp32 tensor-core block walks (C twin in
    ``csrc/tconv.cu::tiles_per_block32``): of all the cuts of each (batch row,
    16 positions) pair's tiles into runs, the one that gives the busiest of
    the ``slots`` (resident blocks of the card) the least work, its waves of
    blocks times a block's cost, its tiles plus ``TF32_BLOCK_TILES`` for the
    weight and the first window it stages; the longer run on a tie. Unlike
    ``tc_tiles_per_block``, a second wave is taken where it shortens the
    busiest slot's run, as at one block an SM."""
    pairs = B * -(-F // TC_FB)
    n_t = -(-Tout // tt)
    best, best_load = n_t, None
    for ch in range(n_t, 0, -1):
        load = -(-pairs * -(-n_t // ch) // slots) * (ch + TF32_BLOCK_TILES)
        if best_load is None or load < best_load:
            best, best_load = ch, load
    return best


def _tf32_batch(CO: int) -> Tuple[int, int]:
    """(warps along the frames, frames a warp) of an fp32 batch block: two
    frames a warp share each B fragment, up to four n-tiles (registers)."""
    return TF32_WARPS, 2 if -(-CO // 8) <= 4 else 1


@functools.lru_cache(maxsize=None)
def tf32_plan(B: int, Tout: int, F: int, C: int, CO: int, K: int, stride: int,
              sms: int) -> Tuple[int, int, int, int, int]:
    """The fp32 tensor-core K2's schedule (C twin ``w2l_time_conv_tf32_plan``):
    (warps along the frames MW, frames a warp MT, warps splitting the taps KS,
    tiles a block CH, blocks). Batch blocks of 8 warps walk tiles of 8 MT
    frames as ``tf32_tiles_per_block`` deals them, where they fill at least half
    of the ``sms`` SMs; otherwise (the stream's batch-1 windows) a block is
    one frame whose 8, 4 or 2 warps split the taps (at least 4 k8 steps and
    a tap each), or, where the reduction is too short to split (C = 1), 4
    frames of one warp each."""
    nf = -(-F // TC_FB)
    mw, mt = _tf32_batch(CO)
    tt = mw * mt
    n_t = -(-Tout // tt)
    if 2 * B * nf * n_t >= sms:
        smem = tf32_smem_bytes(C, CO, K, stride, mw, mt, 1)
        ch = tf32_tiles_per_block(B, Tout, F, sms * tc_blocks_per_sm(smem), tt)
        return mw, mt, 1, ch, B * nf * -(-n_t // ch)
    steps = tf32_steps(C, K)
    ks = next((n for n, need in ((8, 32), (4, 16), (2, 8)) if C > 1 and steps >= need and K >= n),
              1)
    mw = 1 if ks > 1 else 4
    return mw, 1, ks, 1, B * nf * -(-Tout // mw)


def tf32_wgrad_schedule(B: int, Tout: int, F: int, C: int, CO: int, K: int, stride: int,
                        sms: int) -> Tuple[int, int]:
    """(tiles a block walks, blocks) of the fp32 tensor-core K2b."""
    smem = tf32_wgrad_smem_bytes(C, CO, K, stride)
    ch = tf32_tiles_per_block(B, Tout, F, sms * tc_blocks_per_sm(smem), TF32_WG_TT)
    n_t = -(-Tout // TF32_WG_TT)
    return ch, B * -(-F // TC_FB) * -(-n_t // ch)


def tf32_wgrad_smem_bytes(C: int, CO: int, K: int, stride: int) -> int:
    """Dynamic shared memory of the fp32 tensor-core K2b (``csrc/
    tconv_wgrad.cu::wg32_layout``): the ring of x's window (16 positions
    pad16(C) raised to an odd multiple of 8 floats apart, 20 floats a row at C
    = 1; a tile's window and the next tile's rows, tiles of 8 frames) and the
    ring of two tiles of dy (pad8(CO) raised likewise)."""
    rp = TF32_WG_TAP_PITCH if C == 1 else TC_FB * _odd_units(_pad(C, 16))
    nr = _pad((TF32_WG_TT - 1) * stride + K + TF32_WG_TT * stride, 2)
    return 4 * (nr * rp + 2 * TF32_WG_TT * TC_FB * _odd_units(_pad(CO, 8)))


def tc_takes(C: int, CO: int, K: int, stride: int, F: int,
             dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the tensor-core K2 of ``dtype`` takes the conv (forward, or
    dgrad as the conv from CO to C channels at stride 1). fp32 takes any C
    and CO up to 64 whose batch schedule fits the shared memory."""
    if min(C, CO, K, stride, F) < 1 or CO > TC_MAX_CO:
        return False
    if dtype == torch.float32:
        return tf32_smem_bytes(C, CO, K, stride, *_tf32_batch(CO), 1) <= _build.MAX_SMEM_BYTES
    return ((C == 1 or C % 2 == 0) and tc_granule(C, F) > 0
            and tc_smem_bytes(C, CO, K, stride) <= _build.MAX_SMEM_BYTES)


def tc_wgrad_takes(C: int, CO: int, K: int, stride: int, F: int,
                   dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the tensor-core K2b of ``dtype`` takes the shape."""
    units, _ = tc_wgrad_units(C, K)
    if min(C, CO, K, stride, F) < 1 or CO > TC_MAX_CO or units > TC_WARPS * TC_UMAX:
        return False
    if dtype == torch.float32:
        return tf32_wgrad_smem_bytes(C, CO, K, stride) <= _build.MAX_SMEM_BYTES
    return (CO % 2 == 0 and (C == 1 or C % 2 == 0) and tc_granule(C, F) > 0
            and tc_granule(CO, F) > 0
            and tc_wgrad_smem_bytes(C, CO, K, stride) <= _build.MAX_SMEM_BYTES)


def wide_groups(CO: int) -> int:
    """Row groups of the wide kernels: a row takes CO / 4 threads."""
    return max(1, WIDE_THREADS // (CO // WIDE_V))


def _span(elems: int, item: int) -> int:
    return _pad(elems * item, 16) + WIDE_SLOT


def wide_layout(F: int, C: int, CO: int, K: int, stride: int, item: int,
                kind: str = "conv") -> Tuple[int, int]:
    """(frames a tile, dynamic shared memory) of the wide K2 (``csrc/
    tconv_wide.cu::fwd_layout``: two window buffers) or K2b (``kind``
    "wgrad", ``wg_layout``: a ring of stages of dy's rows and x's window, or
    the row groups' sums where they are larger), at ``item`` bytes an
    element."""
    if kind == "wgrad":
        tt = min(WIDE_WG_MAX_TT, max(1, WIDE_WG_STAGE_BYTES // (F * CO * item)))
        w = (tt - 1) * stride + K
        stage = _span(tt * F * CO, item) + _span(w * F * C, item)
        return tt, WIDE_HEAD + max(WIDE_WG_STAGES * stage, wide_groups(CO) * K * C * CO * 4)
    tt = max(1, WIDE_FWD_ROWS * wide_groups(CO) // F)
    w = (tt - 1) * stride + K
    return tt, WIDE_HEAD + 2 * _span(w * F * C, item)


def wide_takes(C: int, CO: int, K: int, stride: int, F: int,
               dtype: torch.dtype = torch.bfloat16, kind: str = "conv") -> bool:
    """Whether the wide K2 (``kind`` "conv") or K2b ("wgrad") takes the conv
    (C twin ``w2l_time_conv_wide_takes``): 64 < CO <= 1024 in whole 4-channel
    vectors, K*C <= 16, the shared memory within a block's. dgrad never."""
    if kind == "dgrad" or min(C, K, stride, F) < 1 or CO <= TC_MAX_CO or CO % WIDE_V \
            or CO > WIDE_THREADS * WIDE_V or K * C > WIDE_MAX_TAPS:
        return False
    item = 4 if dtype == torch.float32 else 2
    return wide_layout(F, C, CO, K, stride, item, kind)[1] <= _build.MAX_SMEM_BYTES


def wide_plan(B: int, Tout: int, F: int, C: int, CO: int, K: int, stride: int, item: int,
              sms: int, kind: str = "conv") -> Tuple[int, int, int]:
    """(frames a tile, tiles a block, blocks) of a wide launch (C twin
    ``w2l_time_conv_wide_plan``): the tiles of every batch row in order, cut
    into one contiguous run a block for as many blocks as the card holds at
    once (one or two an SM)."""
    tt, smem = wide_layout(F, C, CO, K, stride, item, kind)
    tiles = B * -(-Tout // tt)
    nb = min(tiles, sms * tc_blocks_per_sm(smem))
    ch = -(-tiles // nb)
    return tt, ch, -(-tiles // ch)


def cc_fb(C: int, K: int, stride: int, F: int) -> int:
    """Frequencies a block of the CUDA-core K2 takes: its window within
    ``_WINDOW_BYTES``, at least one."""
    rows = (CC_TT - 1) * stride + K
    return max(1, min(F, _MAX_FB, _WINDOW_BYTES // (rows * (C | 1) * 4)))


def cc_smem_bytes(C: int, CO: int, K: int, stride: int, F: int = _MAX_FB) -> int:
    """Dynamic shared memory of the CUDA-core K2 (``csrc/tconv.cu::launch``):
    the fp32 weight and the fp32 window of Fb frequencies."""
    rows = (CC_TT - 1) * stride + K
    return (K * C * CO + rows * cc_fb(C, K, stride, F) * (C | 1)) * 4


def cc_wgrad_smem_bytes(C: int, CO: int, K: int, stride: int, fb: int) -> int:
    """Dynamic shared memory of the CUDA-core K2b at Fb = fb frequencies
    (``csrc/tconv_wgrad.cu::smem_bytes``)."""
    rows = (CC_TT - 1) * stride + _pad(K, WG_KV)
    return (_pad(K * C * CO, 4) + _pad(rows * fb * (C | 1), 4)
            + CC_TT * fb * _pad(CO, WG_COV)) * 4


def cc_wgrad_fb(C: int, CO: int, K: int, stride: int, F: int) -> int:
    window = cc_wgrad_smem_bytes(C, CO, K, stride, 1) - 4 * _pad(K * C * CO, 4)
    return max(1, min(F, _MAX_FB, _WINDOW_BYTES // window))


def time_conv_takes(K: int, C: int, CO: int, stride: int) -> bool:
    """Whether K2 (forward, and dgrad from CO to C channels at stride 1) and
    K2b take a conv at any F, in either type: the CUDA-core kernels fit it
    (bf16 goes to the tensor cores where ``tc_takes``/``tc_wgrad_takes`` say
    so, else to them). The route of ``models.layers.Conv2D`` asks it."""
    big = 1 << 30
    return (min(K, C, CO, stride) >= 1
            and cc_smem_bytes(C, CO, K, stride, big) <= _build.MAX_SMEM_BYTES
            and cc_smem_bytes(CO, C, K, 1, big) <= _build.MAX_SMEM_BYTES
            and cc_wgrad_smem_bytes(C, CO, K, stride, cc_wgrad_fb(C, CO, K, stride, big))
            <= _build.MAX_SMEM_BYTES)


def tc_blocks_per_sm(smem_bytes: int) -> int:
    """Blocks of a tensor-core kernel resident on one SM: two at most (their
    launch bounds cap a thread at 128 registers), fewer where their shared
    memory (and 1 KB each that the card reserves) does not fit 228 KB."""
    return max(1, min(2, (228 * 1024) // (smem_bytes + 1024)))


def tc_tiles_per_block(B: int, Tout: int, F: int, slots: int) -> int:
    """Time tiles a bf16 tensor-core block walks. A block keeps one (batch
    row, 16 positions) pair and walks consecutive tiles, so that it overlaps
    staging with products and stages each frame once; the pairs' tiles are
    cut into as many runs as fill the ``slots`` (resident blocks of the card)
    in one wave, so no second, mostly idle wave of blocks follows."""
    runs = max(1, slots // (B * -(-F // TC_FB)))
    n_t = -(-Tout // TC_TT)
    return -(-n_t // runs)


def tc_schedule(B: int, Tout: int, F: int, smem_bytes: int, sms: int) -> Tuple[int, int]:
    """(tiles a block walks, blocks) of a bf16 tensor-core launch on ``sms`` SMs."""
    ch = tc_tiles_per_block(B, Tout, F, sms * tc_blocks_per_sm(smem_bytes))
    n_t = -(-Tout // TC_TT)
    return ch, B * -(-F // TC_FB) * -(-n_t // ch)


def route(dtype: torch.dtype, C: int, CO: int, K: int, stride: int, F: int,
          kind: str = "conv") -> str:
    """"tensor cores", "wide" or "CUDA cores": where a call of K2 (``kind``
    "conv", or "dgrad" for the gradient of a conv from C to CO channels) or of
    K2b ("wgrad") in ``dtype`` runs, inputs aligned to 16 bytes."""
    if wide_takes(C, CO, K, stride, F, dtype, kind):
        return "wide"
    if kind == "wgrad":
        takes = tc_wgrad_takes(C, CO, K, stride, F, dtype)
    elif kind == "dgrad":
        takes = tc_takes(CO, C, K, 1, F, dtype)
    else:
        takes = tc_takes(C, CO, K, stride, F, dtype)
    return "tensor cores" if takes else "CUDA cores"


def schedule(dtype: torch.dtype, B: int, Tout: int, C: int, CO: int, K: int, stride: int,
             F: int, sms: int, kind: str = "conv") -> dict:
    """What a tensor-core or wide launch of K2 (``kind`` "conv" or "dgrad",
    Tout the frames it writes) or K2b ("wgrad") runs: its tiles, warps and
    blocks; {} on the CUDA cores."""
    way = route(dtype, C, CO, K, stride, F, kind)
    if way == "wide":
        item = 4 if dtype == torch.float32 else 2
        tt, ch, blocks = wide_plan(B, Tout, F, C, CO, K, stride, item, sms, kind)
        return dict(frames_a_tile=tt, tiles_a_block=ch, blocks=blocks,
                    warps=WIDE_THREADS // 32 + (kind == "wgrad"), row_groups=wide_groups(CO))
    if way != "tensor cores":
        return {}
    if kind == "dgrad":
        C, CO, stride = CO, C, 1
    if kind == "wgrad":
        if dtype == torch.float32:
            tt, (ch, blocks) = TF32_WG_TT, tf32_wgrad_schedule(B, Tout, F, C, CO, K, stride, sms)
        else:
            smem = tc_wgrad_smem_bytes(C, CO, K, stride)
            tt, (ch, blocks) = TC_TT, tc_schedule(B, Tout, F, smem, sms)
        return dict(frames_a_tile=tt, tiles_a_block=ch, blocks=blocks, warps=TC_WARPS,
                    classes=tc_wgrad_units(C, K)[1])
    if dtype == torch.float32:
        mw, mt, ks, ch, blocks = tf32_plan(B, Tout, F, C, CO, K, stride, sms)
        return dict(frames_a_tile=mw * mt, tiles_a_block=ch, blocks=blocks, warps=mw * ks,
                    frames_a_warp=mt, tap_splits=ks)
    ch, blocks = tc_schedule(B, Tout, F, tc_smem_bytes(C, CO, K, stride), sms)
    return dict(frames_a_tile=TC_TT, tiles_a_block=ch, blocks=blocks, warps=TC_WARPS)


def out_frames(T: int, K: int, stride: int, pads: Tuple[int, int]) -> int:
    return (pads[0] + T + pads[1] - K) // stride + 1


def time_conv_plain(x: torch.Tensor, w: torch.Tensor, F: int, stride: int = 1,
                    pads: Tuple[int, int] = (0, 0),
                    bias: Optional[torch.Tensor] = None,
                    relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`time_conv`: the sum over taps of
    ``tconv.py::time_conv_reference``, accumulated in fp32."""
    _build.disable_tf32()
    B, T, D = x.shape
    K, C, CO = w.shape
    xp = torch.nn.functional.pad(x, (0, 0, pads[0], pads[1])).reshape(B, -1, F, C)
    Tout = (xp.shape[1] - K) // stride + 1
    wf = w.float()
    out = torch.zeros((B, Tout, F, CO), dtype=torch.float32, device=x.device)
    span = (Tout - 1) * stride + 1
    for k in range(K):
        out += torch.einsum("btfc,cd->btfd", xp[:, k:k + span:stride].float(), wf[k])
    if bias is not None:
        out += bias.float()
    if relu:
        out = torch.relu(out)
    return out.reshape(B, Tout, F * CO).to(x.dtype)


def time_conv_dgrad_plain(dy: torch.Tensor, w: torch.Tensor, F: int, T: int,
                          stride: int = 1, pads: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain PyTorch version of :func:`time_conv_dgrad`, by the recipe of
    ``tconv.py::_time_conv_bwd_rule``: dy zero-stuffed to stride 1, correlated
    with the flipped weight (K, CO, C) under pads (K-1-lp, enough to reach T
    frames), then cut to T."""
    K, C, CO = w.shape
    lp = pads[0]
    B, Tout, _ = dy.shape
    dyd = dy
    if stride > 1:
        dyd = dy.new_zeros((B, (Tout - 1) * stride + 1, dy.shape[2]))
        dyd[:, ::stride] = dy
    front = K - 1 - lp
    if front < 0:  # more left pad than taps: the first -front frames of dyd touch no x
        dyd, front = dyd[:, -front:], 0
    back = max(T + K - 1 - front - dyd.shape[1], 0)
    wt = w.flip(0).transpose(1, 2).contiguous()
    return time_conv_plain(dyd, wt, F, 1, (front, back))[:, :T]


def time_conv_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, K: int, F: int,
                          stride: int = 1, pads: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain PyTorch version of :func:`time_conv_wgrad`: (K, C, CO) float32,
    one einsum per tap, accumulated in fp32."""
    _build.disable_tf32()
    B, T, D = x.shape
    C = D // F
    Tout = dy.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, pads[0], pads[1])).reshape(B, -1, F, C).float()
    g = dy.reshape(B, Tout, F, -1).float()
    span = (Tout - 1) * stride + 1
    return torch.stack([torch.einsum("btfc,btfd->cd", xp[:, k:k + span:stride], g)
                        for k in range(K)])


def _check(name: str, x: torch.Tensor, w_shape, F: int, stride: int) -> None:
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: {x.dtype} is not one of float32, bfloat16")
    K, C, CO = w_shape
    if x.dim() != 3 or x.shape[2] != F * C or stride < 1 or min(K, C, CO) < 1:
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, w {tuple(w_shape)}, "
                         f"F={F}, stride={stride}")


def _launch_conv(x, w, bias, F, stride, lp, Tout, relu, dil, wide=False) -> torch.Tensor:
    """K2 on checked CUDA tensors: output frame t reads the frames
    t*stride - lp + k of x dilated by ``dil``; frames outside are zero.
    ``wide``: a forward conv, which the wide route may take (dgrad never)."""
    B, T, _ = x.shape
    K, C, CO = w.shape
    lib = _build.library()
    y = torch.empty((B, Tout, F * CO), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    bias_ptr = None if bias is None else bias.data_ptr()
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if wide and aligned and wide_takes(C, CO, K, stride, F, x.dtype):
        _, ch, _ = wide_plan(B, Tout, F, C, CO, K, stride, x.element_size(),
                             _build.sm_count(x.device))
        rc = lib.w2l_time_conv_wide(
            x.data_ptr(), w.data_ptr(), bias_ptr, y.data_ptr(), _build.DTYPE_CODES[x.dtype],
            B, T, F, C, CO, K, stride, lp, Tout, int(relu), ch, _build.stream_ptr(x))
    elif x.dtype == torch.float32 and aligned and tc_takes(C, CO, K, stride, F, x.dtype):
        mw, mt, ks, ch, _ = tf32_plan(B, Tout, F, C, CO, K, stride, _build.sm_count(x.device))
        rc = lib.w2l_time_conv_tf32(
            x.data_ptr(), w.data_ptr(), bias_ptr, y.data_ptr(), B, T, F, C, CO, K, stride, lp,
            Tout, int(relu), dil, mw, mt, ks, ch, tf32_granule(C, F), _build.stream_ptr(x))
    elif x.dtype == torch.bfloat16 and aligned and tc_takes(C, CO, K, stride, F) \
            and y.data_ptr() % 4 == 0:
        ch, _ = tc_schedule(B, Tout, F, tc_smem_bytes(C, CO, K, stride),
                            _build.sm_count(x.device))
        rc = lib.w2l_time_conv_tc(
            x.data_ptr(), w.data_ptr(), bias_ptr, y.data_ptr(), B, T, F, C, CO, K, stride,
            lp, Tout, int(relu), dil, ch, tc_granule(C, F), _build.stream_ptr(x))
    else:
        rc = lib.w2l_time_conv(
            x.data_ptr(), w.data_ptr(), bias_ptr, y.data_ptr(), _build.DTYPE_CODES[x.dtype],
            B, T, F, C, CO, K, stride, lp, Tout, cc_fb(C, K, stride, F), int(relu), dil,
            _build.stream_ptr(x))
    _build.check(rc, "time_conv")
    _build.LAUNCHES["time_conv"] += 1
    return y


def time_conv_dgrad(dy: torch.Tensor, w: torch.Tensor, F: int, T: int, stride: int = 1,
                    pads: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Gradient of :func:`time_conv` (without bias and ReLU) with respect to
    x: ``dx[b, u, f, c] = sum_{k,co} dy[b, (u + lp - k) / stride, f, co] *
    w[k, c, co]`` over the taps where the division is exact.

    dy (B, Tout, F*CO) and w (K, C, CO) of one dtype; returns (B, T, F*C).
    It is K2 itself with stride 1 on the flipped weight (K, CO, C), left pad
    K-1-lp and dy dilated by ``stride`` inside the kernel, and counts as a
    ``time_conv`` launch."""
    if dy.device.type == "cpu":
        return time_conv_dgrad_plain(dy, w, F, T, stride, pads)
    _build.require_cuda("time_conv_dgrad", dy, w)
    K, C, CO = w.shape
    _check("time_conv_dgrad", dy, (K, CO, C), F, stride)
    if w.dtype != dy.dtype:
        raise TypeError(f"time_conv_dgrad: dy {dy.dtype} and w {w.dtype} differ")
    wt = w.flip(0).transpose(1, 2).contiguous()
    return _launch_conv(dy, wt, None, F, 1, K - 1 - pads[0], T, False, stride)


def time_conv_wgrad(x: torch.Tensor, dy: torch.Tensor, K: int, F: int, stride: int = 1,
                    pads: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Gradient of :func:`time_conv` with respect to w, in float32:
    ``dw[k, c, co] = sum_{b,t,f} xpad[b, t*stride + k, f, c] * dy[b, t, f, co]``.

    x (B, T, F*C) and dy (B, Tout, F*CO) of one dtype. The sum is taken in two
    ordered passes without atomics, so equal inputs give equal bits."""
    if x.device.type == "cpu":
        return time_conv_wgrad_plain(x, dy, K, F, stride, pads)
    _build.require_cuda("time_conv_wgrad", x, dy)
    if dy.dtype != x.dtype or dy.dim() != 3 or dy.shape[0] != x.shape[0] \
            or x.shape[2] % F or dy.shape[2] % F:
        raise ValueError(f"time_conv_wgrad: x {tuple(x.shape)} {x.dtype} and dy "
                         f"{tuple(dy.shape)} {dy.dtype} do not fit F={F}")
    B, T, D = x.shape
    C, CO, Tout = D // F, dy.shape[2] // F, dy.shape[1]
    _check("time_conv_wgrad", x, (K, C, CO), F, stride)
    if Tout != out_frames(T, K, stride, pads):
        raise ValueError(f"time_conv_wgrad: dy has {Tout} frames, the conv gives "
                         f"{out_frames(T, K, stride, pads)}")
    dw = torch.empty((K, C, CO), dtype=torch.float32, device=x.device)
    if B == 0:
        return dw.zero_()
    lib = _build.library()
    sms = _build.sm_count(x.device)
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    if aligned and wide_takes(C, CO, K, stride, F, x.dtype, "wgrad"):
        _, ch, blocks = wide_plan(B, Tout, F, C, CO, K, stride, x.element_size(), sms, "wgrad")
        partial = torch.empty((blocks, K * C * CO), dtype=torch.float32, device=x.device)
        rc = lib.w2l_time_conv_wgrad_wide(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            _build.DTYPE_CODES[x.dtype], B, T, F, C, CO, K, stride, pads[0], Tout, ch,
            _build.stream_ptr(x))
    elif x.dtype == torch.float32 and aligned and tc_wgrad_takes(C, CO, K, stride, F, x.dtype):
        ch, blocks = tf32_wgrad_schedule(B, Tout, F, C, CO, K, stride, sms)
        partial = torch.empty((blocks * tc_wgrad_units(C, K)[1], K * C * CO),
                              dtype=torch.float32, device=x.device)
        rc = lib.w2l_time_conv_wgrad_tf32(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(), B, T, F, C, CO,
            K, stride, pads[0], Tout, ch, tf32_granule(C, F), tf32_granule(CO, F, False),
            _build.stream_ptr(x))
    elif x.dtype == torch.bfloat16 and aligned and tc_wgrad_takes(C, CO, K, stride, F):
        ch, blocks = tc_schedule(B, Tout, F, tc_wgrad_smem_bytes(C, CO, K, stride), sms)
        partial = torch.empty((blocks * tc_wgrad_units(C, K)[1], K * C * CO),
                              dtype=torch.float32, device=x.device)
        rc = lib.w2l_time_conv_wgrad_tc(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(), B, T, F, C, CO,
            K, stride, pads[0], Tout, ch, tc_granule(C, F), tc_granule(CO, F),
            _build.stream_ptr(x))
    else:
        fb = cc_wgrad_fb(C, CO, K, stride, F)
        tiles = B * -(-Tout // CC_TT) * -(-F // fb)
        nb = min(tiles, 2 * sms)
        partial = torch.empty((nb, K * C * CO), dtype=torch.float32, device=x.device)
        rc = lib.w2l_time_conv_wgrad(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            _build.DTYPE_CODES[x.dtype], B, T, F, C, CO, K, stride, pads[0], Tout, fb, nb,
            _build.stream_ptr(x))
    _build.check(rc, "time_conv_wgrad")
    _build.LAUNCHES["time_conv_wgrad"] += 1
    return dw


class _TimeConvFn(torch.autograd.Function):
    """K2 forward; backward = ReLU mask, K2 as dgrad (skipped where x needs
    no gradient), K2b, and the bias gradient as a float32 sum."""

    @staticmethod
    def forward(ctx, x, w, bias, F, stride, pads, relu):
        Tout = out_frames(x.shape[1], w.shape[0], stride, pads)
        y = _launch_conv(x, w, bias, F, stride, pads[0], Tout, relu, 1, wide=True)
        ctx.save_for_backward(x, w, y if relu else None)
        ctx.conv = (F, stride, pads, bias is not None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        F, stride, pads, has_bias = ctx.conv
        dy = dy.contiguous()  # arrives as a permuted view from the stored layout
        if y is not None:
            dy = dy * (y > 0)
        dx = dw = dbias = None
        if ctx.needs_input_grad[0]:
            dx = time_conv_dgrad(dy, w, F, x.shape[1], stride, pads)
        if ctx.needs_input_grad[1]:
            dw = time_conv_wgrad(x, dy, w.shape[0], F, stride, pads).to(w.dtype)
        if has_bias and ctx.needs_input_grad[2]:
            dbias = dy.reshape(-1, w.shape[2]).sum(0, dtype=torch.float32)
        return dx, dw, dbias, None, None, None, None


def time_conv(x: torch.Tensor, w: torch.Tensor, F: int, stride: int = 1,
              pads: Tuple[int, int] = (0, 0),
              bias: Optional[torch.Tensor] = None,
              relu: bool = False) -> torch.Tensor:
    """Time convolution with in-kernel zero padding and optional bias + ReLU.

    x (B, T, F*C) f-major (element f*C + c of a frame is channel c at
    frequency f); w (K, C, CO) of x's dtype, shared over f; bias (CO,) float32
    or None. Returns (B, Tout, F*CO) of x's dtype with
    ``y[b, t, f, co] = sum_{k,c} xpad[b, t*stride + k, f, c] * w[k, c, co]``,
    xpad = x with pads[0] zero frames before and pads[1] after.
    """
    if x.device.type == "cpu":
        return time_conv_plain(x, w, F, stride, pads, bias, relu)
    tensors = (x, w) if bias is None else (x, w, bias)
    _build.require_cuda("time_conv", *tensors)
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"time_conv: x {x.dtype} and w {w.dtype} must be one of "
                        "float32, bfloat16")
    if bias is not None and (bias.dtype != torch.float32 or bias.dim() != 1):
        raise TypeError("time_conv: bias must be a float32 vector")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError("time_conv: x must be (B, T, F*C) and w (K, C, CO)")
    B, T, D = x.shape
    K, C, CO = w.shape
    lp, rp = pads
    if D != F * C or lp < 0 or rp < 0 or stride < 1:
        raise ValueError(f"time_conv: bad shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, F={F}, stride={stride}, pads={pads}")
    if bias is not None and bias.shape[0] != CO:
        raise ValueError(f"time_conv: bias has {bias.shape[0]} entries, CO={CO}")
    Tout = out_frames(T, K, stride, pads)
    if Tout < 1:
        raise ValueError(f"time_conv: no output frames for T={T}, K={K}, pads={pads}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _TimeConvFn.apply(x, w, bias, F, stride, pads, relu)
    return _launch_conv(x, w, bias, F, stride, lp, Tout, relu, 1, wide=True)
