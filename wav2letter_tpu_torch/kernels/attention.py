"""K4 and K4b: fused multi-head self-attention with the Transformer-XL
relative-position bias, and its backward — wrappers, the autograd function
and plain versions. The kernels are in ``csrc/attention.cu``; they replace the
TPU kernels ``wav2letter_tpu/ops/pallas/attention.py::fused_mhsa``
(``_mhsa_fwd``) and ``_mhsa_bwd``.

The function, per (batch b, head h), heads being the column blocks of the
(B, T, H*Dh) activations and q already scaled by 1/sqrt(Dh)::

    scores[i, j] = q_i . k_j + q_i . Pwin[j - i + T - 1] + mask[b, j]   (fp32)
    p  = softmax_j(scores)
    pd = where(keep, p / (1 - rate), 0)        (rate > 0 only)
    out_i = sum_j pd[i, j] v_j

``keep`` is a counter hash of (seed, b*H + h, i, j), the same bits as the TPU
kernel's, so a dropout mask is reproduced exactly from its seed by the
kernel, its backward, the plain versions and the JAX package.

On CPU tensors ``mhsa`` takes :func:`mhsa_plain`, which is differentiable
PyTorch code. On CUDA tensors it launches K4 and, where a gradient is wanted,
records :class:`_MhsaFn`, whose backward launches K4b. Nothing but q, k, v,
Pwin, the mask and the seed is saved: K4b recomputes the probabilities.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

_M32 = 0xFFFFFFFF
FWD_CHUNK_BYTES, FWD_VPITCH = 128, 136  # csrc/attention.cu: CHB, VP
FWD_ROWS = (16, 32, 64)  # query rows a K4 block can take, in slabs of 16
BWD_ROWS = (16, 32, 48, 64)  # and a block of K4b's first launch
KEEP_BLOCK = 1 << 22  # counters of the keep mask hashed at once (int64 temporaries)


def hash_rows(T: int) -> int:
    """The row stride of the dropout counter: T rounded up to 16, at least 16
    (the TPU kernel's padded tile; here a number in the formula only)."""
    return -(-max(T, 16) // 16) * 16


def keep_threshold(rate: float) -> int:
    return min(int((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)


def dropout_keep(seed: int, B: int, H: int, T: int, rate: float, device: torch.device,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The keep mask (B, H, T, T) bool: a murmur3-style finalizer over the
    counter ``i * hash_rows(T) + j`` mixed with the seed and ``b*H + h``, in
    uint32 arithmetic (int64 here, masked to 32 bits after every step).
    Computed a block of rows at a time, so that the int64 temporaries stay
    near ``KEEP_BLOCK`` elements whatever T, and written into ``out`` (a bool
    (B, H, T, T) tensor or view) where one is given."""
    keep = torch.empty((B, H, T, T), dtype=torch.bool, device=device) if out is None else out
    j = torch.arange(T, dtype=torch.int64, device=device)[None, :]
    prog = torch.arange(B * H, dtype=torch.int64, device=device).view(B, H, 1, 1)
    mix = ((int(seed) & _M32) * 0x9E3779B9 & _M32) + (prog * 0x85EBCA6B & _M32)
    threshold = keep_threshold(rate)
    rows = max(1, KEEP_BLOCK // max(B * H * T, 1))
    for r0 in range(0, T, rows):
        i = torch.arange(r0, min(r0 + rows, T), dtype=torch.int64, device=device)[:, None]
        x = (i * hash_rows(T) + j + mix).bitwise_and_(_M32)
        x ^= x >> 16
        x.mul_(0x7FEB352D).bitwise_and_(_M32)
        x ^= x >> 15
        x.mul_(0x846CA68B).bitwise_and_(_M32)
        x ^= x >> 16
        torch.lt(x, threshold, out=keep[:, :, r0:r0 + rows])
    return keep


def _shear_index(T: int, device: torch.device) -> torch.Tensor:
    """(T, T) int64: the row of Pwin that scores[i, j] meets, j - i + T - 1."""
    ar = torch.arange(T, device=device)
    return ar[None, :] - ar[:, None] + (T - 1)


def _probs(qh, kh, pos, mask_bias, idx):
    """fp32 probabilities (B, H, T, T) from fp32 heads (B, T, H, Dh)."""
    B, T, H, _ = qh.shape
    qk = torch.einsum("bthd,bshd->bhts", qh, kh)
    qp = torch.einsum("bthd,rd->bhtr", qh, pos)
    bias = qp.gather(-1, idx.expand(B, H, T, T))
    scores = qk + bias + mask_bias.float()[:, None, None, :]
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def mhsa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos_win: torch.Tensor,
               mask_bias: torch.Tensor, n_heads: int, dropout_rate: float = 0.0,
               seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`mhsa`: the same arithmetic with
    ``einsum``, the shear as a gather index and the keep hash. Inputs of
    either type are widened to fp32, sums are fp32, p is rounded to v's type
    before ``p . v`` and the output to q's."""
    _build.disable_tf32()
    B, T, HD = q.shape
    H, Dh = n_heads, HD // n_heads
    qh, kh, vh = (t.float().view(B, T, H, Dh) for t in (q, k, v))
    pos = pos_win.to(q.dtype).float()
    p = _probs(qh, kh, pos, mask_bias, _shear_index(T, q.device))
    if dropout_rate > 0.0:
        keep = dropout_keep(seed, B, H, T, dropout_rate, q.device)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), torch.zeros((), device=q.device))
    out = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), vh)
    return out.reshape(B, T, HD).to(q.dtype)


def mhsa_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos_win: torch.Tensor,
                   mask_bias: torch.Tensor, g: torch.Tensor, n_heads: int,
                   dropout_rate: float = 0.0, seed: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`mhsa_bwd`: recompute p and the keep
    mask, then the five products written out. Returns dq, dk, dv of q's type
    and dPwin (2T-1, Dh) in fp32."""
    _build.disable_tf32()
    B, T, HD = q.shape
    H, Dh = n_heads, HD // n_heads
    dt = q.dtype
    qh, kh, vh, gh = (t.to(dt).float().view(B, T, H, Dh) for t in (q, k, v, g))
    pos = pos_win.to(dt).float()
    idx = _shear_index(T, q.device).expand(B, H, T, T)
    p = _probs(qh, kh, pos, mask_bias, idx)
    dpd = torch.einsum("bthd,bshd->bhts", gh, vh)
    if dropout_rate > 0.0:
        keep = dropout_keep(seed, B, H, T, dropout_rate, q.device)
        scale = 1.0 / (1.0 - dropout_rate)
        zero = torch.zeros((), device=q.device)
        pd, dp = torch.where(keep, p * scale, zero), torch.where(keep, dpd * scale, zero)
    else:
        pd, dp = p, dpd
    dv = torch.einsum("bhts,bthd->bshd", pd.to(dt).float(), gh)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    # the inverse shear: dqp[i, r] = ds[i, j] where j - i + T - 1 = r, else 0
    dqp = torch.zeros((B, H, T, 2 * T - 1), device=q.device).scatter_(-1, idx, ds)
    dq = torch.einsum("bhts,bshd->bthd", ds, kh) + torch.einsum("bhtr,rd->bthd", dqp, pos)
    dk = torch.einsum("bhts,bthd->bshd", ds, qh)
    dpos = torch.einsum("bhtr,bthd->rd", dqp, qh)
    return (dq.reshape(B, T, HD).to(dt), dk.reshape(B, T, HD).to(dt),
            dv.reshape(B, T, HD).to(dt), dpos)


def _check(name, q, k, v, pos_win, mask_bias, n_heads, rate):
    """Raise on what the kernels do not take; returns (B, T, H, Dh)."""
    _build.require_cuda(name, q, k, v, pos_win, mask_bias)
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype \
            or pos_win.dtype != q.dtype:
        raise TypeError(f"{name}: q {q.dtype}, k {k.dtype}, v {v.dtype}, pos {pos_win.dtype} "
                        "must be one of float32, bfloat16, alike")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must be (B, T, H*Dh) alike; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, HD = q.shape
    if HD % n_heads:
        raise ValueError(f"{name}: width {HD} is not a multiple of {n_heads} heads")
    Dh = HD // n_heads
    if B == 0 or T == 0:
        raise ValueError(f"{name}: empty input {tuple(q.shape)}")
    if Dh % 8:
        raise ValueError(f"{name}: the head width {Dh} must be a multiple of 8")
    if pos_win.shape != (2 * T - 1, Dh):
        raise ValueError(f"{name}: pos_win must be (2T-1, Dh) = ({2 * T - 1}, {Dh}); got "
                         f"{tuple(pos_win.shape)}")
    if mask_bias.shape != (B, T) or mask_bias.dtype != torch.float32:
        raise ValueError(f"{name}: mask_bias must be float32 (B, T); got {mask_bias.dtype} "
                         f"{tuple(mask_bias.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v, pos_win)):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{name}: dropout rate {rate} outside [0, 1)")
    return B, T, n_heads, Dh


def _hash_args(T: int, rate: float, seed: int):
    if not 0 <= int(seed) < 2 ** 31:
        raise ValueError(f"mhsa: seed {seed} outside [0, 2^31)")
    return hash_rows(T), int(seed), float(rate), keep_threshold(rate), 1.0 / (1.0 - rate)


def fwd_smem_bytes(rows: int, T: int, Dh: int, itemsize: int) -> int:
    """Dynamic shared memory of one K4 block of ``rows`` query rows
    (``csrc/attention.cu::fwd_layout``): the rows' fp32 scores, T rounded up
    to 8 plus 4 a row; the q tile, Dh * itemsize rounded up to 32 bytes plus
    16 a row; two staging buffers, each a chunk of 128 / itemsize rows of k
    or Pwin, or of v (128 columns, 136 elements a row)."""
    chunk = FWD_CHUNK_BYTES // itemsize
    sp = -(-T // 8) * 8 + 4
    kp = -(-Dh * itemsize // 32) * 32 + 16
    stage = max(chunk * kp, chunk * FWD_VPITCH * itemsize)
    return rows * sp * 4 + rows * kp + 2 * stage


def fwd_tile_rows(B: int, H: int, T: int, Dh: int, itemsize: int, sms: int = 132,
                  choices: Tuple[int, ...] = FWD_ROWS) -> int:
    """Query rows per K4 block (and, of ``BWD_ROWS``, per block of K4b's
    first launch). Every block stages all of its head's k, v and
    T + rows - 1 rows of Pwin through its SM, and issuing those copies takes
    a large share of its time (``PERF.md``): so the fewest rows (most blocks,
    most SMs busy) whose blocks still fit one a SM, else the most rows
    (fewest copies); of ``choices``, among those whose shared memory fits.
    Raises where none fits."""
    fits = [r for r in choices
            if fwd_smem_bytes(r, T, Dh, itemsize) <= _build.MAX_SMEM_BYTES]
    if not fits:
        raise ValueError(f"mhsa: T={T}, Dh={Dh} need {fwd_smem_bytes(16, T, Dh, itemsize)} "
                         f"bytes of shared memory a block, over {_build.MAX_SMEM_BYTES}")
    return next((r for r in fits if B * H * -(-T // r) <= sms), fits[-1])


# K4b (``csrc/attention.cu``): launch 1 has K4's layout; launch 2 stages a
# tile of at most 64 keys, launch 3 a window of ds for 64 rows of Pwin
BWD_KEYS_ROWS, BWD_POS_ROWS = 64, 64


def bwd_columns(Dh: int) -> int:
    """The columns of K4b's outputs a block of them: 64, 128 or 192, one
    block for a head of up to 192 (``csrc/attention.cu::bwd_pw``)."""
    return 64 * (3 if Dh > 128 else 2 if Dh > 64 else 1)


def bwd_smem_bytes(rows: int, T: int, Dh: int, itemsize: int) -> int:
    """Dynamic shared memory of K4b (C twin ``w2l_mhsa_bwd_smem_bytes``), the
    largest of its three launches: the first has K4's layout at ``rows``
    query rows (``fwd_smem_bytes``); the second two buffers, each a chunk of
    128 / itemsize query rows by 64 keys (plus 16 bytes a row) and by
    ``bwd_columns(Dh)`` columns of g or q (plus 8 elements a row); the third
    two buffers, each a window of ds of that many query rows by 64 +
    128 / itemsize + 8 columns, and the same rows of q."""
    chunk = FWD_CHUNK_BYTES // itemsize
    xrows = chunk * (bwd_columns(Dh) + 8) * itemsize
    keys = 2 * (chunk * (BWD_KEYS_ROWS * itemsize + 16) + xrows)
    pos = 2 * (chunk * (BWD_POS_ROWS + chunk + 8) * itemsize + xrows)
    return max(fwd_smem_bytes(rows, T, Dh, itemsize), keys, pos)


def bwd_max_head_dim(itemsize: int) -> int:
    """The widest head K4b takes at all (C twin ``w2l_mhsa_max_head_dim``):
    the largest multiple of 8 whose layout fits a block at T = 1 and 16
    query rows. Nothing else in K4b bounds the head width."""
    Dh = 0
    while bwd_smem_bytes(FWD_ROWS[0], 1, Dh + 8, itemsize) <= _build.MAX_SMEM_BYTES:
        Dh += 8
    return Dh


def mhsa_takes(B: int, T: int, H: int, Dh: int, dtype: torch.dtype,
               backward: bool = False) -> bool:
    """Whether K4 takes the shape and, with ``backward``, K4b too: the limits
    the wrappers raise on, evaluated without a card. Both need a head width
    that is a multiple of 8 and the shared memory of their smallest tile
    (``fwd_smem_bytes``, ``bwd_smem_bytes``; taller tiles only need more).
    K4b's first launch has K4's layout, so the two take the same T."""
    if dtype not in _build.DTYPE_CODES or min(B, T, H) < 1 or Dh < 8 or Dh % 8:
        return False
    item = 2 if dtype == torch.bfloat16 else 4
    if fwd_smem_bytes(FWD_ROWS[0], T, Dh, item) > _build.MAX_SMEM_BYTES:
        return False
    return not backward or bwd_smem_bytes(FWD_ROWS[0], T, Dh, item) <= _build.MAX_SMEM_BYTES


def _launch_fwd(q, k, v, pos_win, mask_bias, n_heads, rate, seed, rows: Optional[int] = None):
    """K4 on CUDA tensors. ``rows``, the query rows a block, is picked from
    the shape by :func:`fwd_tile_rows` unless given (to time the choices)."""
    B, T, H, Dh = _check("mhsa", q, k, v, pos_win, mask_bias, n_heads, rate)
    item = q.element_size()
    if rows is None:
        rows = fwd_tile_rows(B, H, T, Dh, item, _build.sm_count(q.device))
    if rows not in FWD_ROWS or fwd_smem_bytes(rows, T, Dh, item) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"mhsa: {rows} rows a block at T={T}, Dh={Dh} do not fit")
    lib = _build.library()
    out = torch.empty_like(q)
    rc = lib.w2l_mhsa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_win.data_ptr(), mask_bias.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[q.dtype], B, T, H, Dh, *_hash_args(T, rate, seed),
        rows, _build.stream_ptr(q))
    _build.check(rc, "mhsa")
    _build.LAUNCHES["mhsa"] += 1
    return out


def _launch_bwd(q, k, v, pos_win, mask_bias, g, n_heads, rate, seed,
                rows: Optional[int] = None):
    """K4b on CUDA tensors. ``rows``, the query rows a block of its first
    launch, is picked as K4's, of ``BWD_ROWS`` (:func:`fwd_tile_rows`),
    unless given (to time the choices)."""
    B, T, H, Dh = _check("mhsa_bwd", q, k, v, pos_win, mask_bias, n_heads, rate)
    _build.require_cuda("mhsa_bwd", q, g)
    if g.shape != q.shape or g.dtype != q.dtype or g.data_ptr() % 16:
        raise ValueError(f"mhsa_bwd: g must be like q; got {g.dtype} {tuple(g.shape)}")
    item = q.element_size()
    if not mhsa_takes(B, T, H, Dh, q.dtype, backward=True):
        raise ValueError(f"mhsa_bwd: T={T}, Dh={Dh} need {bwd_smem_bytes(16, T, Dh, item)} "
                         f"bytes of shared memory, over {_build.MAX_SMEM_BYTES}")
    sms = _build.sm_count(q.device)
    if rows is None:
        rows = fwd_tile_rows(B, H, T, Dh, item, sms, BWD_ROWS)
    if rows not in BWD_ROWS or bwd_smem_bytes(rows, T, Dh, item) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"mhsa_bwd: {rows} rows a block at T={T}, Dh={Dh} do not fit")
    lib = _build.library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dpos = torch.empty((2 * T - 1, Dh), dtype=torch.float32, device=q.device)
    # scratch between K4b's launches: pd and ds in the working type, rows of T
    # rounded up to 8 (16-byte aligned), and the shares of dPwin of groups of
    # (b, h), at most B * H of them
    pd = torch.empty((B, H, T, -(-T // 8) * 8), dtype=q.dtype, device=q.device)
    ds = torch.empty_like(pd)
    part = torch.empty((B * H, 2 * T - 1, Dh), dtype=torch.float32, device=q.device)
    rc = lib.w2l_mhsa_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_win.data_ptr(), mask_bias.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dpos.data_ptr(),
        pd.data_ptr(), ds.data_ptr(), part.data_ptr(), _build.DTYPE_CODES[q.dtype], B, T, H, Dh,
        *_hash_args(T, rate, seed), rows, sms, _build.stream_ptr(q))
    _build.check(rc, "mhsa_bwd")
    _build.LAUNCHES["mhsa_bwd"] += 1
    return dq, dk, dv, dpos


def mhsa_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos_win: torch.Tensor,
             mask_bias: torch.Tensor, g: torch.Tensor, n_heads: int,
             dropout_rate: float = 0.0, seed: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`mhsa` for the output gradient g (B, T, H*Dh):
    dq, dk, dv of q's type and dPwin (2T-1, Dh) in fp32. Equal inputs give
    equal bits: every sum has one owner and a fixed order."""
    if q.device.type == "cpu":
        return mhsa_bwd_plain(q, k, v, pos_win, mask_bias, g, n_heads, dropout_rate, seed)
    return _launch_bwd(q, k, v, pos_win, mask_bias, g, n_heads, dropout_rate, seed)


class _MhsaFn(torch.autograd.Function):
    """K4 forward; backward = K4b. Gradients for q, k, v and Pwin only."""

    @staticmethod
    def forward(ctx, q, k, v, pos_win, mask_bias, n_heads, rate, seed):
        pos = pos_win.to(q.dtype).contiguous()
        out = _launch_fwd(q, k, v, pos, mask_bias, n_heads, rate, seed)
        ctx.save_for_backward(q, k, v, pos, mask_bias)
        ctx.cfg = (n_heads, rate, seed, pos_win.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, pos, mask_bias = ctx.saved_tensors
        n_heads, rate, seed, pos_dtype = ctx.cfg
        dq, dk, dv, dpos = mhsa_bwd(q, k, v, pos, mask_bias, g.to(q.dtype).contiguous(),
                                    n_heads, rate, seed)
        return dq, dk, dv, dpos.to(pos_dtype), None, None, None, None


def mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos_win: torch.Tensor,
         mask_bias: torch.Tensor, n_heads: int, dropout_rate: float = 0.0,
         seed: int = 0) -> torch.Tensor:
    """Fused attention with the relative-position bias; returns (B, T, H*Dh).

    q (already scaled by 1/sqrt(Dh)), k, v (B, T, H*Dh) of one type, float32
    or bfloat16; pos_win (2T-1, Dh), the rows of the relative-position table
    for offsets -(T-1)..T-1, cast to q's type; mask_bias (B, T) float32, added
    to the scores over keys (0, or -1e30 for padding); ``seed`` a non-negative
    int below 2^31, used when ``dropout_rate`` > 0.
    """
    if q.device.type == "cpu":
        return mhsa_plain(q, k, v, pos_win, mask_bias, n_heads, dropout_rate, seed)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, pos_win)):
        return _MhsaFn.apply(q, k, v, pos_win, mask_bias, n_heads, dropout_rate, seed)
    return _launch_fwd(q, k, v, pos_win.to(q.dtype).contiguous(), mask_bias, n_heads,
                       dropout_rate, seed)


def mhsa_flops(B: int, T: int, H: int, Dh: int, backward: bool = False) -> int:
    """Multiply-adds times two of the function's products: q.k^T, q.Pwin^T and
    p.v forward; g.v^T, pd^T.g, ds.k, dqp.Pwin, ds^T.q and dqp^T.q backward,
    which also recomputes the two score products."""
    return (16 if backward else 6) * B * H * T * T * Dh
