"""K5 and K5b: the CTC loss on raw logits and its gradient — wrappers, the
autograd function and plain versions. The kernels are in ``csrc/ctc.cu``.
They replace no TPU kernel: the JAX package computes this loss in plain
``jnp`` (``wav2letter_tpu/ops/ctc.py``: a ``lax.scan`` with an analytic
``custom_vjp``). They exist because the library call the port had
(``log_softmax`` then ``F.ctc_loss``) adds its CUDA backward with atomics, so
an update did not replay in bits on the card, and works with -inf, so a row
with no valid alignment got another gradient than JAX's. Here every sum has
one order, and the recursion is JAX's on a finite -1e30.

The function, as ``wav2letter_tpu/ops/ctc.py:31-207`` defines it: logits x
(B, T, N) of any float dtype, computed in fp32; blank N - 1; targets (B, U)
padded with -1 (a target outside [0, N) reads as the blank here, on both
sides); ``logit_len`` taken in [0, T] and ``target_len`` in [0, U]. The
loss is -logZ (B,); a row with no valid alignment gives 1e30 and JAX's
finite gradient. The gradient with respect to x is
``(softmax(x) - posterior) * g`` on frames below ``logit_len``, 0 beyond, in
x's dtype.

On a CPU tensor :func:`ctc_loss` takes :func:`ctc_loss_plain`: JAX's
recursion line by line, a loop over T on (B, L) tensors, with the posterior
by a scatter over the extended labels. On a CUDA tensor it launches K5 (two
launches: the frame rows' logsumexp and gathered log-probabilities, then the
alpha scan) and, where a gradient is wanted, records :class:`_CTCFn`, whose
backward launches K5b (the beta scan into a scratch, with the row's token
slots beside it, then dx, which writes each frame row with a zero posterior,
forms the row's posterior from alpha, beta and logZ, and writes its tokens
again). The scans are bare recursions: a state a thread, its constants in
registers, lp brought ``RING_DEPTH`` frames ahead of the chain. They take
one of two routes for L = 2U + 1 states (``scan_route``; C twins
``w2l_ctc_route``, ``w2l_ctc_block_threads``, ``w2l_ctc_work_bytes``,
``w2l_ctc_work_in_smem``): a block an utterance where L <= 960, the
neighbours through shared memory and lp through a ring of frames in shared
memory that a producer warp fills by bulk copies; else a wide block of 1024
threads whose states are strided, its double buffer in shared memory, or in
a global scratch where 8 bytes a state do not fit there (L > 29,056). No L raises."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

NEG_INF = -1e30  # the JAX package's finite -inf
BLOCK, WIDE = "block", "wide"
RING_DEPTH = 16          # csrc/ctc.cu: frames of lp the block route brings ahead of its chain
BLOCK_MAX_THREADS = 1024
BLOCK_SCAN_MAX = 960     # the block route's scan threads, beside its producer and token warps
WORK_BYTES_PER_STATE = 8  # the wide route's double buffer


def _block_scan_threads(L: int) -> int:
    """The block route's scan threads for L states, a state a thread (the
    kernels add their producer and token warps), 0 past ``BLOCK_SCAN_MAX``."""
    t = -(-L // 32) * 32
    return t if t <= BLOCK_SCAN_MAX else 0


def route(L: int) -> str:
    """The scans' route for L states (C twin ``w2l_ctc_route``: 0, 1)."""
    return BLOCK if _block_scan_threads(L) else WIDE


def block_threads(L: int) -> int:
    """Threads of a scan's chain (C twin ``w2l_ctc_block_threads``): the
    block route's, 1024 on the wide route."""
    return _block_scan_threads(L) or BLOCK_MAX_THREADS


def work_in_smem(L: int) -> bool:
    """Whether the wide route's work (C twin ``w2l_ctc_work_bytes``) fits in
    shared memory (C twin ``w2l_ctc_work_in_smem``); else it goes to a
    global scratch."""
    return WORK_BYTES_PER_STATE * L <= _build.MAX_SMEM_BYTES


def scan_route(L: int) -> Tuple[str, int, bool]:
    """Where the scans run L states: (``BLOCK``, threads, True) or
    (``WIDE``, threads, :func:`work_in_smem`)."""
    r = route(L)
    return r, block_threads(L), r == BLOCK or work_in_smem(L)


def prepare(x: torch.Tensor, targets: torch.Tensor, logit_len: torch.Tensor,
            target_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The integer inputs as the kernels take them: int32, contiguous, on x's
    device, the lengths clamped to [0, T] and [0, U]."""
    T, U = x.shape[1], targets.shape[1]
    i32 = dict(device=x.device, dtype=torch.int32)
    return (targets.to(**i32).contiguous(), logit_len.to(**i32).clamp(0, T).contiguous(),
            target_len.to(**i32).clamp(0, U).contiguous())


def extended_labels(targets: torch.Tensor, N: int) -> torch.Tensor:
    """(B, U) -> (B, 2U + 1) int64: the blank at even positions, the targets
    at odd ones (padding and ids outside [0, N) read as the blank)."""
    B, U = targets.shape
    tgt = targets.long()
    tgt = torch.where((tgt < 0) | (tgt >= N), N - 1, tgt)
    ext = torch.full((B, 2 * U + 1), N - 1, dtype=torch.long, device=targets.device)
    ext[:, 1::2] = tgt
    return ext


def _masks(ext: torch.Tensor, target_len: torch.Tensor):
    """(allow_skip, valid), both (B, L) bool, as ``_ctc_masks``."""
    L = ext.shape[1]
    pos = torch.arange(L, device=ext.device)[None, :]
    prev2 = F.pad(ext, (2, 0), value=-1)[:, :L]
    allow_skip = (pos % 2 == 1) & (ext != prev2)
    return allow_skip, pos < 2 * target_len.long()[:, None] + 1


def _lse3(a0, a1, a2, neg):
    m = torch.maximum(torch.maximum(a0, a1), a2)
    ms = torch.maximum(m, neg)
    return ms + torch.log(torch.exp(a0 - ms) + torch.exp(a1 - ms) + torch.exp(a2 - ms))


def ctc_fwd_plain(x: torch.Tensor, targets: torch.Tensor, logit_len: torch.Tensor,
                  target_len: torch.Tensor):
    """Plain PyTorch version of :func:`ctc_fwd`: ``_ctc_fwd_impl`` and
    ``_forward_alphas`` line by line. Returns (loss (B,), alpha (T, B, L),
    lse (B, T), lp (T, B, L), logZ (B,)), all fp32."""
    x32 = x.float()
    B, T, N = x.shape
    ext = extended_labels(targets, N)
    L = ext.shape[1]
    allow_skip, valid = _masks(ext, target_len)
    neg = torch.tensor(NEG_INF, device=x.device)
    lse = torch.logsumexp(x32, dim=-1)
    lp = (torch.gather(x32, 2, ext[:, None, :].expand(B, T, L)) - lse[..., None])
    lp = lp.transpose(0, 1).contiguous()
    pos = torch.arange(L, device=x.device)[None, :]
    a = torch.where((pos < 2) & valid, lp[0], neg)
    alpha = [a]
    for t in range(1, T):
        a1 = F.pad(a, (1, 0), value=NEG_INF)[:, :L]
        a2 = torch.where(allow_skip, F.pad(a, (2, 0), value=NEG_INF)[:, :L], neg)
        a = torch.where(valid, _lse3(a, a1, a2, neg) + lp[t], neg)
        alpha.append(a)
    alpha = torch.stack(alpha)
    rows = torch.arange(B, device=x.device)
    final = alpha[(logit_len.long() - 1).clamp(0, T - 1), rows]
    tl = target_len.long()
    aN = final[rows, 2 * tl]
    aN1 = torch.where(tl > 0, final[rows, (2 * tl - 1).clamp(min=0)], neg)
    m = torch.maximum(aN, aN1)
    logz = m + torch.log(torch.exp(aN - m) + torch.exp(aN1 - m))
    return -logz, alpha, lse, lp, logz


def ctc_betas_plain(lp: torch.Tensor, targets: torch.Tensor, logit_len: torch.Tensor,
                    target_len: torch.Tensor, N: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`ctc_betas`: ``_backward_betas`` line by
    line on lp (T, B, L) for N classes. Returns beta (T, B, L) fp32."""
    T = lp.shape[0]
    ext = extended_labels(targets, N)
    L = ext.shape[1]
    allow_skip, valid = _masks(ext, target_len)
    neg = torch.tensor(NEG_INF, device=lp.device)
    ll, tl = logit_len.long(), target_len.long()
    pos = torch.arange(L, device=lp.device)[None, :]
    skip_from = F.pad(allow_skip, (0, 2), value=False)[:, 2:]
    last = 2 * tl[:, None]
    final_beta = torch.where(((pos == last) | (pos == (last - 1).clamp(min=0))) & valid,
                             torch.zeros((), device=lp.device), neg)
    beta = torch.where(ll[:, None] == T, final_beta, neg)
    betas = [beta]
    for t in range(T - 2, -1, -1):
        b = beta + lp[t + 1]
        b1 = F.pad(b, (0, 1), value=NEG_INF)[:, 1:]
        b2 = torch.where(skip_from, F.pad(b, (0, 2), value=NEG_INF)[:, 2:], neg)
        comb = torch.where(valid, _lse3(b, b1, b2, neg), neg)
        beta = torch.where((ll == t + 1)[:, None], final_beta, comb)
        betas.append(beta)
    return torch.stack(betas[::-1])


def ctc_bwd_plain(g: torch.Tensor, x: torch.Tensor, targets: torch.Tensor,
                  logit_len: torch.Tensor, target_len: torch.Tensor, alpha: torch.Tensor,
                  lse: torch.Tensor, lp: torch.Tensor, logz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ctc_bwd`: :func:`ctc_betas_plain`,
    then ``_ctc_bwd`` line by line, the posterior by a scatter over the
    extended labels. Returns dx of x's dtype."""
    B, T, N = x.shape
    ext = extended_labels(targets, N)
    L = ext.shape[1]
    _, valid = _masks(ext, target_len)
    ll = logit_len.long()
    betas = ctc_betas_plain(lp, targets, logit_len, target_len, N)
    gamma = torch.exp(torch.clamp(alpha + betas - logz[None, :, None], -80.0, 80.0))
    t_mask = torch.arange(T, device=x.device)[:, None] < ll[None, :]
    gamma = torch.where(t_mask[:, :, None] & valid[None], gamma, 0.0)
    post = torch.zeros((B, T, N), device=x.device).scatter_add_(
        2, ext[:, None, :].expand(B, T, L), gamma.transpose(0, 1))
    sm = torch.exp(x.float() - lse[:, :, None])
    scale = torch.where(t_mask.T, g.float()[:, None], 0.0)
    return ((sm - post) * scale[:, :, None]).to(x.dtype)


def _check(name, x, targets, logit_len, target_len):
    _build.require_cuda(name, x, targets, logit_len, target_len)
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: logits {x.dtype} must be float32 or bfloat16")
    if x.dim() != 3:
        raise ValueError(f"{name}: logits (B, T, N); got {tuple(x.shape)}")
    _check_ints(name, x.shape[0], targets, logit_len, target_len)


def _check_ints(name, B, targets, logit_len, target_len):
    if targets.dim() != 2 or targets.shape[0] != B:
        raise ValueError(f"{name}: targets (B, U) for B = {B}; got {tuple(targets.shape)}")
    for t, what in ((targets, "targets"), (logit_len, "logit_len"), (target_len, "target_len")):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32 (see prepare)")
    if logit_len.shape != (B,) or target_len.shape != (B,):
        raise ValueError(f"{name}: lengths must be (B,)")


def _work(L: int, B: int, device) -> torch.Tensor:
    """The wide route's global scratch, where its work does not fit in
    shared memory; None elsewhere."""
    if route(L) != WIDE or work_in_smem(L):
        return None
    return torch.empty((B * WORK_BYTES_PER_STATE * L // 4,), dtype=torch.float32, device=device)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def ctc_fwd(x: torch.Tensor, targets: torch.Tensor, logit_len: torch.Tensor,
            target_len: torch.Tensor):
    """K5 on inputs from :func:`prepare`: (loss (B,), alpha (T, B, L), lse
    (B, T), lp (T, B, L), logZ (B,)), fp32. The kernel fills alpha, lse and lp
    on frames below max(logit_len, 1) only: later frames are read by
    nothing."""
    if x.device.type == "cpu":
        return ctc_fwd_plain(x, targets, logit_len, target_len)
    _check("ctc", x, targets, logit_len, target_len)
    B, T, N = x.shape
    U = targets.shape[1]
    L = 2 * U + 1
    f32 = dict(dtype=torch.float32, device=x.device)
    lse, lp, alpha = (torch.empty((B, T), **f32), torch.empty((T, B, L), **f32),
                      torch.empty((T, B, L), **f32))
    loss, logz = torch.empty((B,), **f32), torch.empty((B,), **f32)
    if B == 0:
        return loss, alpha, lse, lp, logz
    if T == 0 or N == 0:
        raise ValueError(f"ctc: needs a frame and a class; got {tuple(x.shape)}")
    work = _work(L, B, x.device)
    rc = _build.library().w2l_ctc_fwd(
        x.data_ptr(), targets.data_ptr(), logit_len.data_ptr(), target_len.data_ptr(),
        lse.data_ptr(), lp.data_ptr(), alpha.data_ptr(), loss.data_ptr(), logz.data_ptr(),
        _ptr(work), _build.DTYPE_CODES[x.dtype], B, T, N, U, _build.MAX_SMEM_BYTES,
        _build.stream_ptr(x))
    _build.check(rc, "ctc")
    _build.LAUNCHES["ctc"] += 1
    return loss, alpha, lse, lp, logz


def _check_floats(name, device, *pairs):
    """Each (tensor, shape) of ``pairs``: float32, that shape, contiguous, on
    ``device``."""
    for t, shape in pairs:
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f"{name}: a float32 {shape} on {device} expected, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _scratch(B: int, T: int, U: int, device):
    """K5b's scratch: the token slots (B, 2U + 1) int32 and beta (T, B, L)."""
    return (torch.empty((B, 2 * U + 1), dtype=torch.int32, device=device),
            torch.empty((T, B, 2 * U + 1), dtype=torch.float32, device=device))


def ctc_betas(lp: torch.Tensor, targets: torch.Tensor, logit_len: torch.Tensor,
              target_len: torch.Tensor, N: int) -> torch.Tensor:
    """K5b's first launch alone, the beta scan, on lp (T, B, L) from
    :func:`ctc_fwd` and the integers from :func:`prepare`, for N classes:
    beta (T, B, L) fp32, filled on frames below logit_len only. It is a
    piece of K5b and counts no launch: :func:`ctc_bwd` counts K5b."""
    if lp.device.type == "cpu":
        return ctc_betas_plain(lp, targets, logit_len, target_len, N)
    _build.require_cuda("ctc_betas", lp, targets, logit_len, target_len)
    T, B, L = lp.shape
    _check_ints("ctc_betas", B, targets, logit_len, target_len)
    U = targets.shape[1]
    _check_floats("ctc_betas", lp.device, (lp, (T, B, 2 * U + 1)))
    slots, beta = _scratch(B, T, U, lp.device)
    if B == 0 or T == 0:
        return beta
    work = _work(L, B, lp.device)
    rc = _build.library().w2l_ctc_betas(
        lp.data_ptr(), targets.data_ptr(), logit_len.data_ptr(), target_len.data_ptr(),
        slots.data_ptr(), beta.data_ptr(), _ptr(work), B, T, N, U, _build.MAX_SMEM_BYTES,
        _build.stream_ptr(lp))
    _build.check(rc, "ctc_betas")
    return beta


def ctc_bwd(g: torch.Tensor, x: torch.Tensor, targets: torch.Tensor, logit_len: torch.Tensor,
            target_len: torch.Tensor, alpha: torch.Tensor, lse: torch.Tensor, lp: torch.Tensor,
            logz: torch.Tensor) -> torch.Tensor:
    """K5b: dx (B, T, N) of x's dtype for the loss gradient g (B,), from the
    forward's alpha, lse, lp and logZ."""
    if x.device.type == "cpu":
        return ctc_bwd_plain(g, x, targets, logit_len, target_len, alpha, lse, lp, logz)
    _check("ctc_bwd", x, targets, logit_len, target_len)
    B, T, N = x.shape
    U = targets.shape[1]
    L = 2 * U + 1
    _check_floats("ctc_bwd", x.device, (g, (B,)), (alpha, (T, B, L)), (lse, (B, T)),
                 (lp, (T, B, L)), (logz, (B,)))
    dx = torch.empty_like(x)
    if B == 0 or T == 0 or N == 0:
        return dx
    slots, beta = _scratch(B, T, U, x.device)
    work = _work(L, B, x.device)
    rc = _build.library().w2l_ctc_bwd(
        x.data_ptr(), lse.data_ptr(), lp.data_ptr(), alpha.data_ptr(), logz.data_ptr(),
        g.data_ptr(), targets.data_ptr(), logit_len.data_ptr(), target_len.data_ptr(),
        slots.data_ptr(), beta.data_ptr(), _ptr(work), dx.data_ptr(),
        _build.DTYPE_CODES[x.dtype], B, T, N, U, _build.MAX_SMEM_BYTES, _build.stream_ptr(x))
    _build.check(rc, "ctc_bwd")
    _build.LAUNCHES["ctc_bwd"] += 1
    return dx


class _CTCFn(torch.autograd.Function):
    """The loss by ``fwd`` (K5 or its plain version); backward = ``bwd`` (K5b
    or its plain version) on the saved x, alpha, lse, lp and logZ."""

    @staticmethod
    def forward(ctx, x, targets, logit_len, target_len, fwd, bwd):
        loss, alpha, lse, lp, logz = fwd(x, targets, logit_len, target_len)
        ctx.bwd = bwd
        ctx.save_for_backward(x, targets, logit_len, target_len, alpha, lse, lp, logz)
        return loss

    @staticmethod
    def backward(ctx, g):
        dx = ctx.bwd(g.float().contiguous(), *ctx.saved_tensors)
        return dx, None, None, None, None, None


def _loss(x, targets, logit_len, target_len, fwd, bwd):
    if x.dtype not in _build.DTYPE_CODES:
        x = x.float()
    x = x.contiguous()
    if x.shape[1] == 0:
        raise ValueError(f"ctc_loss: needs at least one frame; got {tuple(x.shape)}")
    args = prepare(x, targets, logit_len, target_len)
    if torch.is_grad_enabled() and x.requires_grad:
        return _CTCFn.apply(x, *args, fwd, bwd)
    return fwd(x, *args)[0]


def ctc_loss_plain(x: torch.Tensor, targets: torch.Tensor, logit_len: torch.Tensor,
                   target_len: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ctc_loss`, with JAX's analytic
    gradient."""
    return _loss(x, targets, logit_len, target_len, ctc_fwd_plain, ctc_bwd_plain)


def ctc_loss(x: torch.Tensor, targets: torch.Tensor, logit_len: torch.Tensor,
             target_len: torch.Tensor) -> torch.Tensor:
    """Per-sample CTC negative log likelihood (B,), fp32, of raw logits x
    (B, T, N), blank N - 1; differentiable with respect to x. A float dtype
    other than float32 and bfloat16 is computed as float32."""
    if x.device.type == "cpu":
        return ctc_loss_plain(x, targets, logit_len, target_len)
    return _loss(x, targets, logit_len, target_len, ctc_fwd, ctc_bwd)
