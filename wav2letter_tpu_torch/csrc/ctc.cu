// K5 and K5b: the CTC loss on raw logits and its gradient, as the JAX
// package computes them (wav2letter_tpu/ops/ctc.py: _ctc_fwd_impl,
// _forward_alphas, _backward_betas, _ctc_bwd). That loss is a lax.scan with an
// analytic custom_vjp, not a TPU kernel: these replace no pallas_call. They
// replace the library call the port used before (log_softmax then
// F.ctc_loss), which could give neither of two things the reference has:
// sums in a fixed order (its CUDA backward adds with atomics, so an update
// did not replay in bits on the card) and JAX's arithmetic with a finite
// -1e30 in place of -inf (a row with no valid alignment gets loss 1e30 and
// JAX's finite gradient, not a NaN).
//
// The function, for logits x (B, T, N) (float32 or bfloat16, computed in
// float32), blank N - 1, targets (B, U) padded with -1:
//   ext[s]  (L = 2U + 1)  blank at even s, target[(s - 1) / 2] at odd s
//                         (a target outside [0, N) reads as the blank)
//   lse[b,t] = logsumexp_n x[b,t,n];  lp[t,b,s] = x[b,t,ext[s]] - lse[b,t]
//   alpha / beta: JAX's recursions on -1e30, logZ over the last two states
//   gamma = exp(clip(alpha + beta - logZ, -80, 80)) on t < logit_len, valid s
//   dx[b,t,n] = (exp(x - lse) - sum_{s: ext[s] = n} gamma) * g[b] on
//   t < logit_len, 0 beyond
//
// Four launches, two a direction:
//   (a) ctc_rows_kernel: one block a frame row (b, t < max(logit_len, 1)).
//       Reads the row once in its own dtype, 16-byte vectors where the row
//       allows, an online max and sum in fp32 for lse, then gathers lp.
//   (b) the alpha scan, one utterance a block. Warp route (L <= 160): one
//       warp, a lane holds K = ceil(L / 32) consecutive states in registers,
//       s - 1 and s - 2 from the lane below by __shfl_up_sync, no barrier.
//       Block route (L > 160): up to 1024 threads, states strided over the
//       threads, the step's states double-buffered in shared memory (or,
//       where 20 bytes a state and the beta kernel's 256 static bytes do not
//       fit there, in a global scratch the wrapper gives), one barrier a step. It writes alpha (T, B, L), logZ
//       and the loss.
//   (c) the beta scan, shaped as (b), with the reset at t = logit_len - 1.
//       Each step forms gamma and the posterior of each distinct token of the
//       row: slot 0 the blank (its states' gammas, a lane's in increasing s,
//       then a fixed shuffle tree), slot 1 + u the label at u where u is the
//       first position of its token (the gammas of every position with that
//       token, in increasing s, by a chain precomputed once), other slots
//       token -1. Out: tokens (B, U + 1), values (T, B, U + 1).
//   (d) ctc_grad_kernel: one block a frame row, all T rows. The row's tokens
//       are scattered into a dense tile of shared memory (tokens are
//       distinct: no two writes meet), then x is read once and dx written
//       once, in x's dtype, rounded once from fp32. Rows past logit_len are
//       written as zeros without reading x.
// No atomics: every sum has one order, so the same inputs give the same bits.
//
// Arithmetic: expf and logf (no fast-math intrinsics) and no products inside
// the recursions, so -1e30 saturates as in JAX's fp32 (-1e30 + 1.1 is -1e30;
// a state reached by one scan only has alpha + beta - logZ = 0 on an
// infeasible row and gamma = 1, as in JAX).
//
// Bound on the H100: bytes. The forward reads x once (B*T*N elements); the
// backward reads x once and writes dx once. The scans touch (T, B, L)
// arrays, L ~ 2U, a few MB: latency-bound chains of T steps.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_THREADS = 256;
// states a lane holds at most on the warp route: a step's cost grows with
// them, and from 6 up a block of one state a thread and a barrier a step is
// faster (kernels/time_ctc.py --warp-states at B 16, T 192, bf16: K5 + K5b
// 0.322 ms at L = 33 on the warp against 0.512 on the block, 0.471 against
// 0.534 at L = 129, 0.639 against 0.553 at L = 193). The launches below
// compile K up to this cap and no further; the sweep compiles copies with
// another cap.
constexpr int WARP_MAX_STATES = 5;
constexpr int BLOCK_MAX_THREADS = 1024;
constexpr int WORK_WORDS_PER_STATE = 5;  // block route: beta x2, gamma x2, chain
// static shared memory of the block route's beta kernel (red[2][32]): the
// work goes to shared memory only where it fits beside it
constexpr int BLOCK_STATIC_SMEM = 2 * (BLOCK_MAX_THREADS / 32) * sizeof(float);
constexpr int GRAD_TILE_MAX = 12288;     // classes a (d) block stages at once

__device__ __forceinline__ int ext_at(const int* __restrict__ tg, int s, int N) {
  if ((s & 1) == 0) return N - 1;
  const int v = tg[s >> 1];
  return (v < 0 || v >= N) ? N - 1 : v;
}

// allow_skip[s]: a label position whose token differs from the one at s - 2
__device__ __forceinline__ bool skip_at(const int* __restrict__ tg, int s, int N) {
  if ((s & 1) == 0) return false;
  return s < 2 || ext_at(tg, s, N) != ext_at(tg, s - 2, N);
}

// m = max; msafe = max(m, -1e30); msafe + log(sum exp(a - msafe)), as JAX
__device__ __forceinline__ float lse3(float a0, float a1, float a2) {
  const float m = fmaxf(fmaxf(a0, a1), a2);
  const float ms = fmaxf(m, NEG);
  return ms + logf(expf(a0 - ms) + expf(a1 - ms) + expf(a2 - ms));
}

__device__ __forceinline__ float gamma_of(float a, float b, float lz) {
  return expf(fminf(fmaxf(a + b - lz, -80.f), 80.f));
}

// ---------------------------------------------------------------------------
// 16-byte vectors of a row
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  if constexpr (sizeof(T) == 4) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  uint4 r;
  if constexpr (sizeof(T) == 4) {
    r = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                   __float_as_uint(v[3]));
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  }
  *reinterpret_cast<uint4*>(p) = r;
}

// elements before the first 16-byte boundary of p, at most n
template <typename T>
__device__ __forceinline__ int head_elems(const T* p, int n) {
  const int h = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T));
  return h < n ? h : n;
}

// merge of two (max, sum of exp(v - max)) pairs; an empty pair is (-inf, 0)
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * expf(m - mm)) + (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mm));
  m = mm;
}

// ---------------------------------------------------------------------------
// (a) lse and lp_ext of one frame row
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
ctc_rows_kernel(const T* __restrict__ x, const int* __restrict__ targets,
                const int* __restrict__ logit_len, int B, int T_, int N, int U,
                float* __restrict__ lse_out, float* __restrict__ lp_out) {
  __shared__ float red_m[ROW_THREADS / 32], red_s[ROW_THREADS / 32];
  __shared__ float lse_sh;
  const int row = blockIdx.x;
  const int b = row / T_, t = row % T_;
  if (t >= max(logit_len[b], 1)) return;
  const T* xr = x + static_cast<size_t>(row) * N;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  constexpr int VN = Vec<T>::n;
  const int head = head_elems(xr, N);
  const int nvec = (N - head) / VN;
  const int tail0 = head + nvec * VN;

  float m = -INFINITY, s = 0.f;
  auto add = [&](const float* v, int n) {
    float vm = v[0];
    for (int k = 1; k < n; ++k) vm = fmaxf(vm, v[k]);
    const float mm = fmaxf(m, vm);
    if (mm == -INFINITY) return;
    float acc = m == -INFINITY ? 0.f : s * expf(m - mm);
    for (int k = 0; k < n; ++k) acc += expf(v[k] - mm);
    s = acc;
    m = mm;
  };
  for (int i = tid; i < head; i += ROW_THREADS) {
    const float v = w2l::to_f(xr[i]);
    add(&v, 1);
  }
  for (int k = tid; k < nvec; k += ROW_THREADS) {
    float v[VN];
    load_vec(xr + head + k * VN, v);
    add(v, VN);
  }
  for (int i = tail0 + tid; i < N; i += ROW_THREADS) {
    const float v = w2l::to_f(xr[i]);
    add(&v, 1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(FULL, m, o);
    const float s2 = __shfl_xor_sync(FULL, s, o);
    lse_merge(m, s, m2, s2);
  }
  if (lane == 0) {
    red_m[wid] = m;
    red_s[wid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float mt = red_m[0], st = red_s[0];
    for (int w = 1; w < ROW_THREADS / 32; ++w) lse_merge(mt, st, red_m[w], red_s[w]);
    const float lse = mt + logf(st);
    lse_sh = lse;
    lse_out[static_cast<size_t>(b) * T_ + t] = lse;
  }
  __syncthreads();
  const float lse = lse_sh;
  const int L = 2 * U + 1;
  const int* tg = targets + static_cast<size_t>(b) * U;
  float* lp = lp_out + (static_cast<size_t>(t) * B + b) * L;
  for (int st = tid; st < L; st += ROW_THREADS) lp[st] = w2l::to_f(xr[ext_at(tg, st, N)]) - lse;
}

// ---------------------------------------------------------------------------
// (b) alpha, warp route: lane holds states lane*K .. lane*K + K - 1
template <int K>
__global__ void __launch_bounds__(32)
ctc_alpha_warp_kernel(const float* __restrict__ lp, const int* __restrict__ targets,
                      const int* __restrict__ logit_len, const int* __restrict__ target_len,
                      int B, int N, int U, float* __restrict__ alpha,
                      float* __restrict__ loss, float* __restrict__ logz) {
  const int b = blockIdx.x, lane = threadIdx.x, L = 2 * U + 1;
  const int* tg = targets + static_cast<size_t>(b) * U;
  const int Tf = max(logit_len[b], 1), tl = target_len[b], vlim = 2 * tl + 1;
  const int s0 = lane * K;
  unsigned validm = 0, skipm = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = s0 + j;
    if (s < L && s < vlim) validm |= 1u << j;
    if (s < L && skip_at(tg, s, N)) skipm |= 1u << j;
  }
  float a[K];
  const float* lp0 = lp + static_cast<size_t>(b) * L;
  float* al0 = alpha + static_cast<size_t>(b) * L;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = s0 + j;
    a[j] = (s < 2 && ((validm >> j) & 1)) ? lp0[s] : NEG;
    if (s < L) al0[s] = a[j];
  }
  // lp of the next step is loaded one step ahead: the chain of T steps
  // waits on no load
  float ln[K];
#pragma unroll
  for (int j = 0; j < K; ++j)
    ln[j] = (Tf > 1 && s0 + j < L) ? lp[(static_cast<size_t>(B) + b) * L + s0 + j] : 0.f;
  for (int t = 1; t < Tf; ++t) {
    const size_t off = (static_cast<size_t>(t) * B + b) * L;
    float l[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      l[j] = ln[j];
      if (t + 1 < Tf && s0 + j < L) ln[j] = lp[off + static_cast<size_t>(B) * L + s0 + j];
    }
    float p1 = __shfl_up_sync(FULL, a[K - 1], 1);  // state s0 - 1
    float p2;                                       // state s0 - 2
    if constexpr (K >= 2) {
      p2 = __shfl_up_sync(FULL, a[K - 2], 1);
    } else {
      p2 = __shfl_up_sync(FULL, a[0], 2);
      if (lane == 1) p2 = NEG;
    }
    if (lane == 0) p1 = p2 = NEG;
    float n[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float a1 = j >= 1 ? a[j - 1] : p1;
      float a2 = j >= 2 ? a[j - 2] : (j == 1 ? p1 : p2);
      if (!((skipm >> j) & 1)) a2 = NEG;
      const float c = lse3(a[j], a1, a2);
      n[j] = ((validm >> j) & 1) ? c + l[j] : NEG;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      a[j] = n[j];
      if (s0 + j < L) alpha[off + s0 + j] = a[j];
    }
  }
  // logZ over the last two valid states at frame Tf - 1
  auto pick = [&](int s) {
    float v = NEG;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (s - s0 == j) v = a[j];
    return __shfl_sync(FULL, v, s / K);
  };
  const float aN = pick(2 * tl);
  const float aN1 = pick(max(2 * tl - 1, 0));
  if (lane == 0) {
    const float a1 = tl > 0 ? aN1 : NEG;
    const float m = fmaxf(aN, a1);
    const float lz = m + logf(expf(aN - m) + expf(a1 - m));
    logz[b] = lz;
    loss[b] = -lz;
  }
}

// the block route's per-utterance work area: shared memory where it fits
__device__ __forceinline__ float* work_area(float* smem, float* gwork, int L) {
  return gwork == nullptr ? smem
                          : gwork + static_cast<size_t>(blockIdx.x) * WORK_WORDS_PER_STATE * L;
}

// (b) alpha, block route: states strided over the threads, one barrier a step
__global__ void __launch_bounds__(BLOCK_MAX_THREADS)
ctc_alpha_block_kernel(const float* __restrict__ lp, const int* __restrict__ targets,
                       const int* __restrict__ logit_len, const int* __restrict__ target_len,
                       int B, int N, int U, float* __restrict__ alpha,
                       float* __restrict__ loss, float* __restrict__ logz, float* gwork) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, L = 2 * U + 1;
  const int* tg = targets + static_cast<size_t>(b) * U;
  const int Tf = max(logit_len[b], 1), tl = target_len[b], vlim = 2 * tl + 1;
  float* prev = work_area(smem, gwork, L);
  float* cur = prev + L;
  const float* lp0 = lp + static_cast<size_t>(b) * L;
  for (int s = tid; s < L; s += nt) {
    const float v = (s < 2 && s < vlim) ? lp0[s] : NEG;
    prev[s] = v;
    alpha[static_cast<size_t>(b) * L + s] = v;
  }
  __syncthreads();
  for (int t = 1; t < Tf; ++t) {
    const size_t off = (static_cast<size_t>(t) * B + b) * L;
    for (int s = tid; s < L; s += nt) {
      const float a1 = s >= 1 ? prev[s - 1] : NEG;
      const float a2 = (s >= 2 && skip_at(tg, s, N)) ? prev[s - 2] : NEG;
      const float c = lse3(prev[s], a1, a2);
      const float v = s < vlim ? c + lp[off + s] : NEG;
      cur[s] = v;
      alpha[off + s] = v;
    }
    __syncthreads();
    float* sw = prev;
    prev = cur;
    cur = sw;
  }
  if (tid == 0) {
    const float aN = prev[2 * tl];
    const float a1 = tl > 0 ? prev[max(2 * tl - 1, 0)] : NEG;
    const float m = fmaxf(aN, a1);
    const float lz = m + logf(expf(aN - m) + expf(a1 - m));
    logz[b] = lz;
    loss[b] = -lz;
  }
}

// ---------------------------------------------------------------------------
// (c) the row's distinct tokens: slot 0 the blank, slot 1 + u the label at u
// where u is its token's first position (else -1); chain[u] the next position
// with u's token (-1 at the end), head[u] whether u starts a chain.
__device__ void token_slots(const int* __restrict__ tg, int U, int N, int b, int tid, int nt,
                            int* chain, int* head, int* __restrict__ post_tok) {
  const int blank = N - 1, P = U + 1;
  for (int u = tid; u < U; u += nt) {
    const int tok = ext_at(tg, 2 * u + 1, N);
    bool first = tok != blank;
    int nx = -1;
    if (tok != blank) {
      for (int v = 0; v < u && first; ++v) first = ext_at(tg, 2 * v + 1, N) != tok;
      for (int v = u + 1; v < U; ++v) {
        if (ext_at(tg, 2 * v + 1, N) == tok) {
          nx = v;
          break;
        }
      }
    }
    chain[u] = nx;
    head[u] = first;
    post_tok[static_cast<size_t>(b) * P + 1 + u] = first ? tok : -1;
  }
  if (tid == 0) post_tok[static_cast<size_t>(b) * P] = blank;
}

// the labels' posteriors of one step from the gammas in g, chain by chain
__device__ __forceinline__ void label_posteriors(const float* g, const int* chain, const int* head,
                                                 int U, int tid, int nt, float* __restrict__ out) {
  for (int u = tid; u < U; u += nt) {
    float v = 0.f;
    if (head[u]) {
      v = g[2 * u + 1];
      for (int w = chain[u]; w >= 0; w = chain[w]) v += g[2 * w + 1];
    }
    out[1 + u] = v;
  }
}

// (c) beta, warp route
template <int K>
__global__ void __launch_bounds__(32)
ctc_beta_warp_kernel(const float* __restrict__ lp, const float* __restrict__ alpha,
                     const float* __restrict__ logz, const int* __restrict__ targets,
                     const int* __restrict__ logit_len, const int* __restrict__ target_len,
                     int B, int N, int U, int* __restrict__ post_tok,
                     float* __restrict__ post_val) {
  __shared__ float g[32 * K];
  __shared__ int chain[16 * K], head[16 * K];  // U < 16 K
  const int b = blockIdx.x, lane = threadIdx.x, L = 2 * U + 1, P = U + 1, blank = N - 1;
  const int* tg = targets + static_cast<size_t>(b) * U;
  token_slots(tg, U, N, b, lane, 32, chain, head, post_tok);
  __syncwarp();
  const int Tn = logit_len[b];
  if (Tn <= 0) return;  // no frame: dx is zero and (d) reads no posterior
  const int tl = target_len[b], vlim = 2 * tl + 1;
  const float lz = logz[b];
  const int s0 = lane * K;
  unsigned validm = 0, fromm = 0, blankm = 0;
  float be[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = s0 + j;
    const bool valid = s < L && s < vlim;
    if (valid) validm |= 1u << j;
    if (s + 2 < L && skip_at(tg, s + 2, N)) fromm |= 1u << j;  // s -> s + 2 allowed
    if (s < L && ext_at(tg, s, N) == blank) blankm |= 1u << j;
    const bool fin = s == 2 * tl || s == max(2 * tl - 1, 0);
    be[j] = (fin && valid) ? 0.f : NEG;
  }
  // alpha of frame t and lp of frame t + 1 are loaded one step ahead
  float an[K], ln[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    an[j] = ((validm >> j) & 1) ? alpha[(static_cast<size_t>(Tn - 1) * B + b) * L + s0 + j] : 0.f;
    ln[j] = 0.f;
  }
  for (int t = Tn - 1; t >= 0; --t) {
    const size_t off = (static_cast<size_t>(t) * B + b) * L;
    float al[K], lq[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      al[j] = an[j];
      lq[j] = ln[j];
      if (t > 0 && ((validm >> j) & 1)) an[j] = alpha[off - static_cast<size_t>(B) * L + s0 + j];
      if (t > 0 && s0 + j < L) ln[j] = lp[off + s0 + j];  // lp of frame t, for step t - 1
    }
    if (t < Tn - 1) {
      float bb[K];
#pragma unroll
      for (int j = 0; j < K; ++j) bb[j] = s0 + j < L ? be[j] + lq[j] : NEG;
      float q1 = __shfl_down_sync(FULL, bb[0], 1);  // state s0 + K
      float q2;                                      // state s0 + K + 1
      if constexpr (K >= 2) {
        q2 = __shfl_down_sync(FULL, bb[1], 1);
      } else {
        q2 = __shfl_down_sync(FULL, bb[0], 2);
        if (lane == 30) q2 = NEG;
      }
      if (lane == 31) q1 = q2 = NEG;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float b1 = j + 1 < K ? bb[j + 1] : q1;
        float b2 = j + 2 < K ? bb[j + 2] : (j + 2 == K ? q1 : q2);
        if (!((fromm >> j) & 1)) b2 = NEG;
        const float c = lse3(bb[j], b1, b2);
        be[j] = ((validm >> j) & 1) ? c : NEG;
      }
    }
    float part = 0.f;  // the blank's gammas of this lane, in increasing s
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = s0 + j;
      const float gm = ((validm >> j) & 1) ? gamma_of(al[j], be[j], lz) : 0.f;
      if ((blankm >> j) & 1) part += gm;
      if (s < L) g[s] = gm;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
    __syncwarp();
    float* out = post_val + (static_cast<size_t>(t) * B + b) * P;
    if (lane == 0) out[0] = part;
    label_posteriors(g, chain, head, U, lane, 32, out);
    __syncwarp();
  }
}

// (c) beta, block route: work = beta[2][L], gamma[2][L], chain[L] (chain and
// head), one barrier a step; the blank's sum: a thread's states in
// increasing s, a shuffle tree, then the warps in order
__global__ void __launch_bounds__(BLOCK_MAX_THREADS)
ctc_beta_block_kernel(const float* __restrict__ lp, const float* __restrict__ alpha,
                      const float* __restrict__ logz, const int* __restrict__ targets,
                      const int* __restrict__ logit_len, const int* __restrict__ target_len,
                      int B, int N, int U, int* __restrict__ post_tok,
                      float* __restrict__ post_val, float* gwork) {
  extern __shared__ float smem[];
  __shared__ float red[2][BLOCK_MAX_THREADS / 32];  // BLOCK_STATIC_SMEM
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, L = 2 * U + 1, P = U + 1;
  const int blank = N - 1, lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const int* tg = targets + static_cast<size_t>(b) * U;
  float* work = work_area(smem, gwork, L);
  float* bet[2] = {work, work + L};
  float* gam[2] = {work + 2 * L, work + 3 * L};
  int* chain = reinterpret_cast<int*>(work + 4 * L);
  int* head = chain + U;  // 2U < L
  token_slots(tg, U, N, b, tid, nt, chain, head, post_tok);
  const int Tn = logit_len[b];
  if (Tn <= 0) return;
  const int tl = target_len[b], vlim = 2 * tl + 1;
  const float lz = logz[b];
  __syncthreads();
  int par = 0;
  for (int t = Tn - 1; t >= 0; --t, par ^= 1) {
    const size_t off = (static_cast<size_t>(t) * B + b) * L;
    const float* nxt = bet[par ^ 1];  // beta of frame t + 1
    float* cur = bet[par];
    float* g = gam[par];
    float part = 0.f;
    for (int s = tid; s < L; s += nt) {
      float v;
      if (t == Tn - 1) {
        v = ((s == 2 * tl || s == max(2 * tl - 1, 0)) && s < vlim) ? 0.f : NEG;
      } else {
        const size_t offn = off + static_cast<size_t>(B) * L;
        const float b0 = nxt[s] + lp[offn + s];
        const float b1 = s + 1 < L ? nxt[s + 1] + lp[offn + s + 1] : NEG;
        const float b2 = (s + 2 < L && skip_at(tg, s + 2, N)) ? nxt[s + 2] + lp[offn + s + 2] : NEG;
        const float c = lse3(b0, b1, b2);
        v = s < vlim ? c : NEG;
      }
      cur[s] = v;
      const float gm = s < vlim ? gamma_of(alpha[off + s], v, lz) : 0.f;
      if (ext_at(tg, s, N) == blank) part += gm;
      g[s] = gm;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
    if (lane == 0) red[par][wid] = part;
    __syncthreads();
    float* out = post_val + (static_cast<size_t>(t) * B + b) * P;
    if (tid == 0) {
      float sum = red[par][0];
      for (int w = 1; w < nw; ++w) sum += red[par][w];
      out[0] = sum;
    }
    label_posteriors(g, chain, head, U, tid, nt, out);
  }
}

// ---------------------------------------------------------------------------
// (d) dx of one frame row
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
ctc_grad_kernel(const T* __restrict__ x, const float* __restrict__ lse,
                const float* __restrict__ g, const int* __restrict__ logit_len,
                const int* __restrict__ post_tok, const float* __restrict__ post_val,
                int B, int T_, int N, int U, int tile, T* __restrict__ dx) {
  extern __shared__ float post[];  // [tile]
  const int row = blockIdx.x;
  const int b = row / T_, t = row % T_, tid = threadIdx.x, P = U + 1;
  const T* xr = x + static_cast<size_t>(row) * N;
  T* dr = dx + static_cast<size_t>(row) * N;
  constexpr int VN = Vec<T>::n;
  const bool vec = (reinterpret_cast<uintptr_t>(xr) & 15) == (reinterpret_cast<uintptr_t>(dr) & 15);
  if (t >= logit_len[b]) {
    const int head = vec ? head_elems(dr, N) : N;
    const int nvec = (N - head) / VN;
    const float z[VN] = {};
    for (int i = tid; i < head; i += ROW_THREADS) dr[i] = w2l::from_f<T>(0.f);
    for (int k = tid; k < nvec; k += ROW_THREADS) store_vec(dr + head + k * VN, z);
    for (int i = head + nvec * VN + tid; i < N; i += ROW_THREADS) dr[i] = w2l::from_f<T>(0.f);
    return;
  }
  const float gb = g[b];
  const float ls = lse[static_cast<size_t>(b) * T_ + t];
  const int* tok = post_tok + static_cast<size_t>(b) * P;
  const float* val = post_val + (static_cast<size_t>(t) * B + b) * P;
  for (int c0 = 0; c0 < N; c0 += tile) {
    const int cn = min(tile, N - c0);
    for (int i = tid; i < cn; i += ROW_THREADS) post[i] = 0.f;
    __syncthreads();
    for (int p = tid; p < P; p += ROW_THREADS) {
      const int k = tok[p] - c0;
      if (k >= 0 && k < cn) post[k] = val[p];
    }
    __syncthreads();
    const T* xt = xr + c0;
    T* dt = dr + c0;
    const int head = vec ? head_elems(xt, cn) : cn;
    const int nvec = (cn - head) / VN;
    const int tail0 = head + nvec * VN;
    for (int i = tid; i < head; i += ROW_THREADS)
      dt[i] = w2l::from_f<T>((expf(w2l::to_f(xt[i]) - ls) - post[i]) * gb);
    for (int k = tid; k < nvec; k += ROW_THREADS) {
      const int i0 = head + k * VN;
      float v[VN];
      load_vec(xt + i0, v);
#pragma unroll
      for (int e = 0; e < VN; ++e) v[e] = (expf(v[e] - ls) - post[i0 + e]) * gb;
      store_vec(dt + i0, v);
    }
    for (int i = tail0 + tid; i < cn; i += ROW_THREADS)
      dt[i] = w2l::from_f<T>((expf(w2l::to_f(xt[i]) - ls) - post[i]) * gb);
    __syncthreads();  // post is refilled by the next tile
  }
}

// ---------------------------------------------------------------------------
// plans, with their Python twins in kernels/ctc.py
int warp_states(int L) {
  const int k = (L + 31) / 32;
  return k <= WARP_MAX_STATES ? k : 0;
}

int block_threads(int L) {
  const int t = (L + 31) / 32 * 32;
  return t < BLOCK_MAX_THREADS ? t : BLOCK_MAX_THREADS;
}

size_t work_bytes(int L) {
  return static_cast<size_t>(WORK_WORDS_PER_STATE) * L * sizeof(float);
}

// whether the block route's work goes to shared memory (else the wrapper
// gives a global scratch): the work and the beta kernel's static bytes fit
bool work_in_smem(int L, int max_smem) {
  return work_bytes(L) + BLOCK_STATIC_SMEM <= static_cast<size_t>(max_smem);
}

int grad_tile(int N) {
  const int tiles = (N + GRAD_TILE_MAX - 1) / GRAD_TILE_MAX;
  const int per = (N + tiles - 1) / tiles;
  return (per + 7) / 8 * 8;
}

// the warp route's launches for k = 1 .. WARP_MAX_STATES states a lane
template <int K = 1>
int launch_alpha_warp(int k, const float* lp, const int* tg, const int* ll, const int* tl, int B,
                      int N, int U, float* alpha, float* loss, float* logz, cudaStream_t st) {
  if constexpr (K < WARP_MAX_STATES) {
    if (k > K) return launch_alpha_warp<K + 1>(k, lp, tg, ll, tl, B, N, U, alpha, loss, logz, st);
  }
  ctc_alpha_warp_kernel<K><<<B, 32, 0, st>>>(lp, tg, ll, tl, B, N, U, alpha, loss, logz);
  return static_cast<int>(cudaGetLastError());
}

template <int K = 1>
int launch_beta_warp(int k, const float* lp, const float* alpha, const float* logz, const int* tg,
                     const int* ll, const int* tl, int B, int N, int U, int* ptok, float* pval,
                     cudaStream_t st) {
  if constexpr (K < WARP_MAX_STATES) {
    if (k > K)
      return launch_beta_warp<K + 1>(k, lp, alpha, logz, tg, ll, tl, B, N, U, ptok, pval, st);
  }
  ctc_beta_warp_kernel<K><<<B, 32, 0, st>>>(lp, alpha, logz, tg, ll, tl, B, N, U, ptok, pval);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* x, const int* tg, const int* ll, int B, int T_, int N, int U,
                float* lse, float* lp, cudaStream_t st) {
  ctc_rows_kernel<T><<<B * T_, ROW_THREADS, 0, st>>>(static_cast<const T*>(x), tg, ll, B, T_, N,
                                                     U, lse, lp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_grad(const void* x, const float* lse, const float* g, const int* ll, const int* ptok,
                const float* pval, int B, int T_, int N, int U, void* dx, cudaStream_t st) {
  const int tile = grad_tile(N);
  const size_t smem = static_cast<size_t>(tile) * sizeof(float);
  w2l::allow_smem(ctc_grad_kernel<T>, smem);
  ctc_grad_kernel<T><<<B * T_, ROW_THREADS, smem, st>>>(static_cast<const T*>(x), lse, g, ll,
                                                         ptok, pval, B, T_, N, U, tile,
                                                         static_cast<T*>(dx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K of the warp route for L = 2U + 1 states (1..WARP_MAX_STATES), 0 where the
// block route runs
int w2l_ctc_warp_states(int L) { return warp_states(L); }

// threads of the block route's block
int w2l_ctc_block_threads(int L) { return block_threads(L); }

// bytes of the block route's work area an utterance
int w2l_ctc_work_bytes(int L) { return static_cast<int>(work_bytes(L)); }

// 1 where the block route's work goes to shared memory of max_smem bytes
int w2l_ctc_work_in_smem(int L, int max_smem) { return work_in_smem(L, max_smem) ? 1 : 0; }

// classes a (d) block stages in shared memory at once
int w2l_ctc_grad_tile(int N) { return grad_tile(N); }

// K5: (a) lse (B, T) and lp (T, B, L), then (b) alpha (T, B, L), loss and
// logZ (B,). gwork: the block route's work in global memory (B * work bytes),
// or null for shared memory; the wrapper passes it where the work does not fit.
int w2l_ctc_fwd(const void* x, const void* targets, const void* logit_len,
                const void* target_len, void* lse, void* lp, void* alpha, void* loss,
                void* logz, void* gwork, int dtype, int B, int T, int N, int U, int max_smem,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(targets);
  const int* ll = static_cast<const int*>(logit_len);
  const int* tl = static_cast<const int*>(target_len);
  float* lpf = static_cast<float*>(lp);
  int rc = dtype == w2l::kBFloat16
               ? launch_rows<__nv_bfloat16>(x, tg, ll, B, T, N, U, static_cast<float*>(lse), lpf, st)
               : launch_rows<float>(x, tg, ll, B, T, N, U, static_cast<float*>(lse), lpf, st);
  if (rc != 0) return rc;
  const int L = 2 * U + 1;
  float* al = static_cast<float*>(alpha);
  float* lo = static_cast<float*>(loss);
  float* lz = static_cast<float*>(logz);
  if (const int k = warp_states(L))
    return launch_alpha_warp(k, lpf, tg, ll, tl, B, N, U, al, lo, lz, st);
  const bool in_smem = gwork == nullptr;
  if (in_smem && !work_in_smem(L, max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = in_smem ? work_bytes(L) : 0;
  w2l::allow_smem(ctc_alpha_block_kernel, smem);
  ctc_alpha_block_kernel<<<B, block_threads(L), smem, st>>>(lpf, tg, ll, tl, B, N, U, al, lo, lz,
                                                            static_cast<float*>(gwork));
  return static_cast<int>(cudaGetLastError());
}

// K5b: (c) the row's tokens (B, U + 1) and posteriors (T, B, U + 1), then (d)
// dx (B, T, N) in x's dtype for the loss gradient g (B,).
int w2l_ctc_bwd(const void* x, const void* lse, const void* lp, const void* alpha,
                const void* logz, const void* g, const void* targets, const void* logit_len,
                const void* target_len, void* post_tok, void* post_val, void* gwork, void* dx,
                int dtype, int B, int T, int N, int U, int max_smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(targets);
  const int* ll = static_cast<const int*>(logit_len);
  const int* tl = static_cast<const int*>(target_len);
  const float* lpf = static_cast<const float*>(lp);
  const float* al = static_cast<const float*>(alpha);
  const float* lz = static_cast<const float*>(logz);
  int* ptok = static_cast<int*>(post_tok);
  float* pval = static_cast<float*>(post_val);
  const int L = 2 * U + 1;
  int rc;
  if (const int k = warp_states(L)) {
    rc = launch_beta_warp(k, lpf, al, lz, tg, ll, tl, B, N, U, ptok, pval, st);
  } else {
    const bool in_smem = gwork == nullptr;
    if (in_smem && !work_in_smem(L, max_smem)) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = in_smem ? work_bytes(L) : 0;
    w2l::allow_smem(ctc_beta_block_kernel, smem);
    ctc_beta_block_kernel<<<B, block_threads(L), smem, st>>>(
        lpf, al, lz, tg, ll, tl, B, N, U, ptok, pval, static_cast<float*>(gwork));
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0) return rc;
  const float* lsef = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(g);
  return dtype == w2l::kBFloat16
             ? launch_grad<__nv_bfloat16>(x, lsef, gf, ll, ptok, pval, B, T, N, U, dx, st)
             : launch_grad<float>(x, lsef, gf, ll, ptok, pval, B, T, N, U, dx, st);
}

}  // extern "C"
