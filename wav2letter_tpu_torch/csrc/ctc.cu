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
//   (b) the alpha scan, one utterance a block: the bare recursion, alpha
//       (T, B, L), logZ and the loss.
//   (c) the beta scan, shaped as (b), with the reset at t = logit_len - 1:
//       the bare recursion into a beta scratch (T, B, L). Beside the scan a
//       warp of its own writes the row's token slots once: (B, 2U + 1) ints,
//       slot 0 the blank, slot 1 + u the label at u where u is the first
//       position of its token (else -1), slot U + 1 + u the next position
//       with u's token (-1 at the end).
//   (d) ctc_grad_kernel: one block a frame row, all T rows. It reads x once
//       and writes dx of every class as if its posterior were 0, in x's
//       dtype, rounded once from fp32; meanwhile it forms the row's
//       posterior from alpha, beta and logZ (L floats each, read once, their
//       first loads issued before the pass): the blank's gammas a thread's
//       states in increasing s, then a fixed shuffle tree and the warps in
//       order; each label's gammas along its chain of equal positions in
//       increasing s. After one barrier the row's tokens (distinct: no two
//       writes meet) are written again with their posterior. Rows past
//       logit_len are written as zeros.
// No atomics: every sum has one order, so the same inputs give the same bits.
//
// The scans are chains of T steps: latency, not bytes, bounds them. A step
// is one lse3 (three expf, one logf) and one exchange of the neighbours'
// states; everything else is brought ahead of the chain. Two routes by L:
//   block (L <= 960): a state a thread, its constants in registers once
//         (valid, the skip, the reset), the neighbours through shared
//         memory, double-buffered, one named barrier a step. lp comes
//         through a ring of RING_DEPTH frames in shared memory that a
//         producer warp of the block fills by cp.async.bulk; a scan thread
//         reads a step's lp value one step ahead, waits on nothing but the
//         step's barrier and issues no global load in its chain; the stores
//         of alpha and beta are not waited on. (A warp an utterance with its
//         states in registers, exchanged by __shfl, lost to this at every L:
//         kernels/time_ctc.py's sweep, PERF.md.)
//   wide  (past that): 1024 threads, states strided, the double buffer of
//         8 bytes a state in shared memory where it fits, else in a global
//         scratch the wrapper gives; lp read inside the step. No L raises.
//
// Arithmetic: expf and logf (no fast-math intrinsics) and no products inside
// the recursions, so -1e30 saturates as in JAX's fp32 (-1e30 + 1.1 is -1e30;
// a state reached by one scan only has alpha + beta - logZ = 0 on an
// infeasible row and gamma = 1, as in JAX).
//
// Bound on the H100: bytes. The forward reads x once (B*T*N elements); the
// backward reads x once and writes dx once.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_THREADS = 256;
// frames of lp the block route brings ahead of its chain: the stages of its
// ring (kernels/time_ctc.py --sweep); even
constexpr int RING_DEPTH = 16;
constexpr int BLOCK_MAX_THREADS = 1024;
constexpr int BLOCK_SCAN_MAX = BLOCK_MAX_THREADS - 64;  // beside the producer and token warps
constexpr int RING_HEAD = (8 * RING_DEPTH + 127) / 128 * 128;  // the ring: its mbarriers first
constexpr int WIDE_WORDS_PER_STATE = 2;  // the wide route's double buffer
static_assert(RING_DEPTH % 2 == 0, "the step's buffer half is its parity in the unrolled loop");

// floats of a ring stage: the 16-byte aligned span of a row of L floats
__host__ __device__ inline int ring_row(int L) { return ((L + 3) / 4 + 1) * 4; }

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
// the scans' common pieces

// named barrier 1 over the scan's n threads: the beta kernel's last warp,
// which writes the token slots, does not take part
__device__ __forceinline__ void scan_barrier(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// logZ over the last two valid states of the last frame, and the loss
__device__ __forceinline__ void write_logz(float aN, float aN1, int tl, int b,
                                           float* __restrict__ loss, float* __restrict__ logz) {
  const float a1 = tl > 0 ? aN1 : NEG;
  const float m = fmaxf(aN, a1);
  const float lz = m + logf(expf(aN - m) + expf(a1 - m));
  logz[b] = lz;
  loss[b] = -lz;
}

// The row's token slots (see the header), by threads tid of nt.
__device__ void token_slots(const int* __restrict__ tg, int U, int N, int tid, int nt,
                            int* __restrict__ row) {
  const int blank = N - 1;
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
    row[1 + u] = first ? tok : -1;
    row[U + 1 + u] = nx;
  }
  if (tid == 0) row[0] = blank;
}

// One step of the alpha recursion on a state: a = its alpha, p1 and p2 the
// states just below it; JAX's comb + lp where the state is valid
__device__ __forceinline__ float alpha_step(float a, float p1, float p2, float l, bool valid,
                                            bool skip) {
  const float c = lse3(a, p1, skip ? p2 : NEG);
  return valid ? c + l : NEG;
}

// One step of the beta recursion on a state: bb = its beta + lp of the next
// frame, q1 and q2 the same of the two states just above it
__device__ __forceinline__ float beta_step(float bb, float q1, float q2, bool valid, bool from) {
  const float c = lse3(bb, q1, from ? q2 : NEG);
  return valid ? c : NEG;
}

// ---------------------------------------------------------------------------
// The block route: a state a thread. The step's states go through a double
// buffer in shared memory, declared at file scope so that its address is a
// constant. lp comes through a ring of RING_DEPTH stages in dynamic shared
// memory, each the 16-byte aligned span of one frame's row on an mbarrier,
// filled by cp.async.bulk from a producer warp that takes part in the
// scan's barrier (ring_produce).
__shared__ float scan_buf[2][BLOCK_MAX_THREADS + 2];

struct Ring {
  uint64_t* full;  // [D] one completion a fill
  float* rows;     // [D][row]
  int row;         // floats a stage
};

__device__ __forceinline__ Ring ring_at(unsigned char* smem, int L) {
  return Ring{reinterpret_cast<uint64_t*>(smem), reinterpret_cast<float*>(smem + RING_HEAD),
              ring_row(L)};
}

// Stage s := the row of L floats at `src`: its 16-byte aligned span by one
// bulk copy on the stage's barrier. Only where the span would pass the last
// 16-byte boundary of the array (`last16`: the last row's tail) does the
// rest go by plain loads, before the barrier's arrival releases them.
__device__ __forceinline__ void ring_fill(const Ring& r, int s, const float* src, int L,
                                          uintptr_t last16) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src), a0 = lo & ~uintptr_t(15);
  uintptr_t a1 = (lo + 4u * L + 15) & ~uintptr_t(15);
  float* dst = r.rows + static_cast<size_t>(s) * r.row;
  if (a1 > last16) {
    a1 = last16 > a0 ? last16 : a0;
    for (uintptr_t g = a1 > lo ? a1 : lo; g < lo + 4u * L; g += 4)
      dst[(g - a0) / 4] = *reinterpret_cast<const float*>(g);
  }
  const uint32_t bytes = static_cast<uint32_t>(a1 - a0);
  w2l::mbar_arrive_tx(r.full + s, bytes);
  if (bytes) w2l::bulk_load(dst, reinterpret_cast<const void*>(a0), bytes, r.full + s);
}

// a row's first float in its stage: the row's start past its 16-byte boundary
__device__ __forceinline__ int ring_shift(const float* row) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15) >> 2);
}

// The producer warp's part of a scan of n steps whose step k reads the row
// `first + k * step` floats on. Step k's row is read after barrier k - 1 (a
// step ahead), so stage k % D is free after barrier k and is then refilled
// with step k + D. Before barrier k the producer waits for the fill of step
// k + 1, issued D - 1 steps before: the scan threads wait on nothing but the
// barrier, which orders the copy before their reads. A step's work here is
// a few instructions, so that the producer never makes the barrier wait.
__device__ void ring_produce(const Ring& r, const float* first, long long step, int L, int n,
                             const float* end, int ns) {
  const bool lead = (threadIdx.x & 31) == 0;
  const uintptr_t last16 = reinterpret_cast<uintptr_t>(end) & ~uintptr_t(15);
  if (lead) {
    for (int s = 0; s < RING_DEPTH; ++s) w2l::mbar_init(r.full + s, 1);
    w2l::mbar_fence_init();
    for (int k = 0; k < min(RING_DEPTH, n); ++k) ring_fill(r, k, first + k * step, L, last16);
    if (n > 0) w2l::mbar_wait(r.full, 0);
  }
  scan_barrier(ns + 32);
  const float* src = first + RING_DEPTH * step;  // the row of step k + D
  for (int k = 0; k < n; ++k, src += step) {
    if (lead && k + 1 < n)
      w2l::mbar_wait(r.full + (k + 1) % RING_DEPTH, ((k + 1) / RING_DEPTH) & 1);
    scan_barrier(ns + 32);
    if (lead && k + RING_DEPTH < n) ring_fill(r, k % RING_DEPTH, src, L, last16);
  }
}

// A scan thread's lp value of step k, after the barrier that follows the
// producer's wait for it
__device__ __forceinline__ float ring_read(const Ring& r, int k, int shift, int s) {
  return r.rows[(k % RING_DEPTH) * r.row + shift + s];
}

// (b) alpha, block route: threads 0 .. ns - 1 scan, the last warp produces.
// Step k (0 .. Tf - 2) computes frame k + 1.
__global__ void __launch_bounds__(BLOCK_MAX_THREADS)
ctc_alpha_block_kernel(const float* __restrict__ lp, const int* __restrict__ targets,
                       const int* __restrict__ logit_len, const int* __restrict__ target_len,
                       int B, int T, int N, int U, float* __restrict__ alpha,
                       float* __restrict__ loss, float* __restrict__ logz) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  constexpr int D = RING_DEPTH;
  const int b = blockIdx.x, tid = threadIdx.x, L = 2 * U + 1, ns = blockDim.x - 32;
  const int Tf = max(logit_len[b], 1), tl = target_len[b], n = Tf - 1, frame = B * L;
  const float* lpb = lp + static_cast<size_t>(b) * L;
  const Ring ring = ring_at(ring_smem, L);
  if (tid >= ns) {
    ring_produce(ring, lpb + frame, frame, L, n, lp + static_cast<size_t>(T) * frame, ns);
    return;
  }
  const int* tg = targets + static_cast<size_t>(b) * U;
  // the state's constants, once: in the row, valid, the skip from s - 2
  const bool in = tid < L, valid = in && tid < 2 * tl + 1, skip = in && skip_at(tg, tid, N);
  const int s = min(tid, L - 1);  // (a thread past the row reads its last state)
  float* out = alpha + static_cast<size_t>(b) * L + tid;  // the step's alpha, a frame a step
  float a = (tid < 2 && valid) ? lpb[s] : NEG;
  if (in) *out = a;
  if (tid == 0) scan_buf[0][0] = scan_buf[0][1] = scan_buf[1][0] = scan_buf[1][1] = NEG;
  const int dshift = frame & 3;  // a frame later, a row starts this much further past 16
  int shift = ring_shift(lpb + frame);
  scan_barrier(ns + 32);  // the ring's barriers are set up
  float lnext = n > 0 ? ring_read(ring, 0, shift, s) : 0.f;
  for (int k0 = 0; k0 < n; k0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int k = k0 + d;
      if (k < n) {  // (a guard, not a break)
        const float l = lnext;
        float* w = scan_buf[d & 1] + 2;  // states -2 and -1 hold NEG
        w[tid] = a;
        scan_barrier(ns + 32);
        const float p1 = w[tid - 1], p2 = w[tid - 2];
        if (k + 1 < n) {
          shift = (shift + dshift) & 3;
          lnext = ring_read(ring, k + 1, shift, s);
        }
        a = alpha_step(a, p1, p2, l, valid, skip);
        out += frame;
        if (in) *out = a;
      }
    }
  }
  // logZ from the last frame's states 2 tl and 2 tl - 1, through the half
  // the last step did not read
  float* w = scan_buf[n & 1] + 2;
  w[tid] = a;
  asm volatile("bar.sync 2, %0;" ::"r"(ns) : "memory");
  if (tid == 0) write_logz(w[2 * tl], w[max(2 * tl - 1, 0)], tl, b, loss, logz);
}

// (c) beta, block route: threads 0 .. ns - 1 scan, warp ns / 32 produces,
// the last warp writes the token slots and leaves. Step k (0 .. Tn - 2)
// computes frame Tn - 2 - k from lp of frame Tn - 1 - k.
__global__ void __launch_bounds__(BLOCK_MAX_THREADS)
ctc_beta_block_kernel(const float* __restrict__ lp, const int* __restrict__ targets,
                      const int* __restrict__ logit_len, const int* __restrict__ target_len,
                      int B, int T, int N, int U, int* __restrict__ slots,
                      float* __restrict__ beta) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  constexpr int D = RING_DEPTH;
  const int b = blockIdx.x, tid = threadIdx.x, L = 2 * U + 1, ns = blockDim.x - 64;
  const int* tg = targets + static_cast<size_t>(b) * U;
  if (tid >= ns + 32) {
    token_slots(tg, U, N, tid - ns - 32, 32, slots + static_cast<size_t>(b) * (2 * U + 1));
    return;
  }
  const int Tn = logit_len[b];
  if (Tn <= 0) return;  // no frame: dx is zero and (d) reads no beta
  const int tl = target_len[b], n = Tn - 1, frame = B * L;
  const float* lpb = lp + static_cast<size_t>(b) * L;
  const float* top = lpb + static_cast<size_t>(Tn - 1) * frame;  // lp of step 0
  const Ring ring = ring_at(ring_smem, L);
  if (tid >= ns) {
    ring_produce(ring, top, -static_cast<long long>(frame), L, n,
                 lp + static_cast<size_t>(T) * frame, ns);
    return;
  }
  // the state's constants, once: in the row, valid, the skip to s + 2, the reset
  const bool in = tid < L, valid = in && tid < 2 * tl + 1;
  const bool from = tid + 2 < L && skip_at(tg, tid + 2, N);
  const bool fin = tid == 2 * tl || tid == max(2 * tl - 1, 0);
  const int s = min(tid, L - 1);
  float* out = beta + (static_cast<size_t>(Tn - 1) * B + b) * L + tid;  // a frame back a step
  float be = (fin && valid) ? 0.f : NEG;
  if (in) *out = be;
  if (tid == 0) {  // the states past the last thread's hold NEG
    scan_buf[0][ns] = scan_buf[0][ns + 1] = NEG;
    scan_buf[1][ns] = scan_buf[1][ns + 1] = NEG;
  }
  const int dshift = frame & 3;
  int shift = ring_shift(top);
  scan_barrier(ns + 32);
  float lnext = n > 0 ? ring_read(ring, 0, shift, s) : 0.f;
  for (int k0 = 0; k0 < n; k0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int k = k0 + d;
      if (k < n) {
        const float bb = in ? be + lnext : NEG;
        float* w = scan_buf[d & 1];
        w[tid] = bb;
        scan_barrier(ns + 32);
        const float q1 = w[tid + 1], q2 = w[tid + 2];
        if (k + 1 < n) {
          shift = (shift - dshift) & 3;
          lnext = ring_read(ring, k + 1, shift, s);
        }
        be = beta_step(bb, q1, q2, valid, from);
        out -= frame;
        if (in) *out = be;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the wide route's per-utterance double buffer: shared memory where it fits
__device__ __forceinline__ float* work_area(float* smem, float* gwork, int L) {
  return gwork == nullptr ? smem
                          : gwork + static_cast<size_t>(blockIdx.x) * WIDE_WORDS_PER_STATE * L;
}

// (b) alpha, wide route: states strided over the threads, one barrier a step
__global__ void __launch_bounds__(BLOCK_MAX_THREADS)
ctc_alpha_wide_kernel(const float* __restrict__ lp, const int* __restrict__ targets,
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
  if (tid == 0) write_logz(prev[2 * tl], prev[max(2 * tl - 1, 0)], tl, b, loss, logz);
}

// (c) beta, wide route: the buffer holds beta + lp of the frame after the
// step's, for every state; the token slots first, by every thread
__global__ void __launch_bounds__(BLOCK_MAX_THREADS)
ctc_beta_wide_kernel(const float* __restrict__ lp, const int* __restrict__ targets,
                     const int* __restrict__ logit_len, const int* __restrict__ target_len,
                     int B, int N, int U, int* __restrict__ slots, float* __restrict__ beta,
                     float* gwork) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, L = 2 * U + 1;
  const int* tg = targets + static_cast<size_t>(b) * U;
  token_slots(tg, U, N, tid, nt, slots + static_cast<size_t>(b) * (2 * U + 1));
  const int Tn = logit_len[b];
  if (Tn <= 0) return;
  const int tl = target_len[b], vlim = 2 * tl + 1;
  const size_t frame = static_cast<size_t>(B) * L;
  const float* lpb = lp + static_cast<size_t>(b) * L;
  float* beb = beta + static_cast<size_t>(b) * L;
  float* work = work_area(smem, gwork, L);
  float* bb[2] = {work, work + L};
  for (int s = tid; s < L; s += nt) {
    const float v = ((s == 2 * tl || s == max(2 * tl - 1, 0)) && s < vlim) ? 0.f : NEG;
    beb[(Tn - 1) * frame + s] = v;
    if (Tn > 1) bb[0][s] = v + lpb[(Tn - 1) * frame + s];
  }
  int par = 0;
  for (int t = Tn - 2; t >= 0; --t, par ^= 1) {
    __syncthreads();
    const float* nx = bb[par];
    float* cu = bb[par ^ 1];
    for (int s = tid; s < L; s += nt) {
      const float b1 = s + 1 < L ? nx[s + 1] : NEG;
      const float b2 = (s + 2 < L && skip_at(tg, s + 2, N)) ? nx[s + 2] : NEG;
      const float v = s < vlim ? lse3(nx[s], b1, b2) : NEG;
      beb[t * frame + s] = v;
      if (t > 0) cu[s] = v + lpb[t * frame + s];
    }
  }
}

// ---------------------------------------------------------------------------
// (d) dx of one frame row, with the row's posterior formed here: every class
// is written first as if its posterior were 0; after one barrier the row's
// tokens (distinct: no two writes meet) are written again with theirs
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
ctc_grad_kernel(const T* __restrict__ x, const float* __restrict__ lse,
                const float* __restrict__ g, const float* __restrict__ alpha,
                const float* __restrict__ beta, const float* __restrict__ logz,
                const int* __restrict__ targets, const int* __restrict__ logit_len,
                const int* __restrict__ target_len, const int* __restrict__ slots, int B, int T_,
                int N, int U, T* __restrict__ dx) {
  __shared__ float red[ROW_THREADS / 32];
  const int row = blockIdx.x;
  const int b = row / T_, t = row % T_, tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const T* xr = x + static_cast<size_t>(row) * N;
  T* dr = dx + static_cast<size_t>(row) * N;
  constexpr int VN = Vec<T>::n;
  const bool vec = (reinterpret_cast<uintptr_t>(xr) & 15) == (reinterpret_cast<uintptr_t>(dr) & 15);
  const int head = vec ? head_elems(dr, N) : N;
  const int nvec = (N - head) / VN;
  const int tail0 = head + nvec * VN;
  if (t >= logit_len[b]) {
    const float z[VN] = {};
    for (int i = tid; i < head; i += ROW_THREADS) dr[i] = w2l::from_f<T>(0.f);
    for (int k = tid; k < nvec; k += ROW_THREADS) store_vec(dr + head + k * VN, z);
    for (int i = tail0 + tid; i < N; i += ROW_THREADS) dr[i] = w2l::from_f<T>(0.f);
    return;
  }
  const float gb = g[b];
  const float ls = lse[static_cast<size_t>(b) * T_ + t];
  const float lz = logz[b];
  const int L = 2 * U + 1, vlim = 2 * target_len[b] + 1, blank = N - 1;
  const int* tg = targets + static_cast<size_t>(b) * U;
  const int* tok = slots + static_cast<size_t>(b) * (2 * U + 1);
  const int* chain = tok + U + 1;
  const size_t off = (static_cast<size_t>(t) * B + b) * L;
  const float* al = alpha + off;
  const float* be = beta + off;
  // gamma of a valid state s (< vlim); an invalid state's is 0
  auto gamma = [&](int s) { return s < vlim ? gamma_of(al[s], be[s], lz) : 0.f; };
  // The posterior's first inputs, loaded before the pass over x so that they
  // arrive during it: state tid (for the blank) and label tid (its slot, the
  // next position with its token, and its state 2 tid + 1)
  const bool s_in = tid < vlim, u_in = tid < U;
  const float as = s_in ? al[tid] : 0.f, bs = s_in ? be[tid] : 0.f;
  const bool s_blank = s_in && ext_at(tg, tid, N) == blank;
  const int tk = u_in ? tok[1 + tid] : -1, nx = u_in ? chain[tid] : -1;
  const bool l_in = u_in && 2 * tid + 1 < vlim;
  const float au = l_in ? al[2 * tid + 1] : 0.f, bu = l_in ? be[2 * tid + 1] : 0.f;
  // dx of a class whose logit is v and posterior p
  auto grad = [&](float v, float p) { return (expf(v - ls) - p) * gb; };
  for (int i = tid; i < head; i += ROW_THREADS)
    dr[i] = w2l::from_f<T>(grad(w2l::to_f(xr[i]), 0.f));
  for (int k = tid; k < nvec; k += ROW_THREADS) {
    const int i0 = head + k * VN;
    float v[VN];
    load_vec(xr + i0, v);
#pragma unroll
    for (int e = 0; e < VN; ++e) v[e] = grad(v[e], 0.f);
    store_vec(dr + i0, v);
  }
  for (int i = tail0 + tid; i < N; i += ROW_THREADS)
    dr[i] = w2l::from_f<T>(grad(w2l::to_f(xr[i]), 0.f));
  float part = s_blank ? gamma_of(as, bs, lz) : 0.f;  // the blank's gammas, in increasing s
  for (int s = tid + ROW_THREADS; s < vlim; s += ROW_THREADS)
    if (ext_at(tg, s, N) == blank) part += gamma(s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
  if (lane == 0) red[wid] = part;
  __syncthreads();  // every class of the row written, and red full
  if (tid == 0) {
    float sum = red[0];
    for (int w = 1; w < ROW_THREADS / 32; ++w) sum += red[w];
    dr[blank] = w2l::from_f<T>(grad(w2l::to_f(xr[blank]), sum));
  }
  // each label from its token's first position, its gammas along its chain
  if (tk >= 0) {
    float v = l_in ? gamma_of(au, bu, lz) : 0.f;
    for (int w = nx; w >= 0; w = chain[w]) v += gamma(2 * w + 1);
    dr[tk] = w2l::from_f<T>(grad(w2l::to_f(xr[tk]), v));
  }
  for (int u = tid + ROW_THREADS; u < U; u += ROW_THREADS) {
    const int k = tok[1 + u];
    if (k < 0) continue;
    float v = gamma(2 * u + 1);
    for (int w = chain[u]; w >= 0; w = chain[w]) v += gamma(2 * w + 1);
    dr[k] = w2l::from_f<T>(grad(w2l::to_f(xr[k]), v));
  }
}

// ---------------------------------------------------------------------------
// plans, with their Python twins in kernels/ctc.py
// the block route's scan threads (the kernels add their producer and token
// warps), 0 past it
int block_scan_threads(int L) {
  const int t = (L + 31) / 32 * 32;
  return t <= BLOCK_SCAN_MAX ? t : 0;
}

// the block route's dynamic shared memory: the ring
size_t ring_bytes(int L) {
  return RING_HEAD + static_cast<size_t>(RING_DEPTH) * ring_row(L) * sizeof(float);
}

enum Route { kBlock = 0, kWide = 1 };

int route(int L) { return block_scan_threads(L) ? kBlock : kWide; }

// threads of a scan's chain: the block route's, or the wide route's
int scan_threads(int L) { return route(L) == kBlock ? block_scan_threads(L) : BLOCK_MAX_THREADS; }

size_t work_bytes(int L) {
  return static_cast<size_t>(WIDE_WORDS_PER_STATE) * L * sizeof(float);
}

// whether the wide route's work goes to shared memory (else the wrapper
// gives a global scratch)
bool work_in_smem(int L, int max_smem) { return work_bytes(L) <= static_cast<size_t>(max_smem); }

template <typename T>
int launch_rows(const void* x, const int* tg, const int* ll, int B, int T_, int N, int U,
                float* lse, float* lp, cudaStream_t st) {
  ctc_rows_kernel<T><<<B * T_, ROW_THREADS, 0, st>>>(static_cast<const T*>(x), tg, ll, B, T_, N,
                                                     U, lse, lp);
  return static_cast<int>(cudaGetLastError());
}

int launch_betas(const float* lp, const int* tg, const int* ll, const int* tl, int B, int T,
                 int N, int U, int* slots, float* beta, float* gwork, int max_smem,
                 cudaStream_t st) {
  const int L = 2 * U + 1;
  switch (route(L)) {
    case kBlock: {
      const size_t smem = ring_bytes(L);
      w2l::allow_smem(ctc_beta_block_kernel, smem);
      ctc_beta_block_kernel<<<B, block_scan_threads(L) + 64, smem, st>>>(lp, tg, ll, tl, B, T, N,
                                                                        U, slots, beta);
      return static_cast<int>(cudaGetLastError());
    }
    default: {
      const bool in_smem = gwork == nullptr;
      if (in_smem && !work_in_smem(L, max_smem)) return static_cast<int>(cudaErrorInvalidValue);
      const size_t smem = in_smem ? work_bytes(L) : 0;
      w2l::allow_smem(ctc_beta_wide_kernel, smem);
      ctc_beta_wide_kernel<<<B, BLOCK_MAX_THREADS, smem, st>>>(lp, tg, ll, tl, B, N, U, slots,
                                                               beta, gwork);
      return static_cast<int>(cudaGetLastError());
    }
  }
}

template <typename T>
int launch_grad(const void* x, const float* lse, const float* g, const float* alpha,
                const float* beta, const float* logz, const int* tg, const int* ll,
                const int* tl, const int* slots, int B, int T_, int N, int U, void* dx,
                cudaStream_t st) {
  ctc_grad_kernel<T><<<B * T_, ROW_THREADS, 0, st>>>(static_cast<const T*>(x), lse, g, alpha,
                                                      beta, logz, tg, ll, tl, slots, B, T_, N, U,
                                                      static_cast<T*>(dx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the scans' route for L = 2U + 1 states: 0 block, 1 wide
int w2l_ctc_route(int L) { return route(L); }

// threads of a scan's chain (the block route's beta kernel adds a warp)
int w2l_ctc_block_threads(int L) { return scan_threads(L); }

// the frames of lp a scan brings ahead of its chain
int w2l_ctc_ring_depth() { return RING_DEPTH; }

// bytes of the wide route's work area an utterance
int w2l_ctc_work_bytes(int L) { return static_cast<int>(work_bytes(L)); }

// 1 where the wide route's work goes to shared memory of max_smem bytes
int w2l_ctc_work_in_smem(int L, int max_smem) { return work_in_smem(L, max_smem) ? 1 : 0; }

// K5: (a) lse (B, T) and lp (T, B, L), then (b) alpha (T, B, L), loss and
// logZ (B,). gwork: the wide route's work in global memory (B * work bytes),
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
  switch (route(L)) {
    case kBlock: {
      const size_t smem = ring_bytes(L);
      w2l::allow_smem(ctc_alpha_block_kernel, smem);
      ctc_alpha_block_kernel<<<B, block_scan_threads(L) + 32, smem, st>>>(lpf, tg, ll, tl, B, T,
                                                                          N, U, al, lo, lz);
      return static_cast<int>(cudaGetLastError());
    }
    default: {
      const bool in_smem = gwork == nullptr;
      if (in_smem && !work_in_smem(L, max_smem)) return static_cast<int>(cudaErrorInvalidValue);
      const size_t smem = in_smem ? work_bytes(L) : 0;
      w2l::allow_smem(ctc_alpha_wide_kernel, smem);
      ctc_alpha_wide_kernel<<<B, BLOCK_MAX_THREADS, smem, st>>>(lpf, tg, ll, tl, B, N, U, al, lo,
                                                                lz, static_cast<float*>(gwork));
      return static_cast<int>(cudaGetLastError());
    }
  }
}

// K5b's first launch alone, (c): the token slots (B, 2U + 1) and beta
// (T, B, L) on frames below logit_len; gwork as in w2l_ctc_fwd.
int w2l_ctc_betas(const void* lp, const void* targets, const void* logit_len,
                  const void* target_len, void* slots, void* beta, void* gwork, int B, int T,
                  int N, int U, int max_smem, void* stream) {
  return launch_betas(static_cast<const float*>(lp), static_cast<const int*>(targets),
                      static_cast<const int*>(logit_len), static_cast<const int*>(target_len), B,
                      T, N, U, static_cast<int*>(slots), static_cast<float*>(beta),
                      static_cast<float*>(gwork), max_smem, static_cast<cudaStream_t>(stream));
}

// K5b: (c) the token slots and beta, then (d) dx (B, T, N) in x's dtype for
// the loss gradient g (B,).
int w2l_ctc_bwd(const void* x, const void* lse, const void* lp, const void* alpha,
                const void* logz, const void* g, const void* targets, const void* logit_len,
                const void* target_len, void* slots, void* beta, void* gwork, void* dx,
                int dtype, int B, int T, int N, int U, int max_smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(targets);
  const int* ll = static_cast<const int*>(logit_len);
  const int* tl = static_cast<const int*>(target_len);
  int* sl = static_cast<int*>(slots);
  float* be = static_cast<float*>(beta);
  const int rc = launch_betas(static_cast<const float*>(lp), tg, ll, tl, B, T, N, U, sl, be,
                              static_cast<float*>(gwork), max_smem, st);
  if (rc != 0) return rc;
  const float* lsef = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(g);
  const float* al = static_cast<const float*>(alpha);
  const float* lz = static_cast<const float*>(logz);
  return dtype == w2l::kBFloat16
             ? launch_grad<__nv_bfloat16>(x, lsef, gf, al, be, lz, tg, ll, tl, sl, B, T, N, U, dx,
                                          st)
             : launch_grad<float>(x, lsef, gf, al, be, lz, tg, ll, tl, sl, B, T, N, U, dx, st);
}

}  // extern "C"
