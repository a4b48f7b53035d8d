// K4: fused multi-head self-attention with the Transformer-XL relative-
// position bias, forward. K4b: its full-recompute backward.
//
// Replace the TPU kernels wav2letter_tpu/ops/pallas/attention.py::fused_mhsa
// (_mhsa_fwd, _fwd_kernel) and ::_mhsa_bwd (_bwd_kernel). Per (batch, head),
// with q already scaled by 1/sqrt(Dh) and heads the column blocks of the
// (B, T, H*Dh) activations:
//   scores[i, j] = q_i . k_j + q_i . Pwin[j - i + T - 1] + mask[b, j]   (fp32)
//   p = softmax_j(scores);  pd = keep ? p / (1 - rate) : 0   (counter hash)
//   out_i = sum_j pd[i, j] v_j
// and backward, for the output gradient g:
//   dv_j = sum_i pd[i, j] g_i;   dpd = g . v^T;   dp = keep ? dpd / (1 - rate) : 0
//   ds = p * (dp - sum_j dp * p)
//   dq_i = sum_j ds[i, j] (k_j + Pwin[j - i + T - 1]);   dk_j = sum_i ds[i, j] q_i
//   dPwin[r] = sum over (b, h) and over j - i + T - 1 = r of ds[i, j] q_i
//
// Bound on the H100: the function does 0.75 T multiply-adds-times-two per
// byte of q, k, v and out in bf16 (6 B H T^2 Dh operations over 8 B T H Dh
// bytes), against the card's ~295 per byte: bytes bind it at the transformer
// recipe's T = 192 (144 per byte), operations from T ~ 400 on and at any T in
// fp32 (67 TFLOP/s outside the tensor cores).
//
// Design. The TPU kernel keeps a whole (batch, head) in fast memory; the
// q, k, v of one head and its T x T scores do not fit a block's 227 KB here.
// So the grid tiles the queries: one block per (tile of R = 16 query rows,
// head, batch) holds that tile's q rows and its R x T score rows in shared
// memory in fp32. A whole score row is present, so the softmax is the plain
// two-pass one, with no online rescaling. Heads are read and written in place
// with row stride H*Dh; nothing is split, merged or padded. The relative
// shift is an index: a tile of R rows needs the T + R - 1 rows of Pwin from
// T - i0 - R on; each thread takes one such row r, forms its product with
// all R query rows, and adds product il to scores[il, r - (T - 1) + i0 + il].
// The products run on the fp32 pipes with fp32 sums (inputs of either type
// are converted exactly); p is rounded to v's type before p . v and ds to
// q's type before its products, as the TPU kernel casts them. Tensor cores
// (wgmma) and TMA are left for later.
//
// The backward runs four launches. (1) per query tile: scores, p, dpd, ds as
// above and dq, which needs only that tile's rows; pd and ds, rounded to the
// working type, go to scratch (B, H, T, T). (2) per tile of R keys: dv and dk
// as sums over all query rows of that scratch, one owner per output. (3) per
// tile of R rows of Pwin and (b, h): that head's share of dPwin, reading ds
// along the diagonals j - i = r - (T - 1). (4) dPwin = the shares summed in
// (b, h) order. No atomics anywhere: equal inputs give equal bits.
#include "common.cuh"

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int R = 16;    // query rows (or keys, or Pwin rows) per block
constexpr int RG = 8;    // rows per thread in the accumulating products
constexpr int IC = 64;   // rows of scratch staged per step in launches 2 and 3

// 8 consecutive elements as floats; p is 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 2 consecutive elements as floats; p is aligned to 2 elements.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// v rounded to the storage type T, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return w2l::to_f(w2l::from_f<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The dropout keep mask: a murmur3-style finalizer over the element's counter
// row * Tp + col mixed with the seed and the (batch, head) index, in uint32
// arithmetic that wraps; keep where the hash is below thresh.
struct Dropout {
  uint32_t mix;
  uint32_t tp;
  uint32_t thresh;
  float scale;
  bool on;
  __device__ __forceinline__ bool keep(int row, int col) const {
    uint32_t x = static_cast<uint32_t>(row) * tp + static_cast<uint32_t>(col) + mix;
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    return x < thresh;
  }
};

__device__ __forceinline__ Dropout make_dropout(int seed, int prog, int tp, unsigned thresh,
                                                float scale, float rate) {
  Dropout d;
  d.mix = static_cast<uint32_t>(seed) * 0x9E3779B9u + static_cast<uint32_t>(prog) * 0x85EBCA6Bu;
  d.tp = static_cast<uint32_t>(tp);
  d.thresh = thresh;
  d.scale = scale;
  d.on = rate > 0.f;
  return d;
}

// For each of n rows (row r at rows + r * stride, Dh elements), one thread
// forms the products with the R rows of xs (shared memory, R x Dh fp32) and
// hands them to emit(r, acc).
template <typename T, typename Emit>
__device__ __forceinline__ void row_dots(const float* xs, int Dh, const T* rows, size_t stride,
                                         int n, Emit emit) {
  for (int r = threadIdx.x; r < n; r += THREADS) {
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    const T* row = rows + static_cast<size_t>(r) * stride;
    for (int d = 0; d < Dh; d += 8) {
      float x[8];
      load8(row + d, x);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(xs + i * Dh + d);
        const float4 b = *reinterpret_cast<const float4*>(xs + i * Dh + d + 4);
        float s = acc[i];
        s = fmaf(a.x, x[0], s); s = fmaf(a.y, x[1], s);
        s = fmaf(a.z, x[2], s); s = fmaf(a.w, x[3], s);
        s = fmaf(b.x, x[4], s); s = fmaf(b.y, x[5], s);
        s = fmaf(b.z, x[6], s); s = fmaf(b.w, x[7], s);
        acc[i] = s;
      }
    }
    emit(r, acc);
  }
}

// a0[ii], a1[ii] += sum over n < N of w(ii, n) * x[n, 2*dp + {0, 1}], for the
// RG rows ii of one thread's group; row n of x is at x + n * stride.
template <typename T, typename W>
__device__ __forceinline__ void accum_rows(const T* x, size_t stride, int N, int dp, W w,
                                           float* a0, float* a1) {
  for (int n = 0; n < N; ++n) {
    const float2 xv = load2(x + static_cast<size_t>(n) * stride + 2 * dp);
#pragma unroll
    for (int ii = 0; ii < RG; ++ii) {
      const float wv = w(ii, n);
      a0[ii] = fmaf(wv, xv.x, a0[ii]);
      a1[ii] = fmaf(wv, xv.y, a1[ii]);
    }
  }
}

// Rows i0 .. i0+R-1 of one head of x (B, T, H*Dh) into shared memory as fp32;
// rows beyond T are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* xs, const T* x, int b, int h, int i0, int Tn,
                                          int H, int Dh) {
  const size_t HD = static_cast<size_t>(H) * Dh;
  for (int idx = threadIdx.x; idx < R * Dh; idx += THREADS) {
    const int il = idx / Dh, d = idx - il * Dh;
    const int i = i0 + il;
    xs[idx] = i < Tn ? w2l::to_f(x[(static_cast<size_t>(b) * Tn + i) * HD + h * Dh + d]) : 0.f;
  }
}

// S[il, j] = q_il . k_j + q_il . Pwin[j - (i0 + il) + T - 1] + mask[b, j] for
// the tile's R rows and all T keys, then p = softmax over j, left in S in
// fp32. Ends synchronized.
template <typename T>
__device__ __forceinline__ void tile_probs(float* S, const float* qs, const T* k, const T* pos,
                                           const float* mask, int b, int h, int i0, int Tn,
                                           int H, int Dh) {
  const size_t HD = static_cast<size_t>(H) * Dh;
  const float* mrow = mask + static_cast<size_t>(b) * Tn;
  row_dots(qs, Dh, k + static_cast<size_t>(b) * Tn * HD + h * Dh, HD, Tn,
           [&](int j, const float* acc) {
             const float m = mrow[j];
#pragma unroll
             for (int il = 0; il < R; ++il) S[il * Tn + j] = acc[il] + m;
           });
  __syncthreads();
  // the rows of Pwin this tile can reach: r = j - i + T - 1 over its i, all j
  const int r0 = Tn - i0 - R;
  const int rlo = r0 > 0 ? r0 : 0;
  const int nr = r0 + Tn + R - 1 - rlo;
  row_dots(qs, Dh, pos + static_cast<size_t>(rlo) * Dh, static_cast<size_t>(Dh), nr,
           [&](int rr, const float* acc) {
             const int jbase = rlo + rr - (Tn - 1) + i0;
#pragma unroll
             for (int il = 0; il < R; ++il) {
               const int j = jbase + il;
               if (j >= 0 && j < Tn) S[il * Tn + j] += acc[il];
             }
           });
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int il = warp; il < R; il += THREADS / 32) {
    float* row = S + il * Tn;
    float m = -INFINITY;
    for (int j = lane; j < Tn; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < Tn; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < Tn; j += 32) row[j] = row[j] / s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
mhsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ pos, const float* __restrict__ mask,
                T* __restrict__ out, int Tn, int H, int Dh, int Tp, int seed, float rate,
                unsigned thresh, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;          // [R, Dh]
  float* S = smem + R * Dh;  // [R, T]
  const int i0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const size_t HD = static_cast<size_t>(H) * Dh;
  load_tile(qs, q, b, h, i0, Tn, H, Dh);
  __syncthreads();
  tile_probs(S, qs, k, pos, mask, b, h, i0, Tn, H, Dh);
  const Dropout drop = make_dropout(seed, b * H + h, Tp, thresh, scale, rate);
  for (int idx = threadIdx.x; idx < R * Tn; idx += THREADS) {
    const int il = idx / Tn, j = idx - il * Tn;
    float p = S[idx];
    if (drop.on) p = drop.keep(i0 + il, j) ? p * drop.scale : 0.f;
    S[idx] = round_to<T>(p);
  }
  __syncthreads();
  const int half = Dh / 2;
  const T* vb = v + static_cast<size_t>(b) * Tn * HD + h * Dh;
  for (int item = threadIdx.x; item < (R / RG) * half; item += THREADS) {
    const int g = item / half, dp = item - g * half;
    float a0[RG], a1[RG];
#pragma unroll
    for (int ii = 0; ii < RG; ++ii) a0[ii] = a1[ii] = 0.f;
    const float* Sg = S + g * RG * Tn;
    accum_rows(vb, HD, Tn, dp, [&](int ii, int n) { return Sg[ii * Tn + n]; }, a0, a1);
#pragma unroll
    for (int ii = 0; ii < RG; ++ii) {
      const int i = i0 + g * RG + ii;
      if (i < Tn)
        store2(out + (static_cast<size_t>(b) * Tn + i) * HD + h * Dh + 2 * dp, a0[ii], a1[ii]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4b, launch 1: per query tile, pd and ds to scratch, and dq
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ pos, const float* __restrict__ mask,
                     const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ pd_out,
                     T* __restrict__ ds_out, int Tn, int H, int Dh, int Tp, int seed,
                     float rate, unsigned thresh, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [R, Dh]
  float* gs = qs + R * Dh;     // [R, Dh]
  float* S = gs + R * Dh;      // [R, T]: p, then ds
  float* DP = S + R * Tn;      // [R, T]: dpd, then dp
  const int i0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const size_t HD = static_cast<size_t>(H) * Dh;
  load_tile(qs, q, b, h, i0, Tn, H, Dh);
  load_tile(gs, g, b, h, i0, Tn, H, Dh);
  __syncthreads();
  tile_probs(S, qs, k, pos, mask, b, h, i0, Tn, H, Dh);
  const T* kb = k + static_cast<size_t>(b) * Tn * HD + h * Dh;
  row_dots(gs, Dh, v + static_cast<size_t>(b) * Tn * HD + h * Dh, HD, Tn,
           [&](int j, const float* acc) {
#pragma unroll
             for (int il = 0; il < R; ++il) DP[il * Tn + j] = acc[il];
           });
  __syncthreads();
  const Dropout drop = make_dropout(seed, b * H + h, Tp, thresh, scale, rate);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int il = warp; il < R; il += THREADS / 32) {
    const int i = i0 + il;
    float* prow = S + il * Tn;
    float* drow = DP + il * Tn;
    const size_t srow = ((static_cast<size_t>(b) * H + h) * Tn + i) * Tn;
    float dot = 0.f;
    for (int j = lane; j < Tn; j += 32) {
      const float p = prow[j];
      float dp = drow[j], pd = p;
      if (drop.on) {
        const bool kp = drop.keep(i, j);
        dp = kp ? dp * drop.scale : 0.f;
        pd = kp ? p * drop.scale : 0.f;
      }
      drow[j] = dp;
      dot = fmaf(dp, p, dot);
      if (i < Tn) pd_out[srow + j] = w2l::from_f<T>(pd);
    }
    dot = warp_sum(dot);
    for (int j = lane; j < Tn; j += 32) {
      const T ds = w2l::from_f<T>(prow[j] * (drow[j] - dot));
      prow[j] = w2l::to_f(ds);
      if (i < Tn) ds_out[srow + j] = ds;
    }
  }
  __syncthreads();
  // dq_i = sum_j ds[i, j] k_j + sum_r ds[i, r - (T-1) + i] Pwin[r], one sum
  const int half = Dh / 2;
  const int r0 = Tn - i0 - R;
  const int rlo = r0 > 0 ? r0 : 0;
  const int nr = r0 + Tn + R - 1 - rlo;
  for (int item = threadIdx.x; item < (R / RG) * half; item += THREADS) {
    const int gq = item / half, dp = item - gq * half;
    float a0[RG], a1[RG];
#pragma unroll
    for (int ii = 0; ii < RG; ++ii) a0[ii] = a1[ii] = 0.f;
    const float* Sg = S + gq * RG * Tn;
    accum_rows(kb, HD, Tn, dp, [&](int ii, int n) { return Sg[ii * Tn + n]; }, a0, a1);
    const int jbase = rlo - (Tn - 1) + i0 + gq * RG;
    accum_rows(pos + static_cast<size_t>(rlo) * Dh, static_cast<size_t>(Dh), nr, dp,
               [&](int ii, int n) {
                 const int j = jbase + n + ii;
                 return (j >= 0 && j < Tn) ? Sg[ii * Tn + j] : 0.f;
               },
               a0, a1);
#pragma unroll
    for (int ii = 0; ii < RG; ++ii) {
      const int i = i0 + gq * RG + ii;
      if (i < Tn)
        store2(dq + (static_cast<size_t>(b) * Tn + i) * HD + h * Dh + 2 * dp, a0[ii], a1[ii]);
    }
  }
}

// out[c0 + cl, :] = sum over rows i < T of w[i, col(i, cl)] * x[b, i, head h],
// for the R outputs cl of this block; w is one (T, T) slice of scratch and
// col(i, cl) the column of it that output cl reads in row i (negative or >= T:
// nothing). Steps of IC rows of w are staged in shared memory.
template <typename T, typename Col>
__device__ __forceinline__ void column_sums(const T* w, const T* xb, size_t HD, int Tn, int Dh,
                                            float* stage, Col col, float* a0, float* a1,
                                            int g, int dp, bool active) {
  for (int ic0 = 0; ic0 < Tn; ic0 += IC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < IC * R; idx += THREADS) {
      const int ii = idx / R, cl = idx - ii * R;
      const int i = ic0 + ii;
      const int j = col(i, cl);
      stage[idx] = (i < Tn && j >= 0 && j < Tn)
                       ? w2l::to_f(w[static_cast<size_t>(i) * Tn + j]) : 0.f;
    }
    __syncthreads();
    if (active) {
      const int n = Tn - ic0 < IC ? Tn - ic0 : IC;
      const float* sg = stage + g * RG;
      accum_rows(xb + static_cast<size_t>(ic0) * HD, HD, n, dp,
                 [&](int ii, int nn) { return sg[nn * R + ii]; }, a0, a1);
    }
  }
}

// ---------------------------------------------------------------------------
// K4b, launch 2: per tile of R keys, dv = pd^T g and dk = ds^T q
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ g,
                     const T* __restrict__ pd, const T* __restrict__ ds,
                     T* __restrict__ dk, T* __restrict__ dv, int Tn, int H, int Dh) {
  __shared__ float stage[IC * R];
  const int j0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const size_t HD = static_cast<size_t>(H) * Dh;
  const size_t slice = (static_cast<size_t>(b) * H + h) * Tn * Tn;
  const int half = Dh / 2;
  const bool active = threadIdx.x < (R / RG) * half;
  const int gk = threadIdx.x / half, dp = threadIdx.x - gk * half;
  const size_t head = static_cast<size_t>(b) * Tn * HD + h * Dh;
  auto col = [&](int, int cl) { return j0 + cl; };
  for (int which = 0; which < 2; ++which) {
    float a0[RG], a1[RG];
#pragma unroll
    for (int ii = 0; ii < RG; ++ii) a0[ii] = a1[ii] = 0.f;
    column_sums((which == 0 ? pd : ds) + slice, (which == 0 ? g : q) + head, HD, Tn, Dh,
                stage, col, a0, a1, gk, dp, active);
    if (active) {
      T* dst = which == 0 ? dv : dk;
#pragma unroll
      for (int ii = 0; ii < RG; ++ii) {
        const int j = j0 + gk * RG + ii;
        if (j < Tn) store2(dst + head + static_cast<size_t>(j) * HD + 2 * dp, a0[ii], a1[ii]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4b, launch 3: per tile of R rows of Pwin, this (b, h)'s share of dPwin
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_pos_kernel(const T* __restrict__ q, const T* __restrict__ ds,
                    float* __restrict__ part, int Tn, int H, int Dh) {
  __shared__ float stage[IC * R];
  const int r0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const size_t HD = static_cast<size_t>(H) * Dh;
  const int W = 2 * Tn - 1;
  const size_t slice = (static_cast<size_t>(b) * H + h) * Tn * Tn;
  const int half = Dh / 2;
  const bool active = threadIdx.x < (R / RG) * half;
  const int gr = threadIdx.x / half, dp = threadIdx.x - gr * half;
  float a0[RG], a1[RG];
#pragma unroll
  for (int ii = 0; ii < RG; ++ii) a0[ii] = a1[ii] = 0.f;
  // row r of Pwin met ds[i, j] where j - i + T - 1 = r
  auto col = [&](int i, int cl) { return r0 + cl < W ? r0 + cl + i - (Tn - 1) : -1; };
  column_sums(ds + slice, q + static_cast<size_t>(b) * Tn * HD + h * Dh, HD, Tn, Dh, stage,
              col, a0, a1, gr, dp, active);
  if (active) {
    float* dst = part + (static_cast<size_t>(b) * H + h) * W * Dh;
#pragma unroll
    for (int ii = 0; ii < RG; ++ii) {
      const int r = r0 + gr * RG + ii;
      if (r < W) store2(dst + static_cast<size_t>(r) * Dh + 2 * dp, a0[ii], a1[ii]);
    }
  }
}

// K4b, launch 4: dPwin = the (b, h) shares summed in order.
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_pos_sum_kernel(const float* __restrict__ part, float* __restrict__ dpos, int n,
                        int BH) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int p = 0; p < BH; ++p) s += part[static_cast<size_t>(p) * n + idx];
  dpos[idx] = s;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* pos, const void* mask,
               void* out, int B, int Tn, int H, int Dh, int Tp, int seed, float rate,
               unsigned thresh, float scale, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(R) * Dh + static_cast<size_t>(R) * Tn) * sizeof(float);
  w2l::allow_smem(mhsa_fwd_kernel<T>, smem);
  const dim3 grid((Tn + R - 1) / R, H, B);
  mhsa_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(pos), static_cast<const float*>(mask), static_cast<T*>(out), Tn, H,
      Dh, Tp, seed, rate, thresh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* pos, const void* mask,
               const void* g, void* dq, void* dk, void* dv, void* dpos, void* pd, void* ds,
               void* part, int B, int Tn, int H, int Dh, int Tp, int seed, float rate,
               unsigned thresh, float scale, cudaStream_t stream) {
  const size_t smem =
      2 * (static_cast<size_t>(R) * Dh + static_cast<size_t>(R) * Tn) * sizeof(float);
  w2l::allow_smem(mhsa_bwd_rows_kernel<T>, smem);
  const dim3 grid((Tn + R - 1) / R, H, B);
  mhsa_bwd_rows_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(pos), static_cast<const float*>(mask), static_cast<const T*>(g),
      static_cast<T*>(dq), static_cast<T*>(pd), static_cast<T*>(ds), Tn, H, Dh, Tp, seed, rate,
      thresh, scale);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  mhsa_bwd_keys_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(g), static_cast<const T*>(pd),
      static_cast<const T*>(ds), static_cast<T*>(dk), static_cast<T*>(dv), Tn, H, Dh);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int W = 2 * Tn - 1;
  const dim3 pgrid((W + R - 1) / R, H, B);
  mhsa_bwd_pos_kernel<T><<<pgrid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ds), static_cast<float*>(part), Tn, H, Dh);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int n = W * Dh;
  mhsa_bwd_pos_sum_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dpos), n, B * H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest head width the backward's one-item-per-thread launches take.
extern "C" int w2l_mhsa_max_head_dim() { return 2 * THREADS / (R / RG); }

// Dynamic shared memory of the forward and of the backward's first launch.
extern "C" int w2l_mhsa_smem_bytes(int Tn, int Dh, int backward) {
  return static_cast<int>((backward ? 2 : 1) * (R * Dh + R * Tn) * sizeof(float));
}

// q, k, v, out (B, T, H*Dh) and pos (2T-1, Dh) of one dtype; mask (B, T)
// float32, added to the scores over keys. Dh a multiple of 8.
extern "C" int w2l_mhsa_fwd(const void* q, const void* k, const void* v, const void* pos,
                            const void* mask, void* out, int dtype, int B, int Tn, int H,
                            int Dh, int Tp, int seed, float rate, unsigned thresh,
                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == w2l::kFloat32)
    return launch_fwd<float>(q, k, v, pos, mask, out, B, Tn, H, Dh, Tp, seed, rate, thresh,
                             scale, s);
  if (dtype == w2l::kBFloat16)
    return launch_fwd<__nv_bfloat16>(q, k, v, pos, mask, out, B, Tn, H, Dh, Tp, seed, rate,
                                     thresh, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As the forward, plus g, dq, dk, dv (B, T, H*Dh) of the same dtype; dpos
// (2T-1, Dh) float32; scratch pd, ds (B, H, T, T) of the dtype and part
// (B*H, 2T-1, Dh) float32. Dh a multiple of 8, at most w2l_mhsa_max_head_dim().
extern "C" int w2l_mhsa_bwd(const void* q, const void* k, const void* v, const void* pos,
                            const void* mask, const void* g, void* dq, void* dk, void* dv,
                            void* dpos, void* pd, void* ds, void* part, int dtype, int B,
                            int Tn, int H, int Dh, int Tp, int seed, float rate,
                            unsigned thresh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == w2l::kFloat32)
    return launch_bwd<float>(q, k, v, pos, mask, g, dq, dk, dv, dpos, pd, ds, part, B, Tn, H,
                             Dh, Tp, seed, rate, thresh, scale, s);
  if (dtype == w2l::kBFloat16)
    return launch_bwd<__nv_bfloat16>(q, k, v, pos, mask, g, dq, dk, dv, dpos, pd, ds, part, B,
                                     Tn, H, Dh, Tp, seed, rate, thresh, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
