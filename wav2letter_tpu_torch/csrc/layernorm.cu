// K3: residual add + per-row LayerNorm with a scalar affine.
//
// Replaces the TPU kernel wav2letter_tpu/ops/pallas/layernorm.py::
// fused_residual_ln (_fwd, _fwd_kernel), whose oracle is models/layers.py::
// LayerNorm applied to x + y (TDSBlock, layers.py:650 and :659):
//   z = x + y;  mu = mean(z);  var = mean((z - mu)^2)   (fp32, per row)
//   out = (z - mu) * rsqrt(var + eps) * w + b,  w and b scalars
// mu and rsig = rsqrt(var + eps) are written for the backward pass.
//
// Bound on the H100: bytes. A row of D = C*F = 1280..2240 elements costs
// ~8 FLOP per element against 6 (bf16) or 12 (fp32) bytes moved (x and y in,
// out back), far below the ~20 FLOP/byte at which compute would bind.
//
// Design, two routes (kernels/layernorm.py::route, C twin
// w2l_residual_ln_warps). Registers (residual_ln_reg_kernel; D * itemsize a
// multiple of 16, D <= 8192 bf16 / 4096 fp32, x, y, out 16-byte aligned):
// one block a row, of 1, 2, 4 or 8 warps, the fewest that keep a lane at
// four 16-byte vectors of each input (8 bf16 or 4 fp32 a vector). Each lane
// reads its vectors of x and y once, keeps z = x + y in registers in fp32,
// and writes out as 16-byte vectors: the row's bytes move once, with no pass
// over shared memory. The mean and then the mean of (z - mu)^2, both in
// fp32, are warp shuffles; a row of several warps adds its warps' sums
// through a few floats of shared memory, in a fixed order. Rows of this
// route's shapes are a few microseconds of bytes each, so a call is bound
// by its ramp and tail as much as by HBM: one row a block, of as few warps
// as four vectors a lane allow, came out faster than several rows a block
// (kernels/time_k1k3.py, PERF.md). Shared memory (residual_ln_kernel; any
// D, any alignment): one block of 256 threads a row; z = x + y is formed
// once, in fp32, in shared memory, so x and y are read from HBM once and
// out is written once; the mean and the variance are block reductions
// (warp shuffles, then one value per warp). Both compute the TPU kernel's
// two-pass statistics.
//
// K3b: its backward. Replaces layernorm.py::_bwd (_bwd_kernel):
//   zhat = (z - mu) * rsig;  ghat = g * w
//   dz = rsig * (ghat - mean(ghat) - zhat * mean(ghat * zhat))   (fp32, per row)
// dz is the gradient of both x and y. The TPU forward writes z = x + y for
// its backward; this forward writes nothing more than it did, and the
// backward takes x and y and forms z in fp32 again: g, x, y in and dz out
// are four row passes, as many as writing z in the forward (one) and reading
// g and z and writing dz here (three), with z exact instead of rounded to
// bf16 and serving untouched. The two row sums it needs anyway, sum(g) and
// sum(g * zhat), are written per row: their totals are the gradients of the
// scalar bias and weight, which the TPU code computes with a second pass
// over g and z outside its kernel.
//
// Bound on the H100: bytes, as the forward. A row element costs ~12 FLOP
// against 8 (bf16) or 16 (fp32) bytes moved, and the rows of the main paths
// (R x D = 768..12312 x 256..2240) are 1.4-75 us of bytes: a call is bound
// by HBM and, at the narrow widths, by its ramp and tail.
//
// Design, two routes (kernels/layernorm.py::bwd_layout, C twin
// w2l_residual_ln_warps). Registers
// (residual_ln_bwd_reg_kernel; K3's register route's widths, g, x, y and dz
// 16-byte aligned): a row is held by the warps K3 gives it, a lane at most
// four 16-byte vectors of each input, and the kernel is compiled for the
// vectors a lane has (1-4), so a narrow row holds no registers it does not
// use and more of its warps are resident at once. Each lane reads its
// vectors of g, x and y once, keeps g and zhat in fp32 registers, forms
// sum(g) and sum(g * zhat) in the same loop, and writes dz as 16-byte
// vectors (bf16 rounded to nearest even): the row's bytes move once and
// nothing but the warps' partial sums goes through shared memory. The two sums are reduced
// as a pair: warp shuffles on both, then, in a row of several warps, one
// barrier and the warps' pairs added in order, so two calls give the same
// bits. A row of 2-8 warps (bf16 D > 1024, fp32 D > 512: the flagship's
// rows) gets a block of its own, as the forward found fastest there. A row
// of one warp (the transformer's, transformer_s2s's and mls's) has no
// barrier at all, and LN_BWD_ROWS of them share a block: a one-warp block
// would leave an SM at 32 resident blocks, half its 64 warps. The launch
// sets the rows a block from the warps a row; LN_BWD_ROWS was chosen by
// timing 1, 2, 4 and 8 (kernels/time_k1k3.py --k3b-rows, which builds a copy
// of this file for each; PERF.md). Shared memory
// (residual_ln_bwd_kernel; any D, any alignment): one block of 256 threads
// a row, g and zhat staged in shared memory for the second pass.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// Sum over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free: no warp still reads a previous sum
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float t = lane < THREADS / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
residual_ln_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const float* __restrict__ w, const float* __restrict__ b,
                   T* __restrict__ out, float* __restrict__ mu_out,
                   float* __restrict__ rsig_out, int D, float eps) {
  extern __shared__ float zs[];  // [D]
  __shared__ float red[THREADS / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  const T* yr = y + row * D;
  T* orow = out + row * D;

  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    const float z = w2l::to_f(xr[i]) + w2l::to_f(yr[i]);
    zs[i] = z;
    s += z;
  }
  const float mu = block_sum(s, red) / D;
  float v = 0.f;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    const float d = zs[i] - mu;
    v = fmaf(d, d, v);
  }
  const float rsig = rsqrtf(block_sum(v, red) / D + eps);
  const float wv = w[0];
  const float bv = b[0];
  for (int i = threadIdx.x; i < D; i += THREADS) {
    orow[i] = w2l::from_f<T>((zs[i] - mu) * rsig * wv + bv);
  }
  if (threadIdx.x == 0) {
    mu_out[row] = mu;
    rsig_out[row] = rsig;
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* w, const void* b, void* out,
           void* mu, void* rsig, int R, int D, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  w2l::allow_smem(residual_ln_kernel<T>, smem);
  residual_ln_kernel<T><<<R, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(out), static_cast<float*>(mu),
      static_cast<float*>(rsig), D, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K3, registers
// ---------------------------------------------------------------------------
constexpr int LN_VECTORS = 4;    // 16-byte vectors of x (and of y) a lane holds at most
constexpr int LN_MAX_WARPS = 8;  // warps a row, and a block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of T as N fp32 values: read through the read-only cache, written
// as one 16-byte store. bf16 goes by its bits (the top half of an fp32),
// rounded to nearest even on the way out.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                                              __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(unsigned w, float& lo, float& hi) {
    lo = __uint_as_float(w << 16);
    hi = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static unsigned pack(float lo, float hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    unpack(u.x, v[0], v[1]);
    unpack(u.y, v[2], v[3]);
    unpack(u.z, v[4], v[5]);
    unpack(u.w, v[6], v[7]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
};

// The sum over the block (one row), for every thread: warp shuffles, then
// (several warps) the warps' sums added in order through red.
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  const int warps = blockDim.x >> 5;
  if (warps == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < warps; ++i) t += red[i];
  return t;
}

template <typename T>
__global__ void __launch_bounds__(32 * LN_MAX_WARPS)
residual_ln_reg_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const float* __restrict__ w, const float* __restrict__ b,
                       T* __restrict__ out, float* __restrict__ mu_out,
                       float* __restrict__ rsig_out, int D, float eps) {
  constexpr int N = Vec16<T>::N;
  __shared__ float red[2][LN_MAX_WARPS];  // the sums, then the squares
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  const int nvec = D / N, step = blockDim.x;

  float z[LN_VECTORS][N];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < LN_VECTORS; ++k) {
    const int v = threadIdx.x + k * step;
    if (v < nvec) {
      float a[N], c[N];
      Vec16<T>::load(x + base + static_cast<size_t>(v) * N, a);
      Vec16<T>::load(y + base + static_cast<size_t>(v) * N, c);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        z[k][e] = a[e] + c[e];
        s += z[k][e];
      }
    }
  }
  const float mu = row_sum(s, red[0]) / D;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < LN_VECTORS; ++k) {
    if (threadIdx.x + k * step < nvec) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float d = z[k][e] - mu;
        q = fmaf(d, d, q);
      }
    }
  }
  const float rsig = rsqrtf(row_sum(q, red[1]) / D + eps);
  const float wv = w[0];
  const float bv = b[0];
#pragma unroll
  for (int k = 0; k < LN_VECTORS; ++k) {
    const int v = threadIdx.x + k * step;
    if (v < nvec) {
      float o[N];
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = (z[k][e] - mu) * rsig * wv + bv;
      Vec16<T>::store(out + base + static_cast<size_t>(v) * N, o);
    }
  }
  if (threadIdx.x == 0) {
    mu_out[blockIdx.x] = mu;
    rsig_out[blockIdx.x] = rsig;
  }
}

template <typename T>
int launch_reg(const void* x, const void* y, const void* w, const void* b, void* out,
               void* mu, void* rsig, int R, int D, float eps, int wpr, cudaStream_t stream) {
  if (wpr < 1 || wpr > LN_MAX_WARPS) return static_cast<int>(cudaErrorInvalidValue);
  residual_ln_reg_kernel<T><<<R, 32 * wpr, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(out), static_cast<float*>(mu),
      static_cast<float*>(rsig), D, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
residual_ln_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                       const T* __restrict__ y, const float* __restrict__ mu,
                       const float* __restrict__ rsig, const float* __restrict__ w,
                       T* __restrict__ dz, float* __restrict__ row_g,
                       float* __restrict__ row_gz, int D) {
  extern __shared__ float sm[];  // zhat [D], g [D]
  __shared__ float red[THREADS / 32];
  float* zh = sm;
  float* gs = sm + D;
  const size_t row = blockIdx.x;
  const T* gr = g + row * D;
  const T* xr = x + row * D;
  const T* yr = y + row * D;
  T* drow = dz + row * D;
  const float m = mu[row];
  const float rs = rsig[row];

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    const float gv = w2l::to_f(gr[i]);
    const float zv = (w2l::to_f(xr[i]) + w2l::to_f(yr[i]) - m) * rs;
    gs[i] = gv;
    zh[i] = zv;
    s1 += gv;
    s2 = fmaf(gv, zv, s2);
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  const float wv = w[0];
  const float m1 = wv * s1 / D;
  const float m2 = wv * s2 / D;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    drow[i] = w2l::from_f<T>(rs * (wv * gs[i] - m1 - zh[i] * m2));
  }
  if (threadIdx.x == 0) {
    row_g[row] = s1;
    row_gz[row] = s2;
  }
}

template <typename T>
int launch_bwd(const void* g, const void* x, const void* y, const void* mu,
               const void* rsig, const void* w, void* dz, void* row_g, void* row_gz, int R,
               int D, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(D) * sizeof(float);
  w2l::allow_smem(residual_ln_bwd_kernel<T>, smem);
  residual_ln_bwd_kernel<T><<<R, THREADS, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const float*>(mu), static_cast<const float*>(rsig),
      static_cast<const float*>(w), static_cast<T*>(dz), static_cast<float*>(row_g),
      static_cast<float*>(row_gz), D);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K3b, registers
// ---------------------------------------------------------------------------
constexpr int LN_BWD_ROWS = 4;  // one-warp rows a block

// wpr warps a row, V 16-byte vectors of each input a lane at most (V is a
// template parameter so that a narrow row holds no registers for vectors it
// never has). wpr = 1: a row a warp, blockDim.x / 32 rows a block, no
// barrier; wpr > 1: one row a block of wpr warps.
template <typename T, int V>
__global__ void __launch_bounds__(32 * LN_MAX_WARPS)
residual_ln_bwd_reg_kernel(const T* __restrict__ g, const T* __restrict__ x,
                           const T* __restrict__ y, const float* __restrict__ mu,
                           const float* __restrict__ rsig, const float* __restrict__ w,
                           T* __restrict__ dz, float* __restrict__ row_g,
                           float* __restrict__ row_gz, int R, int D, int wpr) {
  constexpr int N = Vec16<T>::N;
  __shared__ float red[2][LN_MAX_WARPS];  // the warps' sum(g), then sum(g * zhat)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = wpr == 1 ? blockIdx.x * (blockDim.x >> 5) + warp : blockIdx.x;
  if (row >= R) return;  // only a one-warp row past the last: no barrier follows
  const int t = wpr == 1 ? lane : threadIdx.x;
  const int step = 32 * wpr;
  const size_t base = static_cast<size_t>(row) * D;
  const int nvec = D / N;
  const float m = mu[row];
  const float rs = rsig[row];

  float gv[V][N], zh[V][N];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = t + k * step;
    if (v < nvec) {
      const size_t off = base + static_cast<size_t>(v) * N;
      float a[N], c[N];
      Vec16<T>::load(g + off, gv[k]);
      Vec16<T>::load(x + off, a);
      Vec16<T>::load(y + off, c);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        zh[k][e] = (a[e] + c[e] - m) * rs;
        s1 += gv[k][e];
        s2 = fmaf(gv[k][e], zh[k][e], s2);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (wpr > 1) {
    if (lane == 0) {
      red[0][warp] = s1;
      red[1][warp] = s2;
    }
    __syncthreads();
    s1 = 0.f;
    s2 = 0.f;
    for (int i = 0; i < wpr; ++i) {
      s1 += red[0][i];
      s2 += red[1][i];
    }
  }
  const float wv = w[0];
  const float m1 = wv * s1 / D;
  const float m2 = wv * s2 / D;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = t + k * step;
    if (v < nvec) {
      float o[N];
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = rs * (wv * gv[k][e] - m1 - zh[k][e] * m2);
      Vec16<T>::store(dz + base + static_cast<size_t>(v) * N, o);
    }
  }
  if (t == 0) {
    row_g[row] = s1;
    row_gz[row] = s2;
  }
}

template <typename T, int V>
void launch_bwd_reg_v(const void* g, const void* x, const void* y, const void* mu,
                      const void* rsig, const void* w, void* dz, void* row_g, void* row_gz,
                      int R, int D, int wpr, int rows, cudaStream_t stream) {
  residual_ln_bwd_reg_kernel<T, V><<<(R + rows - 1) / rows, 32 * wpr * rows, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const float*>(mu), static_cast<const float*>(rsig),
      static_cast<const float*>(w), static_cast<T*>(dz), static_cast<float*>(row_g),
      static_cast<float*>(row_gz), R, D, wpr);
}

template <typename T>
int launch_bwd_reg(const void* g, const void* x, const void* y, const void* mu,
                   const void* rsig, const void* w, void* dz, void* row_g, void* row_gz,
                   int R, int D, int wpr, cudaStream_t stream) {
  const int n = Vec16<T>::N;
  if (wpr < 1 || wpr > LN_MAX_WARPS || D % n != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = wpr == 1 ? LN_BWD_ROWS : 1;  // a block's rows
  const int vecs = (D / n + 32 * wpr - 1) / (32 * wpr);  // a lane's vectors
  switch (vecs) {
    case 1: launch_bwd_reg_v<T, 1>(g, x, y, mu, rsig, w, dz, row_g, row_gz, R, D, wpr, rows,
                                   stream); break;
    case 2: launch_bwd_reg_v<T, 2>(g, x, y, mu, rsig, w, dz, row_g, row_gz, R, D, wpr, rows,
                                   stream); break;
    case 3: launch_bwd_reg_v<T, 3>(g, x, y, mu, rsig, w, dz, row_g, row_gz, R, D, wpr, rows,
                                   stream); break;
    case 4: launch_bwd_reg_v<T, 4>(g, x, y, mu, rsig, w, dz, row_g, row_gz, R, D, wpr, rows,
                                   stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);  // more than LN_VECTORS
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g, x, y, dz (R, D) of one dtype; mu, rsig, row_g, row_gz (R,) and w (1,)
// float32. row_g[r] = sum_i g[r, i]; row_gz[r] = sum_i g[r, i] * zhat[r, i].
// wpr > 0: the register route, wpr warps a row (g, x, y and dz 16-byte
// aligned, D * itemsize a multiple of 16), LN_BWD_ROWS rows a block of one
// warp, one row a block of more; wpr = 0: the shared-memory route.
extern "C" int w2l_residual_ln_bwd(const void* g, const void* x, const void* y,
                                   const void* mu, const void* rsig, const void* w,
                                   void* dz, void* row_g, void* row_gz, int dtype, int R,
                                   int D, int wpr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wpr > 0) {
    if (dtype == w2l::kFloat32)
      return launch_bwd_reg<float>(g, x, y, mu, rsig, w, dz, row_g, row_gz, R, D, wpr, s);
    if (dtype == w2l::kBFloat16)
      return launch_bwd_reg<__nv_bfloat16>(g, x, y, mu, rsig, w, dz, row_g, row_gz, R, D, wpr,
                                           s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == w2l::kFloat32)
    return launch_bwd<float>(g, x, y, mu, rsig, w, dz, row_g, row_gz, R, D, s);
  if (dtype == w2l::kBFloat16)
    return launch_bwd<__nv_bfloat16>(g, x, y, mu, rsig, w, dz, row_g, row_gz, R, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Warps a row of the register route for D elements of the dtype, 0 where it
// does not take D (kernels/layernorm.py::warps_per_row): the fewest of 1, 2,
// 4, 8 that keep a lane at LN_VECTORS 16-byte vectors of each input or
// fewer, D * itemsize a multiple of 16.
extern "C" int w2l_residual_ln_warps(int D, int dtype) {
  const int n = dtype == w2l::kBFloat16 ? 8 : 4;
  if (D <= 0 || D % n != 0) return 0;
  const int nvec = D / n;
  for (int wpr = 1; wpr <= LN_MAX_WARPS; wpr *= 2)
    if ((nvec + 32 * wpr - 1) / (32 * wpr) <= LN_VECTORS) return wpr;
  return 0;
}

// x, y, out (R, D) of one dtype; w, b (1,) float32; mu, rsig (R,) float32.
// wpr > 0: the register route, a block of wpr warps a row (x, y and out
// 16-byte aligned, D * itemsize a multiple of 16); wpr = 0: the
// shared-memory route.
extern "C" int w2l_residual_ln(const void* x, const void* y, const void* w, const void* b,
                               void* out, void* mu, void* rsig, int dtype, int R, int D,
                               float eps, int wpr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wpr > 0) {
    if (dtype == w2l::kFloat32)
      return launch_reg<float>(x, y, w, b, out, mu, rsig, R, D, eps, wpr, s);
    if (dtype == w2l::kBFloat16)
      return launch_reg<__nv_bfloat16>(x, y, w, b, out, mu, rsig, R, D, eps, wpr, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == w2l::kFloat32) return launch<float>(x, y, w, b, out, mu, rsig, R, D, eps, s);
  if (dtype == w2l::kBFloat16)
    return launch<__nv_bfloat16>(x, y, w, b, out, mu, rsig, R, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
