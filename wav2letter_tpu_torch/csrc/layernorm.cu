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
// Design: one block per row. z = x + y is formed once, in fp32, in shared
// memory (D <= 12 K elements fits in the default 48 KB), so x and y are read
// from HBM once and out is written once. The mean and then the variance of
// z - mu are block reductions (warp shuffles, then one value per warp), the
// same two-pass statistics the TPU kernel computes.
//
// K3b: its backward. Replaces layernorm.py::_bwd (_bwd_kernel):
//   zhat = (z - mu) * rsig;  ghat = g * w
//   dz = rsig * (ghat - mean(ghat) - zhat * mean(ghat * zhat))   (fp32, per row)
// dz is the gradient of both x and y. Bytes bind it as they do the forward.
// The TPU forward writes z = x + y for its backward; this forward writes
// nothing more than it did, and the backward takes x and y and forms z in
// fp32 again: g, x, y in and dz out are four row passes, as many as writing
// z in the forward (one) and reading g and z and writing dz here (three),
// with z exact instead of rounded to bf16 and serving untouched. The two row
// sums it needs anyway, sum(g) and sum(g * zhat), are written per row: their
// totals are the gradients of the scalar bias and weight, which the TPU code
// computes with a second pass over g and z outside its kernel.
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

}  // namespace

// g, x, y, dz (R, D) of one dtype; mu, rsig, row_g, row_gz (R,) and w (1,)
// float32. row_g[r] = sum_i g[r, i]; row_gz[r] = sum_i g[r, i] * zhat[r, i].
extern "C" int w2l_residual_ln_bwd(const void* g, const void* x, const void* y,
                                   const void* mu, const void* rsig, const void* w,
                                   void* dz, void* row_g, void* row_gz, int dtype, int R,
                                   int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == w2l::kFloat32)
    return launch_bwd<float>(g, x, y, mu, rsig, w, dz, row_g, row_gz, R, D, s);
  if (dtype == w2l::kBFloat16)
    return launch_bwd<__nv_bfloat16>(g, x, y, mu, rsig, w, dz, row_g, row_gz, R, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, y, out (R, D) of one dtype; w, b (1,) float32; mu, rsig (R,) float32.
extern "C" int w2l_residual_ln(const void* x, const void* y, const void* w, const void* b,
                               void* out, void* mu, void* rsig, int dtype, int R, int D,
                               float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == w2l::kFloat32) return launch<float>(x, y, w, b, out, mu, rsig, R, D, eps, s);
  if (dtype == w2l::kBFloat16)
    return launch<__nv_bfloat16>(x, y, w, b, out, mu, rsig, R, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
