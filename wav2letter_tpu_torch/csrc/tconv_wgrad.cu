// K2b: weight gradient of the time convolution in the (B, T, F*C) f-major
// chain layout.
//
// Replaces the TPU kernel wav2letter_tpu/ops/pallas/tconv.py::_wgrad
// (_wgrad_kernel):
//   dw[k, c, co] = sum_{b, t, f} xpad[b, t*stride + k, f, c] * dy[b, t, f, co]
// with xpad = x padded by (lp, rp) zero frames in time; dw is float32 whatever
// the type of x and dy, and every product accumulates in float32.
//
// Bound on the H100: the same operations as the forward conv (2*K*C FLOP per
// element of dy), so operations in float32; in bfloat16, held against the
// tensor cores, the bytes of x and dy. This first version runs the products
// on the CUDA cores in fp32 for both types.
//
// Design. The TPU kernel carries one accumulator through its sequential
// grid; here blocks run in parallel, so the sum over (b, t, f) is split in
// two ordered passes and uses no atomics: the same inputs give the same bits.
//   Pass 1: the (batch row, tile of TT output frames, block of Fb
// frequencies) tiles are dealt to a fixed number of blocks round-robin. A
// block keeps its own K*C*CO partial sum in shared memory. For each tile it
// loads the window of x (time pads as zeros; frames past the last one an
// output touches are simply not read) and the tile of dy into shared memory
// as fp32; a thread owns units of KV taps x COV output channels of one input
// channel, accumulates a unit over the tile in registers, and adds it to the
// block's partial sum, which no other thread touches. Lanes of a warp hold
// neighbouring channel groups and input channels, so their shared-memory
// reads are broadcasts or fall in different banks. At C = 1 (the first conv)
// few threads have a unit; its share of the work is small and it keeps the
// same geometry.
//   Pass 2: one thread per weight sums the blocks' partials in block order.
#include "common.cuh"

namespace {

constexpr int TT = 32;   // output frames per tile
constexpr int KV = 4;    // taps per unit
constexpr int COV = 4;   // output channels per unit
constexpr int THREADS = 256;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     float* __restrict__ partial, int B, int Tin, int F, int C, int CO,
                     int K, int stride, int lp, int Tout, int Fb) {
  extern __shared__ float smem[];
  const int KG = (K + KV - 1) / KV;
  const int COG = (CO + COV - 1) / COV;
  const int COp = COG * COV;     // dy channels padded with zeros to whole units
  const int Cp = C | 1;          // odd float stride between frequencies
  const int rows = (TT - 1) * stride + KG * KV;
  const int wsize = K * C * CO;
  const int wrow = Fb * Cp;      // one window row
  const int drow = Fb * COp;     // one dy row
  float* dws = smem;                          // [K][C][CO]
  float* xs = dws + round4(wsize);            // [rows][Fb][Cp]
  float* dys = xs + round4(rows * wrow);      // [TT][Fb][COp], 16-byte aligned
  const int tid = threadIdx.x;

  for (int i = tid; i < wsize; i += THREADS) dws[i] = 0.f;

  const int nT = (Tout + TT - 1) / TT;
  const int nF = (F + Fb - 1) / Fb;
  const int tiles = B * nT * nF;
  const int nunits = KG * C * COG;
  const size_t xrow = static_cast<size_t>(F) * C;
  const size_t yrow = static_cast<size_t>(F) * CO;
  const int grow = Fb * C;  // window row in global memory

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int fb = tile % nF;
    const int tb = (tile / nF) % nT;
    const int b = tile / (nF * nT);
    const int t0 = tb * TT;
    const int f0 = fb * Fb;
    const int fn = min(Fb, F - f0);
    const int row0 = t0 * stride - lp;  // input frame of window row 0
    __syncthreads();  // the previous tile's readers are done (and dws is zeroed)

    const T* xb = x + static_cast<size_t>(b) * Tin * xrow + static_cast<size_t>(f0) * C;
    const int valid = fn * C;
    for (int i = tid; i < rows * grow; i += THREADS) {
      const int r = i / grow;
      const int e = i - r * grow;
      const int tin = row0 + r;
      float v = 0.f;
      if (e < valid && tin >= 0 && tin < Tin) v = w2l::to_f(xb[tin * xrow + e]);
      const int f = e / C;
      xs[r * wrow + f * Cp + (e - f * C)] = v;
    }
    const T* dyb = dy + static_cast<size_t>(b) * Tout * yrow + static_cast<size_t>(f0) * CO;
    for (int i = tid; i < TT * drow; i += THREADS) {
      const int t = i / drow;
      const int rem = i - t * drow;
      const int f = rem / COp;
      const int co = rem - f * COp;
      float v = 0.f;
      if (t0 + t < Tout && f < fn && co < CO)
        v = w2l::to_f(dyb[(t0 + t) * yrow + f * CO + co]);
      dys[i] = v;
    }
    __syncthreads();

    for (int u = tid; u < nunits; u += THREADS) {
      const int cg = u % COG;
      const int rest = u / COG;
      const int c = rest % C;
      const int kg = rest / C;
      float acc[KV][COV];
#pragma unroll
      for (int j = 0; j < KV; ++j) {
#pragma unroll
        for (int r = 0; r < COV; ++r) acc[j][r] = 0.f;
      }
      for (int f = 0; f < fn; ++f) {
        const float* xp = xs + kg * KV * wrow + f * Cp + c;
        const float* dp = dys + f * COp + cg * COV;
#pragma unroll 4
        for (int t = 0; t < TT; ++t) {
          const float4 d = *reinterpret_cast<const float4*>(dp + t * drow);
#pragma unroll
          for (int j = 0; j < KV; ++j) {
            const float xv = xp[(t * stride + j) * wrow];
            acc[j][0] = fmaf(xv, d.x, acc[j][0]);
            acc[j][1] = fmaf(xv, d.y, acc[j][1]);
            acc[j][2] = fmaf(xv, d.z, acc[j][2]);
            acc[j][3] = fmaf(xv, d.w, acc[j][3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KV; ++j) {
        const int k = kg * KV + j;
        if (k >= K) break;
#pragma unroll
        for (int r = 0; r < COV; ++r) {
          const int co = cg * COV + r;
          if (co < CO) dws[(k * C + c) * CO + co] += acc[j][r];
        }
      }
    }
  }
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * wsize;
  for (int i = tid; i < wsize; i += THREADS) out[i] = dws[i];
}

__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dw, int nb, int wsize) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wsize) return;
  float s = 0.f;
  for (int j = 0; j < nb; ++j) s += partial[static_cast<size_t>(j) * wsize + i];
  dw[i] = s;
}

size_t smem_bytes(int C, int CO, int K, int stride, int Fb) {
  const int KG = (K + KV - 1) / KV;
  const int COp = (CO + COV - 1) / COV * COV;
  const int rows = (TT - 1) * stride + KG * KV;
  return (static_cast<size_t>(round4(K * C * CO)) + round4(rows * Fb * (C | 1)) +
          static_cast<size_t>(TT) * Fb * COp) * sizeof(float);
}

template <typename T>
int launch(const void* x, const void* dy, void* partial, void* dw, int B, int Tin, int F,
           int C, int CO, int K, int stride, int lp, int Tout, int Fb, int nb,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(C, CO, K, stride, Fb);
  w2l::allow_smem(wgrad_partial_kernel<T>, smem);
  wgrad_partial_kernel<T><<<nb, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<float*>(partial), B,
      Tin, F, C, CO, K, stride, lp, Tout, Fb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wsize = K * C * CO;
  wgrad_reduce_kernel<<<(wsize + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), nb, wsize);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int w2l_time_conv_wgrad_tile() { return TT; }

// Floats of shared memory one frequency of a tile takes, beside the K*C*CO
// partial sum: the wrapper sizes Fb with it.
extern "C" int w2l_time_conv_wgrad_window(int C, int CO, int K, int stride) {
  return static_cast<int>((smem_bytes(C, CO, K, stride, 1) -
                           round4(K * C * CO) * sizeof(float)) / sizeof(float));
}

// x (B, Tin, F*C) and dy (B, Tout, F*CO) of one dtype; partial (nb, K*C*CO)
// and dw (K, C, CO) float32. nb blocks share the tiles of pass 1.
extern "C" int w2l_time_conv_wgrad(const void* x, const void* dy, void* partial, void* dw,
                                   int dtype, int B, int Tin, int F, int C, int CO, int K,
                                   int stride, int lp, int Tout, int Fb, int nb,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 1 || Fb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == w2l::kFloat32)
    return launch<float>(x, dy, partial, dw, B, Tin, F, C, CO, K, stride, lp, Tout, Fb, nb, s);
  if (dtype == w2l::kBFloat16)
    return launch<__nv_bfloat16>(x, dy, partial, dw, B, Tin, F, C, CO, K, stride, lp, Tout,
                                 Fb, nb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
