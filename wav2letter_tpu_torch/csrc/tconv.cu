// K2: time-only convolution in the (B, T, F*C) f-major chain layout.
//
// Replaces the TPU kernel wav2letter_tpu/ops/pallas/tconv.py::time_conv
// (_fwd, _fwd_kernel), whose oracle is tconv.py::time_conv_reference:
//   y[b, t, f, co] = sum_{k, c} xpad[b, t*stride + k, f, c] * w[k, c, co]
// with xpad = x padded by (lp, rp) zero frames in time, weights shared across
// the F frequency positions. Bias and ReLU are fused into the epilogue.
//
// The same kernel computes the gradient with respect to x (dgrad), as
// tconv.py::_time_conv_bwd_rule does with its forward kernel: a stride-1
// correlation of dy with the tap-flipped, transposed weight. For a strided
// conv the TPU code first writes a zero-stuffed copy of dy; here `dil` makes
// the window loader read input frame i/dil where dil divides i and zero
// elsewhere, so no copy is written.
//
// Bound on the H100: in float32, operations. At the flagship widths (C, CO
// 16..28, K 9..12) an output element costs 2*K*C = 288..672 FLOP against 8
// bytes moved (one input and one output element), above the 20 FLOP/byte at
// which the CUDA cores' 67 TFLOP/s meets HBM's 3.35 TB/s. In bfloat16, held
// against the tensor cores' 989 TFLOP/s, the bytes bound it. This first
// version runs the products on the CUDA cores in fp32 for both types.
//
// Design: one block per (batch row, tile of TT output frames, block of Fb
// frequency positions). The K*C*CO weights (at most 12*28*28 fp32 = 37.6 KB)
// and the (TT-1)*stride + K input rows of the block's window, with the time
// padding as zeros at the edges, sit in shared memory as fp32. Each thread
// accumulates a TPT x COV tile (output frames x channels) of one frequency in
// fp32 registers over K*C: per (k, c) it reads TPT window values and COV
// weights and does TPT*COV FMAs. Consecutive threads take consecutive
// channel groups and then frequencies, so the window load and the output
// store are coalesced; in shared memory the frequencies of a window row sit
// an odd number of floats apart, so threads reading different frequencies
// hit different banks.
#include "common.cuh"

namespace {

constexpr int TT = 32;        // output frames per block
constexpr int TPT = 4;        // output frames per thread
constexpr int COV = 4;        // output channels per thread
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
tconv_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const float* __restrict__ bias, T* __restrict__ y, int Tin, int F, int C,
             int CO, int K, int stride, int lp, int Tout, int Fb, int relu, int dil) {
  extern __shared__ float smem[];
  const int rows = (TT - 1) * stride + K;
  const int wsize = K * C * CO;
  const int Cp = C | 1;          // odd float stride between frequencies
  const int wrow = Fb * Cp;
  float* ws = smem;              // [K][C][CO]
  float* xs = smem + wsize;      // [rows][Fb][Cp]

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * TT;
  const int f0 = blockIdx.y * Fb;
  const int fn = min(Fb, F - f0);
  const int tid = threadIdx.x;

  for (int i = tid; i < wsize; i += THREADS) ws[i] = w2l::to_f(w[i]);
  const int row0 = t0 * stride - lp;  // (dilated) input frame of window row 0
  const int Tdil = (Tin - 1) * dil + 1;  // input length after dilation
  const int grow = Fb * C;            // window row in global memory
  const int valid = fn * C;
  const size_t xrow = static_cast<size_t>(F) * C;
  const T* xb = x + static_cast<size_t>(b) * Tin * xrow + static_cast<size_t>(f0) * C;
  for (int i = tid; i < rows * grow; i += THREADS) {
    const int r = i / grow;
    const int e = i - r * grow;
    const int tin = row0 + r;
    float v = 0.f;
    if (e < valid && tin >= 0 && tin < Tdil && tin % dil == 0)
      v = w2l::to_f(xb[(tin / dil) * xrow + e]);
    const int f = e / C;
    xs[r * wrow + f * Cp + (e - f * C)] = v;
  }
  __syncthreads();

  const int ncog = (CO + COV - 1) / COV;
  const int nunits = (TT / TPT) * fn * ncog;
  const size_t yrow = static_cast<size_t>(F) * CO;
  const int qstep = stride * wrow;  // window offset between output frames
  for (int o = tid; o < nunits; o += THREADS) {
    const int cg = o % ncog;
    const int rest = o / ncog;
    const int f = rest % fn;
    const int tt = (rest / fn) * TPT;
    if (t0 + tt >= Tout) continue;
    const int co0 = cg * COV;
    float acc[TPT][COV];
#pragma unroll
    for (int q = 0; q < TPT; ++q) {
#pragma unroll
      for (int r = 0; r < COV; ++r) acc[q][r] = 0.f;
    }
    const float* xw = xs + tt * stride * wrow + f * Cp;
    for (int k = 0; k < K; ++k) {
      const float* xk = xw + k * wrow;
      const float* wk = ws + k * C * CO + co0;
      for (int c = 0; c < C; ++c) {
        float wv[COV];
#pragma unroll
        for (int r = 0; r < COV; ++r) wv[r] = co0 + r < CO ? wk[c * CO + r] : 0.f;
#pragma unroll
        for (int q = 0; q < TPT; ++q) {
          const float xv = xk[q * qstep + c];
#pragma unroll
          for (int r = 0; r < COV; ++r) acc[q][r] = fmaf(xv, wv[r], acc[q][r]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < TPT; ++q) {
      const int t = t0 + tt + q;
      if (t >= Tout) break;
      T* yp = y + (static_cast<size_t>(b) * Tout + t) * yrow +
              static_cast<size_t>(f0 + f) * CO + co0;
#pragma unroll
      for (int r = 0; r < COV; ++r) {
        if (co0 + r < CO) {
          float v = acc[q][r] + (bias != nullptr ? bias[co0 + r] : 0.f);
          if (relu) v = fmaxf(v, 0.f);
          yp[r] = w2l::from_f<T>(v);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* y, int B, int Tin,
           int F, int C, int CO, int K, int stride, int lp, int Tout, int Fb, int relu,
           int dil, cudaStream_t stream) {
  const int rows = (TT - 1) * stride + K;
  const size_t smem =
      (static_cast<size_t>(K) * C * CO + static_cast<size_t>(rows) * Fb * (C | 1)) *
      sizeof(float);
  w2l::allow_smem(tconv_kernel<T>, smem);
  dim3 grid((Tout + TT - 1) / TT, (F + Fb - 1) / Fb, B);
  tconv_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), Tin, F, C, CO, K, stride,
      lp, Tout, Fb, relu, dil);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int w2l_time_conv_tile() { return TT; }

// x (B, Tin, F*C) and w (K, C, CO) of one dtype; bias (CO,) float32 or null;
// y (B, Tout, F*CO) of x's dtype. Output frame t reads the input frames
// t*stride - lp + k of x dilated by dil (dil - 1 zero frames between
// neighbours); frames outside it are zero, so any Tout is valid.
extern "C" int w2l_time_conv(const void* x, const void* w, const void* bias, void* y,
                             int dtype, int B, int Tin, int F, int C, int CO, int K,
                             int stride, int lp, int Tout, int Fb, int relu, int dil,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dil < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == w2l::kFloat32)
    return launch<float>(x, w, bias, y, B, Tin, F, C, CO, K, stride, lp, Tout, Fb, relu,
                         dil, s);
  if (dtype == w2l::kBFloat16)
    return launch<__nv_bfloat16>(x, w, bias, y, B, Tin, F, C, CO, K, stride, lp, Tout, Fb,
                                 relu, dil, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
