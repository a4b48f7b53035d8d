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
// against the tensor cores' 989 TFLOP/s, the bytes bound it. Two routes:
// bf16 runs on the tensor cores (tconv_tc_kernel, below), where the shape
// allows (kernels/tconv.py::tc_takes); float32, and bf16 shapes the tensor
// cores' route does not take, run on the CUDA cores (tconv_kernel).
//
// CUDA cores: one block per (batch row, tile of TT output frames, block of Fb
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
#include "tc_tile.cuh"

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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
// The conv as an implicit GEMM: rows are the positions (t, f) of a block's
// tile, 16 frequencies of one output frame to an m-tile; columns are CO,
// padded to n-tiles of 8; the reduction runs over (k, c). For a fixed tap k
// the A operand of frame t is ring row t * stride + k, channels contiguous:
// row-major, read by ldmatrix with one address per lane, which is how the
// stride is taken. The B operand is w[k] (C x CO), bf16 in shared memory
// with rows c in [C, Cp) zero, read by ldmatrix.trans. mma.sync m16n8k16 on
// bf16 with fp32 sums, and m16n8k8 for the last 8 channels where Cp is not a
// multiple of 16. At C = 1 (the first conv) the taps are the reduction
// instead: A of frame t is the 16 ring rows t * stride + kk, read transposed
// (ldmatrix.trans: ring rows are taps, positions contiguous), taps at or
// past K masked to zero in the registers; one k16 step covers K <= 16 taps.
//
// A block of 8 warps walks CH tiles of TT = 16 frames; warp w takes frames w
// and w + 8 of each, and loads each B fragment once for both; a step's
// fragments are loaded (ldmatrix) while the step before runs its mma.sync.
// The weight arrives by cp.async with the first window; the next tile's
// frames are copied (cp.async into the ring, tc_tile.cuh) while this tile's
// products run. Epilogue in registers: bias, ReLU, bf16 rounding, and stores
// of bf16 pairs.
namespace tc = w2l::tc;
using tc::Ring;

struct TcLayout {
  Ring rg;
  int Cp;    // channels padded to 8 (the reduction of one tap)
  int KR;    // rows of the staged weight: K * Cp, or 16 per k-step of taps
  int COe;   // elements per staged weight row
  int bytes; // dynamic shared memory
};

__host__ __device__ inline TcLayout tc_layout(int C, int CO, int K, int stride) {
  using namespace w2l::tc;
  TcLayout L;
  L.Cp = pad8(C);
  L.rg = make_ring(C, odd_units(L.Cp), stride, K - 1);
  L.KR = C == 1 ? pad16(K) : K * L.Cp;
  L.COe = odd_units(pad8(CO));
  L.bytes = 2 * L.KR * L.COe + 2 * L.rg.NR * L.rg.RP + 4 * table_entries(C);
  return L;
}

template <int NT>
__global__ void __launch_bounds__(w2l::tc::THREADS, 2)
tconv_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int Tin, int F,
                int C, int CO, int K, int stride, int lp, int Tout, int relu, int dil, int CH,
                int G) {
  using namespace w2l::tc;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const TcLayout L = tc_layout(C, CO, K, stride);
  const Ring& rg = L.rg;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* ring = ws + L.KR * L.COe;
  int* table = reinterpret_cast<int*>(ring + rg.NR * rg.RP);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, f0 = blockIdx.y * FB;
  const int nT = (Tout + tc::TT - 1) / tc::TT;
  const int tile0 = blockIdx.x * CH;
  const int ntiles = min(CH, nT - tile0);
  if (ntiles <= 0) return;

  // the weight, zero outside (K, C, CO): by cp.async with the first window
  // where CO is even, else a row a thread; the ring, zero (its channel pads
  // are never written again); the copy units of a ring row
  const uint32_t ring_s = smem_addr(ring), ws_s = smem_addr(ws);
  if ((CO & 1) == 0) {
    const int gw = CO % 8 == 0 ? 16 : CO % 4 == 0 ? 8 : 4;
    stage_weight(ws_s, w, L.KR, L.COe, CO, gw, [&](int row) {
      if (rg.tap) return row < K ? row : -1;
      const int k = row / L.Cp, c = row - k * L.Cp;
      return c < C ? k * C + c : -1;
    }, tid);
  } else {
    for (int row = tid; row < L.KR; row += tc::THREADS) {
      const int k = rg.tap ? row : row / L.Cp, c = rg.tap ? 0 : row - k * L.Cp;
      const bool real = rg.tap ? row < K : c < C;
      const __nv_bfloat16* src = w + (static_cast<size_t>(k) * C + c) * CO;
      for (int co = 0; co < L.COe; ++co)
        ws[row * L.COe + co] = real && co < CO ? src[co] : __float2bfloat16(0.f);
    }
  }
  uint4* rz = reinterpret_cast<uint4*>(ring);
  for (int i = tid; i < rg.NR * rg.RP / 8; i += tc::THREADS) rz[i] = make_uint4(0, 0, 0, 0);
  fill_table(table, C, rg.Pe, G, tid);
  __syncthreads();

  const int t_first = tile0 * tc::TT;
  const int xbase = t_first * stride - lp;  // dilated input row of ring slot 0
  const int Tdil = (Tin - 1) * dil + 1;
  const int fleft = F - f0;
  const __nv_bfloat16* xb =
      x + static_cast<size_t>(b) * Tin * F * C + static_cast<size_t>(f0) * C;
  stage_rows(ring_s, xb, table, rg, xbase, rg.W, xbase, Tdil, dil, F, C, fleft, G, tid);
  cp_async_commit();

  // per-lane parts of the ldmatrix addresses (bytes)
  const int mat = lane >> 3, li = lane & 7;
  const int g = lane >> 2, q = lane & 3;
  const int b16_off = 2 * (((mat & 1) * 8 + li) * L.COe + (mat >> 1) * 8);
  const int b8_off = 2 * (li * L.COe + mat * 8);
  const int a16_off = 2 * (((mat & 1) * 8 + li) * rg.Pe + (mat >> 1) * 8);
  const int a8_off = 2 * ((lane & 15) * rg.Pe);
  const int tap_kk = (mat >> 1) * 8 + li, tap_f = (mat & 1) * 8;
  const int nk16 = L.Cp >> 4, has_k8 = L.Cp & 8;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles)
      stage_rows(ring_s, xb, table, rg, xbase + rg.W + it * tc::TT * stride,
                 tc::TT * stride, xbase, Tdil, dil, F, C, fleft, G, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int tb = it * tc::TT;  // the tile's first frame, from t_first
    const int tl[2] = {warp, warp + WARPS};
    const bool on0 = t_first + tb + tl[0] < Tout;
    const bool on1 = t_first + tb + tl[1] < Tout;
    float acc[2][NT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

    if (on0) {
      if (rg.tap) {
        for (int ks = 0; ks * 16 < K; ++ks) {
          uint32_t bf[NT][2];
          load_b16<NT>(bf, ws_s + 2 * ks * 16 * L.COe, b16_off);
          // taps at or past K are zeros in the A registers
          const int k0 = ks * 16 + 2 * q;
          const uint32_t m01 = (k0 < K ? 0xffffu : 0u) | (k0 + 1 < K ? 0xffff0000u : 0u);
          const uint32_t m23 =
              (k0 + 8 < K ? 0xffffu : 0u) | (k0 + 9 < K ? 0xffff0000u : 0u);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (m == 1 && !on1) break;
            const int slot = ((tb + tl[m]) * stride + ks * 16 + tap_kk) % rg.NR;
            uint32_t a[4];
            ldsm_x4_trans(a, ring_s + 2 * (slot * rg.RP + tap_f));
            a[0] &= m01;
            a[1] &= m01;
            a[2] &= m23;
            a[3] &= m23;
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_k16(acc[m][j], a, bf[j][0], bf[j][1]);
          }
        }
      } else {
        int base[2];  // ring slots of frames tl[m]'s first window row
#pragma unroll
        for (int m = 0; m < 2; ++m) base[m] = ((tb + tl[m]) * stride) % rg.NR;
        // the k16 steps, (k, cs) in order, then the k8 step of each tap
        struct F16 {
          uint32_t b[NT][2], a[2][4];
        } p16, q16;
        struct F8 {
          uint32_t b[NT], a[2][2];
        } p8, q8;
        int lk = 0, lc = 0;  // the next step to load
        pipelined(K * nk16, p16, q16, [&](F16& f) {
          load_b16<NT>(f.b, ws_s + 2 * (lk * L.Cp + lc * 16) * L.COe, b16_off);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (m == 1 && !on1) break;
            const int sl = base[m] + lk < rg.NR ? base[m] + lk : base[m] + lk - rg.NR;
            ldsm_x4(f.a[m], ring_s + 2 * (sl * rg.RP + lc * 16) + a16_off);
          }
          if (++lc == nk16) {
            lc = 0;
            ++lk;
          }
        }, [&](const F16& f) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (m == 1 && !on1) break;
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_k16(acc[m][j], f.a[m], f.b[j][0], f.b[j][1]);
          }
        });
        lk = 0;
        pipelined(has_k8 ? K : 0, p8, q8, [&](F8& f) {
          load_b8<NT>(f.b, ws_s + 2 * (lk * L.Cp + nk16 * 16) * L.COe, b8_off);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (m == 1 && !on1) break;
            const int sl = base[m] + lk < rg.NR ? base[m] + lk : base[m] + lk - rg.NR;
            ldsm_x2(f.a[m], ring_s + 2 * (sl * rg.RP + nk16 * 16) + a8_off);
          }
          ++lk;
        }, [&](const F8& f) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (m == 1 && !on1) break;
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_k8(acc[m][j], f.a[m][0], f.a[m][1], f.b[j]);
          }
        });
      }
      // epilogue: rows g and g + 8 of an m-tile are positions f0 + g (+ 8)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int t = t_first + tb + tl[m];
        if (t >= Tout) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = g + 8 * h;
          if (f >= fleft) continue;
          __nv_bfloat16* yp = y + (static_cast<size_t>(b) * Tout + t) * F * CO +
                              static_cast<size_t>(f0 + f) * CO;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int co = j * 8 + 2 * q;
            if (co >= CO) continue;
            float v0 = acc[m][j][2 * h] + (bias != nullptr ? bias[co] : 0.f);
            if (relu) v0 = fmaxf(v0, 0.f);
            if (co + 1 < CO) {
              float v1 = acc[m][j][2 * h + 1] + (bias != nullptr ? bias[co + 1] : 0.f);
              if (relu) v1 = fmaxf(v1, 0.f);
              if ((CO & 1) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(yp + co) = __floats2bfloat162_rn(v0, v1);
              } else {
                yp[co] = __float2bfloat16(v0);
                yp[co + 1] = __float2bfloat16(v1);
              }
            } else {
              yp[co] = __float2bfloat16(v0);
            }
          }
        }
      }
    }
    __syncthreads();  // the ring slots this tile read are free for the next copies
  }
}

template <int NT>
int launch_tc(const void* x, const void* w, const void* bias, void* y, int B, int Tin, int F,
              int C, int CO, int K, int stride, int lp, int Tout, int relu, int dil, int CH,
              int G, cudaStream_t stream) {
  const size_t smem = tc_layout(C, CO, K, stride).bytes;
  w2l::allow_smem(tconv_tc_kernel<NT>, smem);
  const int nT = (Tout + w2l::tc::TT - 1) / w2l::tc::TT;
  dim3 grid((nT + CH - 1) / CH, (F + w2l::tc::FB - 1) / w2l::tc::FB, B);
  tconv_tc_kernel<NT><<<grid, w2l::tc::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), Tin, F, C, CO, K,
      stride, lp, Tout, relu, dil, CH, G);
  return static_cast<int>(cudaGetLastError());
}

// launch_tc<NT> for NT = nt, the n-tiles of 8 output channels (1..8)
template <int NT = 1, typename... A>
int launch_nt(int nt, A... a) {
  if constexpr (NT > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (nt == NT) return launch_tc<NT>(a...);
    return launch_nt<NT + 1>(nt, a...);
  }
}

}  // namespace

extern "C" int w2l_time_conv_tile() { return TT; }

// Dynamic shared memory of the bf16 tensor-core kernel for a conv of K taps
// at `stride` (1 for dgrad) from C to CO channels; kernels/tconv.py mirrors it.
extern "C" int w2l_time_conv_tc_smem_bytes(int C, int CO, int K, int stride) {
  return tc_layout(C, CO, K, stride).bytes;
}

// The bf16 conv of w2l_time_conv on the tensor cores, CO <= 64; C even, or
// C = 1. G, the bytes of one cp.async (16, 8 or 4), divides the bytes of a
// position's C channels (of the block's 16 positions at C = 1) and of a row
// of F*C, and x is aligned to it; a block walks CH tiles of 16 frames.
extern "C" int w2l_time_conv_tc(const void* x, const void* w, const void* bias, void* y,
                                int B, int Tin, int F, int C, int CO, int K, int stride,
                                int lp, int Tout, int relu, int dil, int CH, int G,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dil < 1 || CH < 1 || (G != 16 && G != 8 && G != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_nt((CO + 7) / 8, x, w, bias, y, B, Tin, F, C, CO, K, stride, lp, Tout, relu,
                   dil, CH, G, s);
}

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
