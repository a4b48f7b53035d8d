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
// Bound on the H100: at the flagship widths (C, CO 16..28, K 9..12) an
// output element costs 2*K*C = 288..672 FLOP against 8 bytes moved (one
// input and one output element). In float32, counted at the card's fastest
// fp32-accurate rate (3xTF32 on the tensor cores, 495 / 3 TFLOP/s), that is
// about where operations and HBM's 3.35 TB/s meet; in bfloat16, held against
// the tensor cores' 989 TFLOP/s, the bytes bound it. Four routes, by shape
// (kernels/tconv.py::route): fp32 on the tensor cores in 3xTF32
// (tconv_tf32_kernel) and bf16 on the tensor cores (tconv_tc_kernel), where
// their shared memory and widths allow (tc_takes); the wide route
// (tconv_wide.cu) for CO past 64 over at most 16 (tap, channel) pairs, CPC's
// first conv (bound by the bytes of y); the CUDA cores (tconv_kernel) for the
// shapes none of them takes.
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
#include "mma.cuh"
#include "tc_tile.cuh"
#include "tf32_tile.cuh"

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
// fp32 on the tensor cores (3xTF32)
// ---------------------------------------------------------------------------
// The conv as the bf16 route's implicit GEMM (below): rows are 16 frequency
// positions of one output frame (an m-tile), columns CO padded to n-tiles of
// 8, the reduction over (k, c) in k8 steps with C padded to 8; at C = 1 the
// taps are the reduction, 8 a step. Each product is three m16n8k8 TF32
// mma.sync (3xTF32, mma.cuh), so every output sums its K*C products with
// fp32's digits, as the JAX reference's HIGHEST asks.
//   Fragments come by 32-bit shared loads, each of the 32 lanes on its own
// bank: ring positions sit Pe = pad8(C) + 4 floats apart (4 mod 8), taps
// rows 24 floats (8 mod 32), weight rows (k, c) WP floats (CO padded to an
// odd multiple of 8). The weight is copied k-major as it lies in memory
// (cp.async) and split into its big and small TF32 halves in place, once,
// by the thread that copied it (with split taps, where a block has one
// frame, as its one product needs it); A is split per fragment. Splits round
// by integer add and mask (tf32_tile.cuh::rna), not by the conversion unit.
//   Two schedules (kernels/tconv.py::tf32_plan, C twin w2l_time_conv_tf32_plan):
// - batch: 8 warps walk CH tiles of TT = 8 MT frames of one batch row and
//   16 positions; warp w takes frames w MT .. w MT + MT - 1 of a tile and
//   loads each B fragment once for them; the next tile's new frames are
//   copied into the ring (NR = W + TT * stride slots) while this tile's
//   products run;
// - the stream's batch-1 windows, where the batch blocks would leave most
//   SMs idle: a block is one output frame of 16 positions whose KS = 2, 4
//   or 8 warps split the taps. Each warp copies its own taps' weight rows and
//   window rows, zeros their channel pads, waits for its own copies only (no
//   block barrier before its products) and splits each weight float as its
//   one product needs it; the block adds the splits in warp order, so equal
//   inputs give equal bits. Where the reduction is too short to split (C =
//   1), 4 warps take 4 frames, one each.
// Stages only the frames its outputs read. Epilogue in registers: bias, ReLU,
// fp32 pairs.
namespace tf = w2l::tf32;

struct Tf32Layout {
  int tap;   // 1: the taps are the reduction (C == 1)
  int Cp;    // channels padded to 8
  int Pe;    // floats between positions of a ring row
  int RP;    // floats a ring row
  int KR;    // weight rows: K * Cp, or the taps padded to 8
  int WP;    // floats a weight row
  int TT;    // frames a tile
  int W;     // ring rows a tile's window spans
  int NR;    // ring rows: a window and the next tile's, or (split taps) K
  int part;  // floats of the split sums
  int bytes; // dynamic shared memory
};

__host__ __device__ inline Tf32Layout tf32_layout(int C, int CO, int K, int stride, int MW,
                                                  int MT, int KS) {
  using namespace w2l::tc;
  Tf32Layout L;
  L.tap = C == 1;
  L.Cp = pad8(C);
  L.Pe = L.tap ? 1 : L.Cp + 4;
  L.RP = L.tap ? 24 : tf::FB * L.Pe;
  L.KR = L.tap ? pad8(K) : K * L.Cp;
  L.WP = odd_units(pad8(CO));  // an odd multiple of 8
  L.TT = MW * MT;
  L.W = (L.TT - 1) * stride + K;
  L.NR = KS > 1 ? K : (L.W + L.TT * stride + 1) & ~1;
  L.part = (KS - 1) * L.TT * tf::FB * pad8(CO);
  L.bytes = 4 * (2 * L.KR * L.WP + L.NR * L.RP + L.part);
  return L;
}

// Visits the weight's copies of rows [r0, r1) taken by threads tid, tid +
// nthr, ...: fn(row, first column); Gw bytes a copy, CO floats a row.
template <typename Fn>
__device__ __forceinline__ void weight_copies(int r0, int r1, int CO, int Gw, int tid, int nthr,
                                              Fn fn) {
  const int ge = Gw >> 2, U = CO / ge;
  const int dr = nthr / U, du = nthr - dr * U;
  int r = r0 + tid / U, u = tid % U;
  while (r < r1) {
    fn(r, u * ge);
    u += du;
    r += dr;
    if (u >= U) {
      u -= U;
      ++r;
    }
  }
}

// Copies weight rows [r0, r1) into `big` (row k * Cp + c, or tap k at C = 1):
// w[k, c, :] where c < C and k < K, zeros elsewhere; columns CO..WP-1 are
// never written (they meet only the output columns that are dropped).
__device__ __forceinline__ void stage_weight32(uint32_t big, const float* w,
                                               const Tf32Layout& L, const tf::FastDiv& byCp,
                                               int C, int CO, int K, int Gw, int r0, int r1,
                                               int tid, int nthr) {
  weight_copies(r0, r1, CO, Gw, tid, nthr, [&](int r, int col) {
    const int k = L.tap ? r : byCp.div(r), c = L.tap ? 0 : r - k * L.Cp;
    const bool real = L.tap ? r < K : c < C;
    const float* s = real ? w + (static_cast<size_t>(k) * C + c) * CO + col : w;
    w2l::tc::cp_async(Gw, big + 4 * (r * L.WP + col), s, real ? Gw : 0);
  });
}

// After the copies of stage_weight32(..., tid, nthr) have landed: each thread
// splits the floats it copied into big (in place) and small TF32 halves.
__device__ __forceinline__ void split_weight(float* big, float* small, const Tf32Layout& L,
                                             int CO, int Gw, int r0, int r1, int tid, int nthr) {
  weight_copies(r0, r1, CO, Gw, tid, nthr, [&](int r, int col) {
    for (int j = 0; j < (Gw >> 2); ++j) {
      const int i = r * L.WP + col + j;
      uint32_t hi, lo;
      tf::split(__float_as_uint(big[i]), hi, lo);
      big[i] = __uint_as_float(hi);
      small[i] = __uint_as_float(lo);
    }
  });
}

// Zeros channels C..Cp-1 of every position of ring rows [r0, r1): products
// read them, copies never write them.
__device__ __forceinline__ void zero_pads(float* ring, const Tf32Layout& L, int C, int r0,
                                          int r1, int tid, int nthr) {
  const int pc = L.tap ? 0 : L.Cp - C;
  if (pc == 0) return;
  for (int r = r0; r < r1; ++r)
    for (int i = tid; i < tf::FB * pc; i += nthr) {
      const int f = i / pc;
      ring[r * L.RP + f * L.Pe + C + i - f * pc] = 0.f;
    }
}

// The products of k8 steps [s0, s1) for the first nm of MT frames, frame m's
// window row 0 in ring slot base[m]: d += big . big, e += the cross terms.
// SPLIT: `big` holds the weight as it came and each B fragment is split
// here (where a fragment meets one frame, that splits each float once too).
// TAP: the taps are the reduction (C = 1), with taps past K zeros in A.
template <int NT, int MT, bool SPLIT, bool TAP>
__device__ __forceinline__ void tf32_loop(float (&d)[MT][NT][4], float (&e)[MT][NT][4],
                                          const float* ring, const float* big,
                                          const float* small, const Tf32Layout& L, int K,
                                          int s0, int s1, const int (&base)[MT], int nm, int g,
                                          int q) {
  const int nc8 = L.Cp >> 3;
  int k = TAP ? 0 : s0 / nc8;
  int cs = TAP ? 0 : s0 - k * nc8;
#pragma unroll 2
  for (int st = s0; st < s1; ++st) {
    w2l::BFragTF32 bf[NT];
    const int wr = (st * 8 + q) * L.WP + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if constexpr (SPLIT) {
        bf[n] = tf::bfrag(__float_as_uint(big[wr + n * 8]),
                          __float_as_uint(big[wr + 4 * L.WP + n * 8]));
      } else {
        bf[n].big[0] = __float_as_uint(big[wr + n * 8]);
        bf[n].big[1] = __float_as_uint(big[wr + 4 * L.WP + n * 8]);
        bf[n].small[0] = __float_as_uint(small[wr + n * 8]);
        bf[n].small[1] = __float_as_uint(small[wr + 4 * L.WP + n * 8]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= nm) break;
      uint32_t r[4];
      if constexpr (TAP) {  // rows of taps st*8 + q and + 4, positions g and g + 8
        const int k0 = st * 8 + q, k1 = k0 + 4;
        int s0r = base[m] + k0, s1r = base[m] + k1;
        if (s0r >= L.NR) s0r -= L.NR;
        if (s1r >= L.NR) s1r -= L.NR;
        r[0] = k0 < K ? __float_as_uint(ring[s0r * L.RP + g]) : 0u;
        r[1] = k0 < K ? __float_as_uint(ring[s0r * L.RP + g + 8]) : 0u;
        r[2] = k1 < K ? __float_as_uint(ring[s1r * L.RP + g]) : 0u;
        r[3] = k1 < K ? __float_as_uint(ring[s1r * L.RP + g + 8]) : 0u;
      } else {  // row of tap k, channels cs*8 + q and + 4, positions g and g + 8
        int sl = base[m] + k;
        if (sl >= L.NR) sl -= L.NR;
        const float* a = ring + sl * L.RP + g * L.Pe + cs * 8 + q;
        r[0] = __float_as_uint(a[0]);
        r[1] = __float_as_uint(a[8 * L.Pe]);
        r[2] = __float_as_uint(a[4]);
        r[3] = __float_as_uint(a[8 * L.Pe + 4]);
      }
      const tf::AFrag32 af(r);
#pragma unroll
      for (int n = 0; n < NT; ++n) af.mma(d[m][n], e[m][n], bf[n]);
    }
    if constexpr (!TAP) {
      if (++cs == nc8) {
        cs = 0;
        ++k;
      }
    }
  }
}

template <int NT, int MT, bool SPLIT = false>
__device__ __forceinline__ void tf32_steps(float (&d)[MT][NT][4], float (&e)[MT][NT][4],
                                           const float* ring, const float* big,
                                           const float* small, const Tf32Layout& L, int K,
                                           int s0, int s1, const int (&base)[MT], int nm, int g,
                                           int q) {
  if constexpr (!SPLIT) {  // split taps take C > 1 only
    if (L.tap) {
      tf32_loop<NT, MT, SPLIT, true>(d, e, ring, big, small, L, K, s0, s1, base, nm, g, q);
      return;
    }
  }
  tf32_loop<NT, MT, SPLIT, false>(d, e, ring, big, small, L, K, s0, s1, base, nm, g, q);
}

// Output frame t of the block's 16 positions from its sums: bias, ReLU, fp32.
template <int NT>
__device__ __forceinline__ void tf32_store(const float (&acc)[NT][4], float* y,
                                           const float* bias, int relu, size_t row, int fleft,
                                           int CO, int g, int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = g + 8 * h;
    if (f >= fleft) continue;
    float* yp = y + (row + f) * CO;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int co = n * 8 + 2 * q;
      if (co >= CO) continue;
      float v0 = acc[n][2 * h] + (bias != nullptr ? bias[co] : 0.f);
      if (relu) v0 = fmaxf(v0, 0.f);
      if (co + 1 < CO) {
        float v1 = acc[n][2 * h + 1] + (bias != nullptr ? bias[co + 1] : 0.f);
        if (relu) v1 = fmaxf(v1, 0.f);
        if ((CO & 1) == 0) {
          *reinterpret_cast<float2*>(yp + co) = make_float2(v0, v1);
        } else {
          yp[co] = v0;
          yp[co + 1] = v1;
        }
      } else {
        yp[co] = v0;
      }
    }
  }
}

template <int NT, int MT>
__global__ void __launch_bounds__(256, 2)
tconv_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y, int Tin, int F, int C,
                  int CO, int K, int stride, int lp, int Tout, int relu, int dil, int MW, int KS,
                  int CH, int G) {
  extern __shared__ __align__(16) float tf_smem[];
  W2L_STAMP(0);
  const Tf32Layout L = tf32_layout(C, CO, K, stride, MW, MT, KS);
  float* big = tf_smem;
  float* small = big + L.KR * L.WP;
  float* ring = small + L.KR * L.WP;
  float* part = ring + L.NR * L.RP;
  const int nthr = blockDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, f0 = blockIdx.y * tf::FB, fleft = F - f0;
  const int nT = (Tout + L.TT - 1) / L.TT;
  const int tile0 = blockIdx.x * CH;
  const int ntiles = min(CH, nT - tile0);
  if (ntiles <= 0) return;
  const int t_first = tile0 * L.TT;
  const int xbase = t_first * stride - lp;  // dilated input row of ring slot 0
  const int Tdil = (Tin - 1) * dil + 1;
  const int t_end = min(Tout, t_first + ntiles * L.TT);
  const int xend = xbase + (t_end - 1 - t_first) * stride + K;  // past the last row read
  const float* xb = x + static_cast<size_t>(b) * Tin * F * C + static_cast<size_t>(f0) * C;
  const int Gw = CO % 4 == 0 ? 16 : CO % 2 == 0 ? 8 : 4;
  const uint32_t big_s = w2l::tc::smem_addr(big), ring_s = w2l::tc::smem_addr(ring);
  const tf::Rows rows(L.Pe, L.RP, L.NR, C, G);
  const tf::FastDiv byCp(L.Cp), bydil(dil);

  if (KS > 1) {  // one frame; warp j takes taps [j K / KS, (j + 1) K / KS)
    if constexpr (MT == 1) {
      const int k0 = warp * K / KS, k1 = (warp + 1) * K / KS;
      stage_weight32(big_s, w, L, byCp, C, CO, K, Gw, k0 * L.Cp, k1 * L.Cp, lane, 32);
      tf::stage_rows(ring_s, xb, rows, F, xbase + k0, k1 - k0, xbase, Tdil, bydil, fleft, lane,
                     32);
      w2l::tc::cp_async_commit();
      zero_pads(ring, L, C, k0, k1, lane, 32);  // this warp's rows only
      W2L_STAMP(1);
      W2L_STAMP(2);
      w2l::tc::cp_async_wait<0>();
      __syncwarp();
      W2L_STAMP(3);
      W2L_STAMP(4);
      float d[1][NT][4], e[1][NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[0][n][j] = e[0][n][j] = 0.f;
      const int base[1] = {0};
      const int nc8 = L.Cp >> 3;
      tf32_steps<NT, 1, true>(d, e, ring, big, small, L, K, k0 * nc8, k1 * nc8, base, 1, g, q);
      if (warp > 0) {
        float* p = part + (warp - 1) * NT * 128 + lane;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[(n * 4 + j) * 32] = d[0][n][j] + e[0][n][j];
      }
      __syncthreads();
      if (warp == 0) {
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v = d[0][n][j] + e[0][n][j];
            for (int s = 1; s < KS; ++s) v += part[((s - 1) * NT * 4 + n * 4 + j) * 32 + lane];
            acc[n][j] = v;
          }
        tf32_store<NT>(acc, y, bias, relu, (static_cast<size_t>(b) * Tout + t_first) * F + f0,
                       fleft, CO, g, q);
      }
      W2L_STAMP(5);
    }
    return;
  }

  // batch: the weight and the first window, then tile by tile
  stage_weight32(big_s, w, L, byCp, C, CO, K, Gw, 0, L.KR, tid, nthr);
  tf::stage_rows(ring_s, xb, rows, F, xbase, min(L.W, xend - xbase), xbase, Tdil, bydil, fleft,
                 tid, nthr);
  w2l::tc::cp_async_commit();
  zero_pads(ring, L, C, 0, L.NR, tid, nthr);
  W2L_STAMP(1);
  for (int it = 0; it < ntiles; ++it) {
    const int nx = xbase + L.W + it * L.TT * stride;  // the next tile's first new row
    if (it + 1 < ntiles)
      tf::stage_rows(ring_s, xb, rows, F, nx, min(L.TT * stride, xend - nx), xbase, Tdil,
                     bydil, fleft, tid, nthr);
    w2l::tc::cp_async_commit();
    W2L_STAMP(2 + 4 * it);
    w2l::tc::cp_async_wait<1>();
    if (it == 0) split_weight(big, small, L, CO, Gw, 0, L.KR, tid, nthr);
    W2L_STAMP(3 + 4 * it);
    __syncthreads();
    W2L_STAMP(4 + 4 * it);

    const int tb = it * L.TT;  // the tile's first frame, from t_first
    int base[MT], nm = 0;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int tl = warp * MT + m;
      base[m] = ((tb + tl) * stride) % L.NR;
      if (t_first + tb + tl < Tout) nm = m + 1;
    }
    if (nm > 0) {
      float d[MT][NT][4], e[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) d[m][n][j] = e[m][n][j] = 0.f;
      tf32_steps<NT, MT>(d, e, ring, big, small, L, K, 0, L.KR >> 3, base, nm, g, q);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= nm) break;
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[n][j] = d[m][n][j] + e[m][n][j];
        const int t = t_first + tb + warp * MT + m;
        tf32_store<NT>(acc, y, bias, relu, (static_cast<size_t>(b) * Tout + t) * F + f0, fleft,
                       CO, g, q);
      }
    }
    __syncthreads();  // the slots this tile read take the next copies
    W2L_STAMP(5 + 4 * it);
  }
}

// The schedule of kernels/tconv.py::tf32_plan: (MW, MT, KS, CH, blocks).
struct Tf32Plan {
  int MW, MT, KS, CH, blocks;
};

// Blocks resident on an SM (kernels/tconv.py::tc_blocks_per_sm): two at most
// (launch bounds), fewer where their shared memory and 1 KB each do not fit.
__host__ __device__ inline int blocks_per_sm(int smem_bytes) {
  const int n = (228 * 1024) / (smem_bytes + 1024);
  return n < 1 ? 1 : n > 2 ? 2 : n;
}

// Tiles a batch block walks (kernels/tconv.py::tf32_tiles_per_block): the cut
// of each (batch row, 16 positions) pair's tiles into runs that gives the
// busiest of `slots` resident blocks the least work, waves times a block's
// tiles plus one for its weight and first window; the longer run on a tie.
__host__ __device__ inline int tiles_per_block32(int B, int Tout, int F, int slots, int tt) {
  const int pairs = B * ((F + tf::FB - 1) / tf::FB);
  const int n_t = (Tout + tt - 1) / tt;
  int best = n_t;
  long long best_load = -1;
  for (int ch = n_t; ch >= 1; --ch) {
    const long long blocks = static_cast<long long>(pairs) * ((n_t + ch - 1) / ch);
    const long long load = (blocks + slots - 1) / slots * (ch + 1);
    if (best_load < 0 || load < best_load) {
      best = ch;
      best_load = load;
    }
  }
  return best;
}

constexpr int TF32_WARPS = 8;

__host__ __device__ inline Tf32Plan tf32_plan(int B, int Tout, int F, int C, int CO, int K,
                                              int stride, int sms) {
  Tf32Plan p;
  const int nf = (F + tf::FB - 1) / tf::FB;
  p.MT = (CO + 7) / 8 <= 4 ? 2 : 1;
  const int tt = TF32_WARPS * p.MT;
  const int n_t = (Tout + tt - 1) / tt;
  if (2 * B * nf * n_t >= sms) {  // the batch blocks fill at least half the card
    p.MW = TF32_WARPS;
    p.KS = 1;
    const int smem = tf32_layout(C, CO, K, stride, p.MW, p.MT, 1).bytes;
    p.CH = tiles_per_block32(B, Tout, F, sms * blocks_per_sm(smem), tt);
    p.blocks = B * nf * ((n_t + p.CH - 1) / p.CH);
    return p;
  }
  const int steps = C == 1 ? (K + 7) / 8 : K * ((C + 7) / 8);
  p.MT = 1;
  p.CH = 1;
  p.KS = C == 1 ? 1 : steps >= 32 && K >= 8 ? 8 : steps >= 16 && K >= 4 ? 4
                                                : steps >= 8 && K >= 2 ? 2 : 1;
  p.MW = p.KS > 1 ? 1 : 4;
  p.blocks = B * nf * ((Tout + p.MW - 1) / p.MW);
  return p;
}

template <int NT, int MT>
int launch_tf32(const void* x, const void* w, const void* bias, void* y, int B, int Tin, int F,
                int C, int CO, int K, int stride, int lp, int Tout, int relu, int dil, int MW,
                int KS, int CH, int G, cudaStream_t stream) {
  const Tf32Layout L = tf32_layout(C, CO, K, stride, MW, MT, KS);
  w2l::allow_smem(tconv_tf32_kernel<NT, MT>, L.bytes);
  const int nT = (Tout + L.TT - 1) / L.TT;
  dim3 grid((nT + CH - 1) / CH, (F + tf::FB - 1) / tf::FB, B);
  tconv_tf32_kernel<NT, MT><<<grid, 32 * MW * KS, L.bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), Tin, F, C, CO, K, stride, lp,
      Tout, relu, dil, MW, KS, CH, G);
  return static_cast<int>(cudaGetLastError());
}

// launch_tf32<NT, MT> for NT = nt (1..8); two frames a warp only up to 4 n-tiles
template <int NT = 1, typename... A>
int launch_tf32_nt(int nt, int mt, A... a) {
  if constexpr (NT > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (nt == NT) {
      if (mt == 1) return launch_tf32<NT, 1>(a...);
      if constexpr (NT <= 4) {
        if (mt == 2) return launch_tf32<NT, 2>(a...);
      }
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_tf32_nt<NT + 1>(nt, mt, a...);
  }
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

// Dynamic shared memory of the fp32 tensor-core kernel for a conv of K taps
// at `stride` from C to CO channels under a schedule (MW warps along the
// frames, MT frames a warp, KS warps splitting the taps), and the schedule
// itself for a card of `sms` SMs: plan = {MW, MT, KS, CH, blocks}.
// kernels/tconv.py mirrors both.
extern "C" int w2l_time_conv_tf32_smem_bytes(int C, int CO, int K, int stride, int MW, int MT,
                                             int KS) {
  return tf32_layout(C, CO, K, stride, MW, MT, KS).bytes;
}
extern "C" int w2l_time_conv_tf32_plan(int B, int Tout, int F, int C, int CO, int K, int stride,
                                       int sms, int* plan) {
  const Tf32Plan p = tf32_plan(B, Tout, F, C, CO, K, stride, sms);
  plan[0] = p.MW;
  plan[1] = p.MT;
  plan[2] = p.KS;
  plan[3] = p.CH;
  plan[4] = p.blocks;
  return 0;
}

// The fp32 conv of w2l_time_conv on the tensor cores (3xTF32), CO <= 64:
// blocks of MW * KS warps, MT (1, or 2 up to CO = 32) frames a warp, CH
// tiles a block; KS > 1 (split taps) takes one frame a block (MW = MT = CH
// = 1) and C > 1. G, the bytes of one cp.async of x (16, 8 or 4), divides 4 C
// (at C = 1 only a row) and a row of 4 F C; x and w are 16-byte aligned.
extern "C" int w2l_time_conv_tf32(const void* x, const void* w, const void* bias, void* y,
                                  int B, int Tin, int F, int C, int CO, int K, int stride,
                                  int lp, int Tout, int relu, int dil, int MW, int MT, int KS,
                                  int CH, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool split = KS > 1;
  if (dil < 1 || CH < 1 || MW < 1 || KS < 1 || MW * KS > 8 || CO > 64 ||
      (G != 16 && G != 8 && G != 4) ||
      (split && (MW != 1 || MT != 1 || CH != 1 || C == 1 || K < KS)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tf32_nt((CO + 7) / 8, MT, x, w, bias, y, B, Tin, F, C, CO, K, stride, lp, Tout,
                        relu, dil, MW, KS, CH, G, s);
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
