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
// tensor cores, the bytes of x and dy. Four routes (kernels/tconv.py::route):
// bf16 (wgrad_tc_kernel, below) and fp32 in 3xTF32 (wgrad_tf32_kernel) on the
// tensor cores where the shape allows (tc_wgrad_takes); the wide route
// (tconv_wide.cu) for CO past 64 over at most 16 (tap, channel) pairs, CPC's
// first conv, bound by the bytes of dy; the CUDA cores (wgrad_partial_kernel)
// for the shapes none of them takes.
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
#include "mma.cuh"
#include "tc_tile.cuh"
#include "tf32_tile.cuh"

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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
// dw[k] (C x CO) = x_k^T . dy, the reduction over the positions (t, f), 16
// at a time: the 16 frequencies of one output frame. A block walks CH tiles
// of 16 frames of one batch row and 16 frequencies; the window of x is a
// ring of rows as in the forward (tc_tile.cuh), dy a ring of two tiles, both
// staged by cp.async while the previous tile's products run. Channels are
// the M dimension here, in m-tiles of 16, but a position keeps the forward's
// pitch (C padded to 8): where C is not a multiple of 16 the last m-tile's
// rows past the pitch read the next position's channels (or, past the last
// slot, the dy ring that follows), and their sums, rows c >= C, are dropped.
//   A of tap k: ring row t * stride + k, read transposed (ldmatrix.trans:
// positions are its rows, channels contiguous), 16 channels an m-tile.
//   B: dy frame t, positions x CO, read by ldmatrix.trans. One B fragment
// feeds every (tap, m-tile) unit the warp owns.
//   At C = 1 (the first conv) the taps are the M dimension: A of a unit is
// the 16 ring rows t * stride + kk (kk < 16 a unit), read as they lie
// (ldmatrix: frames are rows, positions contiguous); rows for kk >= K are
// computed and dropped.
// Accumulators: a (tap, m-tile) unit is a 16 x CO tile, NT m16n8 fragments.
// The frames are split into reps classes (t mod reps), and the (unit,
// class) items are dealt to the 8 warps round-robin, at most UMAX a warp:
// reps is the power of two up to 8 that spreads the items most evenly (9
// units: 18 items, 3 a warp at most, where one class would leave one warp 2
// units and the others 1). Each (k, c, co) of a class has one owner warp.
// Sums stay bit-reproducible: a block writes its partial (one row per class)
// once, at the end, and wgrad_reduce_kernel adds the rows in order.
namespace tc = w2l::tc;
using tc::Ring;

constexpr int UMAX = 3;  // (unit, class) items a warp at most

struct WgLayout {
  Ring xr, dr;  // the ring of x's window, the ring of dy's tiles
  int units;    // (tap, 16-channel m-tile) pairs; 16-tap groups at C = 1
  int CM;       // m-tiles of channels (1 at C = 1)
  int reps;     // classes of frames (t mod reps), each with its own partial
  int bytes;    // dynamic shared memory
};

__host__ __device__ inline WgLayout wg_layout(int C, int CO, int K, int stride) {
  using namespace w2l::tc;
  WgLayout L;
  L.xr = make_ring(C, odd_units(pad8(C)), stride, K - 1);
  L.dr = make_ring(CO, odd_units(pad8(CO)), 1, 0);
  L.CM = C == 1 ? 1 : pad16(C) / 16;
  L.units = C == 1 ? (K + 15) / 16 : K * L.CM;
  // the classes that spread units * reps items most evenly over the warps
  L.reps = 1;
  int best_items = 0, best_per = 1;
  for (int r = 1; r <= WARPS; r *= 2) {
    const int items = L.units * r, per = (items + WARPS - 1) / WARPS;
    if (per > UMAX) break;
    if (items * best_per > best_items * per) {
      L.reps = r;
      best_items = items;
      best_per = per;
    }
  }
  L.bytes = 2 * L.xr.NR * L.xr.RP + 2 * L.dr.NR * L.dr.RP +
            4 * (table_entries(C) + table_entries(CO));
  return L;
}

template <int NT>
__global__ void __launch_bounds__(w2l::tc::THREADS, 2)
wgrad_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                float* __restrict__ partial, int Tin, int F, int C, int CO, int K, int stride,
                int lp, int Tout, int CH, int G, int Gd) {
  using namespace w2l::tc;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const WgLayout L = wg_layout(C, CO, K, stride);
  const Ring& xr = L.xr;
  const Ring& dr = L.dr;
  __nv_bfloat16* xring = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* dring = xring + xr.NR * xr.RP;
  int* xtable = reinterpret_cast<int*>(dring + dr.NR * dr.RP);
  int* dtable = xtable + table_entries(C);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, f0 = blockIdx.y * FB;
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int nT = (Tout + tc::TT - 1) / tc::TT;
  const int tile0 = blockIdx.x * CH;
  const int ntiles = max(0, min(CH, nT - tile0));

  uint4* rz = reinterpret_cast<uint4*>(tc_smem);
  for (int i = tid; i < (xr.NR * xr.RP + dr.NR * dr.RP) / 8; i += tc::THREADS)
    rz[i] = make_uint4(0, 0, 0, 0);
  fill_table(xtable, C, xr.Pe, G, tid);
  fill_table(dtable, CO, dr.Pe, Gd, tid);
  __syncthreads();

  // this warp's items: item i = warp + 8 j is unit i mod units on the frames
  // of class i / units
  int unit[UMAX], rep[UMAX], nmine = 0, classes = 0;
#pragma unroll
  for (int j = 0; j < UMAX; ++j) {
    const int i = warp + WARPS * j;
    unit[j] = i % L.units;
    rep[j] = i / L.units;
    if (i < L.units * L.reps) {
      nmine = j + 1;
      classes |= 1 << rep[j];
    }
  }

  const int t_first = tile0 * tc::TT;
  const int xbase = t_first * stride - lp;
  const int fleft = F - f0;
  const __nv_bfloat16* xb =
      x + static_cast<size_t>(b) * Tin * F * C + static_cast<size_t>(f0) * C;
  const __nv_bfloat16* dyb =
      dy + static_cast<size_t>(b) * Tout * F * CO + static_cast<size_t>(f0) * CO;
  const uint32_t xs = smem_addr(xring), ds = smem_addr(dring);
  if (ntiles > 0) {
    stage_rows(xs, xb, xtable, xr, xbase, xr.W, xbase, Tin, 1, F, C, fleft, G, tid);
    stage_rows(ds, dyb, dtable, dr, t_first, tc::TT, t_first, Tout, 1, F, CO, fleft, Gd, tid);
  }
  cp_async_commit();

  const int mat = lane >> 3, li = lane & 7;
  const int g = lane >> 2, q = lane & 3;
  const int b_off = 2 * (((mat & 1) * 8 + li) * dr.Pe + (mat >> 1) * 8);
  // A: channels mode, rows are positions (mat >> 1), channels (mat & 1);
  // taps mode, rows are frames (mat & 1), positions (mat >> 1)
  const int a_off = 2 * (((mat >> 1) * 8 + li) * xr.Pe + (mat & 1) * 8);
  const int tap_kk = (mat & 1) * 8 + li, tap_pos = (mat >> 1) * 8;
  // per item: the A rows' offset from a frame's first window row (its tap k,
  // or at C = 1 its taps and this lane's), and the byte offset in a row
  int row_off[UMAX], col_off[UMAX];
#pragma unroll
  for (int j = 0; j < UMAX; ++j) {
    if (xr.tap) {
      row_off[j] = unit[j] * 16 + tap_kk;
      col_off[j] = 2 * tap_pos;
    } else {
      row_off[j] = unit[j] / L.CM;
      col_off[j] = 2 * (unit[j] - row_off[j] * L.CM) * 16 + a_off;
    }
  }

  float acc[UMAX][NT][4];
#pragma unroll
  for (int j = 0; j < UMAX; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage_rows(xs, xb, xtable, xr, xbase + xr.W + it * tc::TT * stride, tc::TT * stride,
                 xbase, Tin, 1, F, C, fleft, G, tid);
      stage_rows(ds, dyb, dtable, dr, t_first + (it + 1) * tc::TT, tc::TT, t_first, Tout, 1,
                 F, CO, fleft, Gd, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int tb = it * tc::TT;
    const int d0 = tb % dr.NR;  // dy slot of the tile's first frame (NR = 32)
    int x0 = (tb * stride) % xr.NR;  // ring slot of frame tl's first window row
    for (int tl = 0; nmine > 0 && tl < tc::TT && t_first + tb + tl < Tout; ++tl) {
      const int cls = tl & (L.reps - 1);
      if ((classes >> cls) & 1) {
        uint32_t bf[NT][2];
        load_b16<NT>(bf, ds + 2 * (d0 + tl) * dr.RP, b_off);
#pragma unroll
        for (int j = 0; j < UMAX; ++j) {
          if (j >= nmine) break;
          if (rep[j] != cls) continue;
          int slot = x0 + row_off[j];  // < 2 NR: one wrap at most
          if (slot >= xr.NR) slot -= xr.NR;
          uint32_t a[4];
          if (xr.tap)
            ldsm_x4(a, xs + 2 * slot * xr.RP + col_off[j]);
          else
            ldsm_x4_trans(a, xs + 2 * slot * xr.RP + col_off[j]);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_k16(acc[j][n], a, bf[n][0], bf[n][1]);
        }
      }
      x0 += stride;
      if (x0 >= xr.NR) x0 -= xr.NR;
    }
    __syncthreads();  // the ring slots this tile read are free for the next copies
  }

  // the block's partial: row blk * reps + class, each (k, c, co) from its owner
#pragma unroll
  for (int j = 0; j < UMAX; ++j) {
    if (j >= nmine) break;
    float* out = partial + static_cast<size_t>(blk * L.reps + rep[j]) * K * C * CO;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int k, c;
      if (xr.tap) {
        k = unit[j] * 16 + g + 8 * h;
        c = 0;
        if (k >= K) continue;
      } else {
        k = unit[j] / L.CM;
        c = (unit[j] - k * L.CM) * 16 + g + 8 * h;
        if (c >= C) continue;
      }
      float* op = out + (static_cast<size_t>(k) * C + c) * CO;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int co = n * 8 + 2 * q;
        if (co < CO) op[co] = acc[j][n][2 * h];
        if (co + 1 < CO) op[co + 1] = acc[j][n][2 * h + 1];
      }
    }
  }
}

template <int NT>
int launch_tc(const void* x, const void* dy, void* partial, void* dw, int B, int Tin, int F,
              int C, int CO, int K, int stride, int lp, int Tout, int CH, int G, int Gd,
              cudaStream_t stream) {
  const WgLayout L = wg_layout(C, CO, K, stride);
  w2l::allow_smem(wgrad_tc_kernel<NT>, L.bytes);
  const int nT = (Tout + w2l::tc::TT - 1) / w2l::tc::TT;
  dim3 grid((nT + CH - 1) / CH, (F + w2l::tc::FB - 1) / w2l::tc::FB, B);
  wgrad_tc_kernel<NT><<<grid, w2l::tc::THREADS, L.bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
      static_cast<float*>(partial), Tin, F, C, CO, K, stride, lp, Tout, CH, G, Gd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wsize = K * C * CO;
  const int rows = static_cast<int>(grid.x * grid.y * grid.z) * L.reps;
  wgrad_reduce_kernel<<<(wsize + tc::THREADS - 1) / tc::THREADS, tc::THREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), rows, wsize);
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

// ---------------------------------------------------------------------------
// fp32 on the tensor cores (3xTF32)
// ---------------------------------------------------------------------------
// dw[k] (C x CO) = x_k^T . dy as the bf16 route above, the reduction over the
// positions (t, f) 8 a k8 step: channels are M in m-tiles of 16 (taps at C =
// 1), CO is N; each product is three m16n8k8 TF32 mma.sync (3xTF32) summed
// in fp32. A block walks CH tiles of TT = 8 frames of one batch row and 16
// positions; x's window is a ring of fp32 rows, dy a ring of two tiles, both
// copied by cp.async while the previous tile's products run. Fragments come
// by 32-bit shared loads, each of the 32 lanes on its own bank: x's
// positions sit Pe floats apart (pad16(C) raised to an odd multiple of 8;
// taps rows 20 floats), dy's PeD (pad8(CO) raised likewise). Both operands
// are split into big and small TF32 halves: dy's fragment once for all the
// units a warp owns at that frame, x's per fragment. The tensor cores add a
// product's terms without rounding to nearest, which over the long sums of
// dw drifts (measured: 5e-3 against 2e-3 allowed on 224,000 terms), so each
// frame's 16 positions go into a fresh tile and the running sum takes it by
// an fp32 add. Rows of A past C (or
// past K at C = 1) and columns of B past CO hold whatever the ring holds
// there; they meet only sums that are dropped. Units and classes of frames
// are dealt to the 8 warps as in the bf16 route, and the partials are summed
// in order by wgrad_reduce_kernel: equal inputs, equal bits.
namespace tf = w2l::tf32;

constexpr int WG32_TT = 8;  // frames a tile

struct Wg32Layout {
  int tap;   // 1: C == 1, taps are the M dimension
  int Pe;    // floats between positions of an x row
  int RP;    // floats an x row
  int W;     // x rows a tile's window spans
  int NR;    // x rows: a window and the next tile's
  int PeD;   // floats between positions of a dy row
  int RPd;   // floats a dy row
  int bytes; // dynamic shared memory
};

__host__ __device__ inline Wg32Layout wg32_layout(int C, int CO, int K, int stride) {
  using namespace w2l::tc;
  Wg32Layout L;
  L.tap = C == 1;
  L.Pe = L.tap ? 1 : odd_units(pad16(C));
  L.RP = L.tap ? 20 : tf::FB * L.Pe;
  L.W = (WG32_TT - 1) * stride + K;
  L.NR = (L.W + WG32_TT * stride + 1) & ~1;
  L.PeD = odd_units(pad8(CO));
  L.RPd = tf::FB * L.PeD;
  L.bytes = 4 * (L.NR * L.RP + 2 * WG32_TT * L.RPd);
  return L;
}

template <int NT>
__global__ void __launch_bounds__(256, 2)
wgrad_tf32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ partial, int Tin, int F, int C, int CO, int K, int stride,
                  int lp, int Tout, int CH, int G, int Gd) {
  extern __shared__ __align__(16) float wf_smem[];
  W2L_STAMP(0);
  const Wg32Layout L = wg32_layout(C, CO, K, stride);
  const WgLayout U = wg_layout(C, CO, K, stride);  // units and classes, as bf16
  float* xring = wf_smem;
  float* dring = xring + L.NR * L.RP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, f0 = blockIdx.y * tf::FB, fleft = F - f0;
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int nT = (Tout + WG32_TT - 1) / WG32_TT;
  const int tile0 = blockIdx.x * CH;
  const int ntiles = max(0, min(CH, nT - tile0));

  // this warp's items: item i = warp + 8 j is unit i mod units on the frames
  // of class i / units
  int unit[UMAX], rep[UMAX], nmine = 0, classes = 0;
#pragma unroll
  for (int j = 0; j < UMAX; ++j) {
    const int i = warp + tc::WARPS * j;
    unit[j] = i % U.units;
    rep[j] = i / U.units;
    if (i < U.units * U.reps) {
      nmine = j + 1;
      classes |= 1 << rep[j];
    }
  }

  const int t_first = tile0 * WG32_TT;
  const int xbase = t_first * stride - lp;
  const int t_end = min(Tout, t_first + ntiles * WG32_TT);
  const int xend = xbase + (t_end - 1 - t_first) * stride + K;  // past the last row read
  const float* xb = x + static_cast<size_t>(b) * Tin * F * C + static_cast<size_t>(f0) * C;
  const float* dyb = dy + static_cast<size_t>(b) * Tout * F * CO + static_cast<size_t>(f0) * CO;
  const uint32_t xs = tc::smem_addr(xring), ds = tc::smem_addr(dring);
  const tf::Rows xrows(L.Pe, L.RP, L.NR, C, G), drows(L.PeD, L.RPd, 2 * WG32_TT, CO, Gd);
  const tf::FastDiv one(1);
  if (ntiles > 0) {
    tf::stage_rows(xs, xb, xrows, F, xbase, min(L.W, xend - xbase), xbase, Tin, one, fleft, tid,
                   tc::THREADS);
    tf::stage_rows(ds, dyb, drows, F, t_first, min(WG32_TT, t_end - t_first), t_first, Tout, one,
                   fleft, tid, tc::THREADS);
  }
  tc::cp_async_commit();
  W2L_STAMP(1);

  // per item: the A rows' offset from a frame's first window row (its tap k,
  // or at C = 1 its 16 taps from this lane's g) and the floats into a row
  int row_off[UMAX], col_off[UMAX];
#pragma unroll
  for (int j = 0; j < UMAX; ++j) {
    if (L.tap) {
      row_off[j] = unit[j] * 16 + g;
      col_off[j] = q;
    } else {
      row_off[j] = unit[j] / U.CM;
      col_off[j] = q * L.Pe + (unit[j] - row_off[j] * U.CM) * 16 + g;
    }
  }

  float acc[UMAX][NT][4];
#pragma unroll
  for (int j = 0; j < UMAX; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int nx = xbase + L.W + it * WG32_TT * stride;  // the next tile's first new x row
    const int nt = t_first + (it + 1) * WG32_TT;         // and dy row
    if (it + 1 < ntiles) {
      tf::stage_rows(xs, xb, xrows, F, nx, min(WG32_TT * stride, xend - nx), xbase, Tin, one,
                     fleft, tid, tc::THREADS);
      tf::stage_rows(ds, dyb, drows, F, nt, min(WG32_TT, t_end - nt), t_first, Tout, one, fleft,
                     tid, tc::THREADS);
    }
    tc::cp_async_commit();
    W2L_STAMP(2 + 4 * it);
    tc::cp_async_wait<1>();
    W2L_STAMP(3 + 4 * it);
    __syncthreads();
    W2L_STAMP(4 + 4 * it);

    const int tb = it * WG32_TT;
    const float* drow = dring + (tb % (2 * WG32_TT)) * L.RPd;  // dy row of the tile's first frame
    int x0 = (tb * stride) % L.NR;  // ring slot of frame tl's first window row
    for (int tl = 0; nmine > 0 && tl < WG32_TT && t_first + tb + tl < Tout; ++tl) {
      const int cls = tl & (U.reps - 1);
      if ((classes >> cls) & 1) {
        // dy's fragments of positions 0-7 and 8-15, split once for all units
        w2l::BFragTF32 bf[2][NT];
#pragma unroll
        for (int ps = 0; ps < 2; ++ps) {
          const float* dp = drow + tl * L.RPd + (8 * ps + q) * L.PeD + g;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            bf[ps][n] =
                tf::bfrag(__float_as_uint(dp[n * 8]), __float_as_uint(dp[4 * L.PeD + n * 8]));
        }
#pragma unroll
        for (int j = 0; j < UMAX; ++j) {
          if (j >= nmine) break;
          if (rep[j] != cls) continue;
          // the frame's 16 positions in a fresh tile: the tensor cores' sums
          // (which do not round to nearest) stay 6 products deep, and the
          // running sum takes them by a rounded add
          float fr[NT][4];
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) fr[n][e] = 0.f;
#pragma unroll
          for (int ps = 0; ps < 2; ++ps) {  // positions 8 ps .. 8 ps + 7
            uint32_t r[4];
            if (L.tap) {  // rows: taps 16 u + g (+ 8); columns: positions
              int s0 = x0 + row_off[j], s1 = s0 + 8;
              if (s0 >= L.NR) s0 -= L.NR;
              if (s1 >= L.NR) s1 -= L.NR;
              const float* a0 = xring + s0 * L.RP + 8 * ps + col_off[j];
              const float* a1 = xring + s1 * L.RP + 8 * ps + col_off[j];
              r[0] = __float_as_uint(a0[0]);
              r[1] = __float_as_uint(a1[0]);
              r[2] = __float_as_uint(a0[4]);
              r[3] = __float_as_uint(a1[4]);
            } else {  // rows: channels of the m-tile; columns: positions
              int sl = x0 + row_off[j];
              if (sl >= L.NR) sl -= L.NR;
              const float* a = xring + sl * L.RP + 8 * ps * L.Pe + col_off[j];
              r[0] = __float_as_uint(a[0]);
              r[1] = __float_as_uint(a[8]);
              r[2] = __float_as_uint(a[4 * L.Pe]);
              r[3] = __float_as_uint(a[4 * L.Pe + 8]);
            }
            const tf::AFrag32 af(r);
#pragma unroll
            for (int n = 0; n < NT; ++n) af.mma(fr[n], fr[n], bf[ps][n]);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][n][e] += fr[n][e];
        }
      }
      x0 += stride;
      if (x0 >= L.NR) x0 -= L.NR;
    }
    __syncthreads();  // the slots this tile read take the next copies
    W2L_STAMP(5 + 4 * it);
  }

  // the block's partial: row blk * reps + class, each (k, c, co) from its owner
#pragma unroll
  for (int j = 0; j < UMAX; ++j) {
    if (j >= nmine) break;
    float* out = partial + static_cast<size_t>(blk * U.reps + rep[j]) * K * C * CO;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int k, c;
      if (L.tap) {
        k = unit[j] * 16 + g + 8 * h;
        c = 0;
        if (k >= K) continue;
      } else {
        k = unit[j] / U.CM;
        c = (unit[j] - k * U.CM) * 16 + g + 8 * h;
        if (c >= C) continue;
      }
      float* op = out + (static_cast<size_t>(k) * C + c) * CO;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int co = n * 8 + 2 * q;
        if (co < CO) op[co] = acc[j][n][2 * h];
        if (co + 1 < CO) op[co + 1] = acc[j][n][2 * h + 1];
      }
    }
  }
}

template <int NT>
int launch_tf32(const void* x, const void* dy, void* partial, void* dw, int B, int Tin, int F,
                int C, int CO, int K, int stride, int lp, int Tout, int CH, int G, int Gd,
                cudaStream_t stream) {
  const Wg32Layout L = wg32_layout(C, CO, K, stride);
  w2l::allow_smem(wgrad_tf32_kernel<NT>, L.bytes);
  const int nT = (Tout + WG32_TT - 1) / WG32_TT;
  dim3 grid((nT + CH - 1) / CH, (F + tf::FB - 1) / tf::FB, B);
  wgrad_tf32_kernel<NT><<<grid, tc::THREADS, L.bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(partial),
      Tin, F, C, CO, K, stride, lp, Tout, CH, G, Gd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wsize = K * C * CO;
  const int rows = static_cast<int>(grid.x * grid.y * grid.z) * wg_layout(C, CO, K, stride).reps;
  wgrad_reduce_kernel<<<(wsize + tc::THREADS - 1) / tc::THREADS, tc::THREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), rows, wsize);
  return static_cast<int>(cudaGetLastError());
}

// launch_tf32<NT> for NT = nt (1..8)
template <int NT = 1, typename... A>
int launch_tf32_nt(int nt, A... a) {
  if constexpr (NT > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (nt == NT) return launch_tf32<NT>(a...);
    return launch_tf32_nt<NT + 1>(nt, a...);
  }
}

}  // namespace

extern "C" int w2l_time_conv_wgrad_tile() { return TT; }

// Dynamic shared memory of the bf16 tensor-core K2b, and the partial rows
// one of its blocks writes (classes of frames); kernels/tconv.py mirrors both.
extern "C" int w2l_time_conv_wgrad_tc_smem_bytes(int C, int CO, int K, int stride) {
  return wg_layout(C, CO, K, stride).bytes;
}
extern "C" int w2l_time_conv_wgrad_tc_reps(int C, int K) {
  return wg_layout(C, 2, K, 1).reps;
}

// The bf16 K2b on the tensor cores: CO even and at most 64; C even, or C = 1;
// at most 8 * UMAX (tap, 16-channel) units. G and Gd, the bytes of one
// cp.async of x and of dy, divide a position's channels (x's 16 positions at
// C = 1) and a row; a block walks CH tiles of 16 frames. partial holds
// (blocks * reps, K*C*CO) float32.
extern "C" int w2l_time_conv_wgrad_tc(const void* x, const void* dy, void* partial, void* dw,
                                      int B, int Tin, int F, int C, int CO, int K, int stride,
                                      int lp, int Tout, int CH, int G, int Gd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WgLayout L = wg_layout(C, CO, K, stride);
  if (CH < 1 || (CO & 1) || L.units > w2l::tc::WARPS * UMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_nt((CO + 7) / 8, x, dy, partial, dw, B, Tin, F, C, CO, K, stride, lp, Tout,
                   CH, G, Gd, s);
}

// Dynamic shared memory of the fp32 tensor-core K2b; kernels/tconv.py mirrors it.
extern "C" int w2l_time_conv_wgrad_tf32_smem_bytes(int C, int CO, int K, int stride) {
  return wg32_layout(C, CO, K, stride).bytes;
}

// The fp32 K2b on the tensor cores (3xTF32): CO at most 64, at most 8 * UMAX
// (tap, 16-channel) units. G and Gd, the bytes of one cp.async of x and of
// dy, divide 4 C (x at C = 1: only a row) and 4 CO and a row of each; a
// block walks CH tiles of 8 frames. partial holds (blocks * reps, K*C*CO)
// float32.
extern "C" int w2l_time_conv_wgrad_tf32(const void* x, const void* dy, void* partial, void* dw,
                                        int B, int Tin, int F, int C, int CO, int K, int stride,
                                        int lp, int Tout, int CH, int G, int Gd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (CH < 1 || CO > 64 || wg_layout(C, CO, K, stride).units > w2l::tc::WARPS * UMAX ||
      (G != 16 && G != 8 && G != 4) || (Gd != 16 && Gd != 8 && Gd != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tf32_nt((CO + 7) / 8, x, dy, partial, dw, B, Tin, F, C, CO, K, stride, lp, Tout,
                        CH, G, Gd, s);
}

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

namespace w2l {
// Pass 2 of every K2b route: dw = the blocks' partial rows added in block
// order (tconv_wide.cu launches it after its own pass 1).
int launch_wgrad_reduce(const float* partial, float* dw, int nb, int wsize,
                        cudaStream_t stream) {
  wgrad_reduce_kernel<<<(wsize + THREADS - 1) / THREADS, THREADS, 0, stream>>>(partial, dw, nb,
                                                                              wsize);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace w2l
