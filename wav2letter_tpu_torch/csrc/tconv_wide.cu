// K2 (tconv_wide_kernel) and K2b (wgrad_wide_kernel) on the "wide" route:
// the convs the tensor-core routes refuse only for their width, CO > 64
// output channels over at most MAX_TAPS (tap, input channel) pairs. For these
// shapes they replace the TPU kernels wav2letter_tpu/ops/pallas/tconv.py::
// time_conv (_fwd) and _wgrad, as tconv.cu and tconv_wgrad.cu do for the
// others (kernels/tconv.py::route). CPC's first conv on raw audio (C = 1 ->
// 512, K = 10, stride 5) is the one a recipe runs.
//
// Bound on the H100: 2 K C = 20 FLOP an output against 4 bytes written
// (fp32), so both kernels are bound by the bytes of y (K2) or dy (K2b) at
// the card's 3.35 TB/s; the products run on the CUDA cores in fp32. Design:
// - persistent blocks (one or two an SM) walk a contiguous run of tiles of
//   TT frames; a tile's rows (frame, position) are contiguous in y and dy,
//   and its window of x is a contiguous span of x;
// - a thread owns V = 4 consecutive output channels of rows rg, rg + RG,
//   ... of every tile (RG row groups of CO / V threads), so a warp reads or
//   writes 32 x 16 bytes of one row (8 bytes a lane in bf16);
// - spans of x and dy are copied by cp.async.bulk (1-D TMA) issued by one
//   thread and completed on mbarriers; a span's 16-byte-aligned bytes go in
//   one copy, the < 16 bytes past the array's last 16-byte boundary by plain
//   loads. A tile whose window reaches the time pads reads its taps through
//   a predicate (the pads are never copied).
// K2 keeps its V x KC weights in registers and double-buffers the window: the
// next tile's copy is in flight while this tile's products and stores run.
// (Sending each tile out by one bulk store from shared memory instead was 5%
// slower at CPC's conv on the H100: PERF.md.)
// K2b keeps its KC x V sums in registers for the whole run; a producer warp
// streams dy and x through a ring of WG_STAGES stages guarded by full and
// empty mbarriers; the row groups' sums are added in order at the end, so
// equal inputs give equal bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// A clock64 stamp of thread 0 (kernels/trace_k2.py defines it); nothing here.
#ifndef W2L_STAMP
#define W2L_STAMP(i)
#endif

namespace w2l {
namespace wide {

constexpr int THREADS = 256;   // K2's block; K2b's consumer threads
constexpr int V = 4;           // output channels a thread
constexpr int MAX_TAPS = 16;   // K * C
constexpr int MAX_CO = THREADS * V;
constexpr int FWD_ROWS = 16;   // rows a thread a K2 tile
constexpr int WG_STAGES = 4;
constexpr int WG_STAGE_BYTES = 16384;  // dy a K2b stage, at most
constexpr int WG_MAX_TT = 64;
constexpr int WG_THREADS = THREADS + 32;  // K2b: the consumers and one producer warp
constexpr int SLOT = 32;       // bytes a staged span takes past its elements
constexpr int HEAD = 128;      // the mbarriers, before the buffers

__host__ __device__ inline int pad16(long long n) { return static_cast<int>((n + 15) & ~15LL); }
// RG, the row groups: threads a row are CO / V
__host__ __device__ inline int groups(int CO) {
  return THREADS / (CO / V) > 1 ? THREADS / (CO / V) : 1;
}
__host__ __device__ inline int span_bytes(long long elems, int item) {
  return pad16(elems * item) + SLOT;
}

struct FwdLayout {
  int TT;     // frames a tile
  int W;      // window rows of a tile
  int buf;    // bytes a window buffer (two)
  int bytes;  // dynamic shared memory
};

__host__ __device__ inline FwdLayout fwd_layout(int F, int C, int CO, int K, int stride,
                                                int item) {
  FwdLayout L;
  const int tt = FWD_ROWS * groups(CO) / F;
  L.TT = tt > 1 ? tt : 1;
  L.W = (L.TT - 1) * stride + K;
  L.buf = span_bytes(static_cast<long long>(L.W) * F * C, item);
  L.bytes = HEAD + 2 * L.buf;
  return L;
}

struct WgLayout {
  int TT;     // frames a stage
  int W;      // window rows of a stage
  int dbuf;   // bytes of dy a stage
  int stage;  // bytes a stage: dy, then x's window
  int bytes;  // dynamic shared memory: the ring, or the row groups' sums
};

__host__ __device__ inline WgLayout wg_layout(int F, int C, int CO, int K, int stride,
                                              int item) {
  WgLayout L;
  const int tt = WG_STAGE_BYTES / (F * CO * item);
  L.TT = tt < 1 ? 1 : (tt > WG_MAX_TT ? WG_MAX_TT : tt);
  L.W = (L.TT - 1) * stride + K;
  L.dbuf = span_bytes(static_cast<long long>(L.TT) * F * CO, item);
  L.stage = L.dbuf + span_bytes(static_cast<long long>(L.W) * F * C, item);
  const int ring = WG_STAGES * L.stage;
  const int sums = groups(CO) * K * C * CO * 4;
  L.bytes = HEAD + (ring > sums ? ring : sums);
  return L;
}

// Blocks resident on an SM: two at most, fewer where the shared memory (and
// the 1 KB the card reserves for each) does not fit 228 KB.
__host__ __device__ inline int blocks_per_sm(int bytes) {
  const int n = (228 * 1024) / (bytes + 1024);
  return n < 1 ? 1 : (n > 2 ? 2 : n);
}

// Whether the route takes the conv (wgrad: K2b, else K2) at `item` bytes an
// element; kernels/tconv.py::wide_takes mirrors it.
__host__ __device__ inline bool takes(int F, int C, int CO, int K, int stride, int item,
                                      int wgrad) {
  if (F < 1 || C < 1 || K < 1 || stride < 1 || CO <= 64 || CO % V || CO > MAX_CO ||
      K * C > MAX_TAPS)
    return false;
  const int bytes = wgrad ? wg_layout(F, C, CO, K, stride, item).bytes
                          : fwd_layout(F, C, CO, K, stride, item).bytes;
  return bytes <= 232448;
}

struct Plan {
  int CH;      // tiles a block walks
  int blocks;
};

// `tiles` cut into contiguous runs, one a block, as many blocks as are
// resident at once (blocks_per_sm a block of `bytes` on each of `sms`).
__host__ __device__ inline Plan plan(long long tiles, int bytes, int sms) {
  Plan p;
  const long long slots = static_cast<long long>(sms) * blocks_per_sm(bytes);
  const long long nb = tiles < slots ? tiles : slots;
  p.CH = static_cast<int>((tiles + nb - 1) / nb);
  p.blocks = static_cast<int>((tiles + p.CH - 1) / p.CH);
  return p;
}

// the mbarriers and the bulk copy (common.cuh)
using w2l::bulk_load;
using w2l::mbar_arrive;
using w2l::mbar_arrive_tx;
using w2l::mbar_fence_init;
using w2l::mbar_init;
using w2l::mbar_wait;
using w2l::saddr;

__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

struct Span {
  long long a0;    // first byte of the bulk copy
  uint32_t bytes;  // bytes of the bulk copy
};

// Bytes [lo, hi) of an array of `total` bytes (16-byte aligned) go to
// dst + (g - base16) for byte g, base16 16-byte aligned and <= lo: the bytes
// past the array's last 16-byte boundary by plain loads now; the rest is
// returned for one bulk copy, issued after the barrier expects its bytes.
__device__ __forceinline__ Span tail_span(unsigned char* dst, const unsigned char* src,
                                          long long lo, long long hi, long long base16,
                                          long long total) {
  Span s{0, 0};
  if (hi <= lo) return s;
  s.a0 = lo & ~15LL;
  long long a1 = (hi + 15) & ~15LL;
  if (a1 > (total & ~15LL)) a1 = total & ~15LL;
  if (a1 < s.a0) a1 = s.a0;
  s.bytes = static_cast<uint32_t>(a1 - s.a0);
  for (long long g = a1 > lo ? a1 : lo; g < hi; ++g) dst[g - base16] = src[g];
  return s;
}
__device__ __forceinline__ void issue_span(uint64_t* bar, unsigned char* dst,
                                           const unsigned char* src, const Span& s,
                                           long long base16) {
  if (s.bytes) bulk_load(dst + (s.a0 - base16), src + s.a0, s.bytes, bar);
}

// The window of x a tile of frames reads: W rows from row0 of batch row b,
// F*C elements a row; the rows outside [0, Tin) are the time pads.
struct Window {
  long long g0;      // element of x at window element 0 (may lie before the row)
  long long lo, hi;  // the bytes of x inside the batch row
  long long base16;  // g0's byte, rounded down to 16
  int lead;          // bytes from the buffer's start to window element 0
};

__device__ __forceinline__ Window window(int b, int row0, int W, int FC, int Tin, int item) {
  Window w;
  w.g0 = (static_cast<long long>(b) * Tin + row0) * FC;
  const long long gb = static_cast<long long>(b) * Tin * FC;
  const long long ge = gb + static_cast<long long>(Tin) * FC;
  const long long g1 = w.g0 + static_cast<long long>(W) * FC;
  w.lo = (w.g0 > gb ? w.g0 : gb) * item;
  w.hi = (g1 < ge ? g1 : ge) * item;
  w.base16 = (w.g0 * item) & ~15LL;
  w.lead = static_cast<int>(w.g0 * item - w.base16);
  return w;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&a);
  q.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// Element offsets of a thread's taps in a window, tap kc = (k, c) at
// k * FC + c; taps past KC at 0 (never read).
template <int KCM>
__device__ __forceinline__ void tap_offsets(int (&toff)[KCM], int KC, int C, int FC) {
#pragma unroll
  for (int kc = 0; kc < KCM; ++kc) {
    const int k = kc / C;
    toff[kc] = kc < KC ? k * FC + (kc - k * C) : 0;
  }
}

// Whether tap kc (< KCM, KCM = KC rounded up to 4) exists: only the last
// four can be past KC.
template <int KCM>
__device__ __forceinline__ bool tap_on(int kc, int KC) {
  return kc < KCM - 4 || kc < KC;
}

// The x value of tap kc of a row whose window row 0 is input frame
// `first`; EDGE: zero where the frame is a time pad.
template <bool EDGE, typename T>
__device__ __forceinline__ float tap_x(const T* xr, int off, int first, int kc, int C,
                                       int Tin) {
  if (EDGE) {
    const int tin = first + kc / C;
    return tin >= 0 && tin < Tin ? to_f(xr[off]) : 0.f;
  }
  return to_f(xr[off]);
}

}  // namespace wide

// tconv_wgrad.cu: K2b's ordered sum of the blocks' partial rows
int launch_wgrad_reduce(const float* partial, float* dw, int nb, int wsize, cudaStream_t stream);
}  // namespace w2l

namespace {

namespace wd = w2l::wide;

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------
// A block of 256 threads walks CH consecutive tiles of TT frames (the
// tiles of all batch rows in order). Thread (cv, rg) holds the weights and
// bias of channels 4 cv .. 4 cv + 3 in registers and computes rows rg, rg +
// RG, ... (row = frame t, position f) of each tile: KC window values, each a
// broadcast read, times 4 weights, then one 16-byte (bf16: 8-byte) store, so
// a warp writes 512 contiguous bytes of a row. Thread 0 copies the next
// tile's window (cp.async.bulk on an mbarrier) into the other buffer while
// the block computes this one.
// Rows rg, rg + RG, ... of a tile of nt frames: y rows of CO at yt.
template <bool EDGE, typename T, int KCM>
__device__ __forceinline__ void wide_rows(const T* xs, T* yt, const float (&wr)[KCM][4],
                                          const int (&toff)[KCM], const float (&b4)[4],
                                          int nt, int F, int C, int CO, int KC, int stride,
                                          int cv, int rg, int RG, int row0, int Tin,
                                          int relu) {
  const int FC = F * C;
  for (int t = rg; t < nt; t += RG) {
    for (int f = 0; f < F; ++f) {
      const T* xr = xs + t * stride * FC + f * C;
      float a[4] = {b4[0], b4[1], b4[2], b4[3]};
#pragma unroll
      for (int kc = 0; kc < KCM; ++kc) {
        if (wd::tap_on<KCM>(kc, KC)) {
          const float xv = wd::tap_x<EDGE>(xr, toff[kc], row0 + t * stride, kc, C, Tin);
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = fmaf(xv, wr[kc][j], a[j]);
        }
      }
      if (relu) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = fmaxf(a[j], 0.f);
      }
      wd::store4(yt + static_cast<size_t>(t * F + f) * CO + cv * wd::V, a);
    }
  }
}

// One thread: the window of tile `tile` into buffer `buf`, on `bar`.
template <typename T>
__device__ __forceinline__ void wide_stage(uint64_t* bar, unsigned char* buf, const T* x,
                                           int tile, int nT, int TT, int W, int FC, int Tin,
                                           int stride, int lp, long long total) {
  const int b = tile / nT;
  const int row0 = (tile - b * nT) * TT * stride - lp;
  const wd::Window win = wd::window(b, row0, W, FC, Tin, sizeof(T));
  const unsigned char* src = reinterpret_cast<const unsigned char*>(x);
  const wd::Span s = wd::tail_span(buf, src, win.lo, win.hi, win.base16, total);
  wd::mbar_arrive_tx(bar, s.bytes);
  wd::issue_span(bar, buf, src, s, win.base16);
}

template <typename T, int KCM>
__global__ void __launch_bounds__(wd::THREADS, 2)
tconv_wide_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ y, int B, int Tin, int F,
                  int C, int CO, int K, int stride, int lp, int Tout, int relu, int CH) {
  extern __shared__ __align__(128) unsigned char wide_smem[];
  const wd::FwdLayout L = wd::fwd_layout(F, C, CO, K, stride, sizeof(T));
  uint64_t* full = reinterpret_cast<uint64_t*>(wide_smem);  // one a window buffer
  unsigned char* win = wide_smem + wd::HEAD;
  const int tid = threadIdx.x;
  const int FC = F * C, KC = K * C;
  const int NV = CO / wd::V, RG = wd::groups(CO);
  const int cv = tid % NV, rg = tid / NV;
  const bool active = rg < RG;
  const int nT = (Tout + L.TT - 1) / L.TT;
  const int first = blockIdx.x * CH;
  const int n = min(CH, B * nT - first);
  const long long total = static_cast<long long>(B) * Tin * FC * sizeof(T);
  W2L_STAMP(0);
  if (tid == 0) {
    wd::mbar_init(&full[0], 1);
    wd::mbar_init(&full[1], 1);
    wd::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) wide_stage(&full[0], win, x, first, nT, L.TT, L.W, FC, Tin, stride, lp, total);

  float wr[KCM][4], b4[4];
  int toff[KCM];
  wd::tap_offsets(toff, KC, C, FC);
#pragma unroll
  for (int kc = 0; kc < KCM; ++kc) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wr[kc][j] = active && kc < KC ? w2l::to_f(w[kc * CO + cv * wd::V + j]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) b4[j] = active && bias != nullptr ? bias[cv * wd::V + j] : 0.f;
  W2L_STAMP(1);

  for (int it = 0; it < n; ++it) {
    const int tile = first + it;
    const int j = it & 1;
    if (tid == 0 && it + 1 < n)
      wide_stage(&full[j ^ 1], win + (j ^ 1) * L.buf, x, tile + 1, nT, L.TT, L.W, FC, Tin,
                 stride, lp, total);
    wd::mbar_wait(&full[j], (it >> 1) & 1);
    if (it < 84) { W2L_STAMP(2 + 3 * it); }
    const int b = tile / nT;
    const int t0 = (tile - b * nT) * L.TT;
    const int nt = min(L.TT, Tout - t0);
    const int row0 = t0 * stride - lp;
    const wd::Window wnd = wd::window(b, row0, L.W, FC, Tin, sizeof(T));
    const T* xs = reinterpret_cast<const T*>(win + j * L.buf + wnd.lead);
    T* yt = y + (static_cast<size_t>(b) * Tout + t0) * F * CO;
    if (active) {
      if (row0 < 0 || row0 + (nt - 1) * stride + K > Tin)
        wide_rows<true>(xs, yt, wr, toff, b4, nt, F, C, CO, KC, stride, cv, rg, RG, row0, Tin,
                        relu);
      else
        wide_rows<false>(xs, yt, wr, toff, b4, nt, F, C, CO, KC, stride, cv, rg, RG, row0,
                         Tin, relu);
    }
    if (it < 84) { W2L_STAMP(3 + 3 * it); }
    __syncthreads();  // this window's readers are done: it takes tile it + 2's copy
    if (it < 84) { W2L_STAMP(4 + 3 * it); }
  }
}

template <typename T>
int launch_wide(const void* x, const void* w, const void* bias, void* y, int B, int Tin, int F,
                int C, int CO, int K, int stride, int lp, int Tout, int relu, int CH,
                cudaStream_t stream) {
  const wd::FwdLayout L = wd::fwd_layout(F, C, CO, K, stride, sizeof(T));
  const long long tiles = static_cast<long long>(B) * ((Tout + L.TT - 1) / L.TT);
  const int blocks = static_cast<int>((tiles + CH - 1) / CH);
  const int kcm = (K * C + 3) / 4 * 4;
  auto go = [&](auto kernel) {
    w2l::allow_smem(kernel, L.bytes);
    kernel<<<blocks, wd::THREADS, L.bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
        static_cast<T*>(y), B, Tin, F, C, CO, K, stride, lp, Tout, relu, CH);
    return static_cast<int>(cudaGetLastError());
  };
  switch (kcm) {
    case 4: return go(tconv_wide_kernel<T, 4>);
    case 8: return go(tconv_wide_kernel<T, 8>);
    case 12: return go(tconv_wide_kernel<T, 12>);
    case 16: return go(tconv_wide_kernel<T, 16>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// K2b
// ---------------------------------------------------------------------------
// A block walks CH consecutive stages of TT frames (those of all batch rows
// in order) with 8 consumer warps and one producer warp. The producer's
// lane 0 fills a ring of WG_STAGES stages: dy's rows of the stage (one
// contiguous span) and the matching window of x, both by cp.async.bulk on
// the stage's full barrier; it refills a stage once the 8 consumer warps
// have arrived on its empty barrier. Consumer (cv, rg) keeps the sums of its
// KC taps x 4 channels in registers over the whole run: per row, one 16-byte
// (bf16: 8-byte) read of dy and KC broadcast reads of x, 4 KC FMAs. At the
// end the RG row groups' sums go through shared memory and are added in
// group order into the block's partial row; wgrad_reduce_kernel adds the
// blocks' rows in block order, as on the other routes.
// Rows rg, rg + RG, ... of a stage of nt frames into the sums.
template <bool EDGE, typename T, int KCM>
__device__ __forceinline__ void wide_wgrad_rows(const T* xs, const T* dys, float (&acc)[KCM][4],
                                                const int (&toff)[KCM], int nt, int F, int C,
                                                int CO, int KC, int stride, int cv, int rg,
                                                int RG, int row0, int Tin) {
  const int FC = F * C;
  for (int t = rg; t < nt; t += RG) {
    for (int f = 0; f < F; ++f) {
      float d[4];
      wd::load4(dys + static_cast<size_t>(t * F + f) * CO + cv * wd::V, d);
      const T* xr = xs + t * stride * FC + f * C;
#pragma unroll
      for (int kc = 0; kc < KCM; ++kc) {
        if (wd::tap_on<KCM>(kc, KC)) {
          const float xv = wd::tap_x<EDGE>(xr, toff[kc], row0 + t * stride, kc, C, Tin);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[kc][j] = fmaf(xv, d[j], acc[kc][j]);
        }
      }
    }
  }
}

template <typename T, int KCM>
__global__ void __launch_bounds__(wd::WG_THREADS, 2)
wgrad_wide_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  float* __restrict__ partial, int B, int Tin, int F, int C, int CO, int K,
                  int stride, int lp, int Tout, int CH) {
  extern __shared__ __align__(128) unsigned char wide_smem[];
  const wd::WgLayout L = wd::wg_layout(F, C, CO, K, stride, sizeof(T));
  uint64_t* full = reinterpret_cast<uint64_t*>(wide_smem);  // one a stage
  uint64_t* empty = full + wd::WG_STAGES;
  unsigned char* ring = wide_smem + wd::HEAD;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int FC = F * C, KC = K * C;
  const int nT = (Tout + L.TT - 1) / L.TT;
  const int first = blockIdx.x * CH;
  const int n = min(CH, B * nT - first);
  W2L_STAMP(0);
  if (tid == 0) {
    for (int s = 0; s < wd::WG_STAGES; ++s) {
      wd::mbar_init(&full[s], 1);
      wd::mbar_init(&empty[s], wd::THREADS / 32);
    }
    wd::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= wd::THREADS) {  // the producer warp
    if (lane == 0) {
      const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
      const unsigned char* db = reinterpret_cast<const unsigned char*>(dy);
      const long long xtotal = static_cast<long long>(B) * Tin * FC * sizeof(T);
      const long long dtotal = static_cast<long long>(B) * Tout * F * CO * sizeof(T);
      for (int it = 0; it < n; ++it) {
        const int s = it % wd::WG_STAGES;
        if (it >= wd::WG_STAGES) wd::mbar_wait(&empty[s], ((it / wd::WG_STAGES) - 1) & 1);
        const int tile = first + it;
        const int b = tile / nT;
        const int t0 = (tile - b * nT) * L.TT;
        const int nt = min(L.TT, Tout - t0);
        unsigned char* dst = ring + s * L.stage;
        const long long dlo = (static_cast<long long>(b) * Tout + t0) * F * CO * sizeof(T);
        const long long dbase = dlo & ~15LL;
        const wd::Span sd = wd::tail_span(dst, db, dlo,
                                          dlo + static_cast<long long>(nt) * F * CO * sizeof(T),
                                          dbase, dtotal);
        const wd::Window wnd = wd::window(b, t0 * stride - lp, L.W, FC, Tin, sizeof(T));
        const wd::Span sx = wd::tail_span(dst + L.dbuf, xb, wnd.lo, wnd.hi, wnd.base16, xtotal);
        wd::mbar_arrive_tx(&full[s], sd.bytes + sx.bytes);
        wd::issue_span(&full[s], dst, db, sd, dbase);
        wd::issue_span(&full[s], dst + L.dbuf, xb, sx, wnd.base16);
      }
    }
    return;
  }

  const int NV = CO / wd::V, RG = wd::groups(CO);
  const int cv = tid % NV, rg = tid / NV;
  const bool active = rg < RG;
  float acc[KCM][4];
#pragma unroll
  for (int kc = 0; kc < KCM; ++kc) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[kc][j] = 0.f;
  }
  int toff[KCM];
  wd::tap_offsets(toff, KC, C, FC);
  W2L_STAMP(1);
  for (int it = 0; it < n; ++it) {
    const int s = it % wd::WG_STAGES;
    wd::mbar_wait(&full[s], (it / wd::WG_STAGES) & 1);
    if (it < 126) { W2L_STAMP(2 + 2 * it); }
    const int tile = first + it;
    const int b = tile / nT;
    const int t0 = (tile - b * nT) * L.TT;
    const int nt = min(L.TT, Tout - t0);
    const int row0 = t0 * stride - lp;
    const unsigned char* src = ring + s * L.stage;
    const long long dlo = (static_cast<long long>(b) * Tout + t0) * F * CO * sizeof(T);
    const T* dys = reinterpret_cast<const T*>(src + (dlo & 15));
    const wd::Window wnd = wd::window(b, row0, L.W, FC, Tin, sizeof(T));
    const T* xs = reinterpret_cast<const T*>(src + L.dbuf + wnd.lead);
    if (active) {
      if (row0 < 0 || row0 + (nt - 1) * stride + K > Tin)
        wide_wgrad_rows<true>(xs, dys, acc, toff, nt, F, C, CO, KC, stride, cv, rg, RG, row0,
                              Tin);
      else
        wide_wgrad_rows<false>(xs, dys, acc, toff, nt, F, C, CO, KC, stride, cv, rg, RG, row0,
                               Tin);
    }
    __syncwarp();
    if (lane == 0) wd::mbar_arrive(&empty[s]);
    if (it < 126) { W2L_STAMP(3 + 2 * it); }
  }

  // the row groups' sums, added in group order: the block's partial row
  wd::sync_consumers();  // every stage has landed and been read: the ring is free
  float* sums = reinterpret_cast<float*>(ring);  // [RG][KC][CO]
  if (active) {
#pragma unroll
    for (int kc = 0; kc < KCM; ++kc) {
      if (kc < KC) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sums[(static_cast<size_t>(rg) * KC + kc) * CO + cv * wd::V + j] = acc[kc][j];
      }
    }
  }
  wd::sync_consumers();
  const int wsize = KC * CO;
  float* out = partial + static_cast<size_t>(blockIdx.x) * wsize;
  for (int e = tid; e < wsize; e += wd::THREADS) {
    float v = 0.f;
    for (int r = 0; r < RG; ++r) v += sums[static_cast<size_t>(r) * wsize + e];
    out[e] = v;
  }
}

template <typename T>
int launch_wgrad_wide(const void* x, const void* dy, void* partial, void* dw, int B, int Tin,
                      int F, int C, int CO, int K, int stride, int lp, int Tout, int CH,
                      cudaStream_t stream) {
  const wd::WgLayout L = wd::wg_layout(F, C, CO, K, stride, sizeof(T));
  const long long tiles = static_cast<long long>(B) * ((Tout + L.TT - 1) / L.TT);
  const int nb = static_cast<int>((tiles + CH - 1) / CH);
  const int kcm = (K * C + 3) / 4 * 4;
  auto go = [&](auto kernel) {
    w2l::allow_smem(kernel, L.bytes);
    kernel<<<nb, wd::WG_THREADS, L.bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<float*>(partial), B,
        Tin, F, C, CO, K, stride, lp, Tout, CH);
    return static_cast<int>(cudaGetLastError());
  };
  int rc;
  switch (kcm) {
    case 4: rc = go(wgrad_wide_kernel<T, 4>); break;
    case 8: rc = go(wgrad_wide_kernel<T, 8>); break;
    case 12: rc = go(wgrad_wide_kernel<T, 12>); break;
    case 16: rc = go(wgrad_wide_kernel<T, 16>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return w2l::launch_wgrad_reduce(static_cast<const float*>(partial), static_cast<float*>(dw),
                                  nb, K * C * CO, stream);
}

}  // namespace

// The wide route: its shared memory, whether it takes a conv (K2,
// or K2b with wgrad = 1) at `item` bytes an element, and its plan for a card
// of `sms` SMs, plan = {frames a tile, tiles a block, blocks} (K2b: frames a
// stage, stages a block, blocks). kernels/tconv.py mirrors all three.
extern "C" int w2l_time_conv_wide_smem_bytes(int F, int C, int CO, int K, int stride, int item,
                                             int wgrad) {
  return wgrad ? wd::wg_layout(F, C, CO, K, stride, item).bytes
               : wd::fwd_layout(F, C, CO, K, stride, item).bytes;
}
extern "C" int w2l_time_conv_wide_takes(int F, int C, int CO, int K, int stride, int item,
                                        int wgrad) {
  return wd::takes(F, C, CO, K, stride, item, wgrad) ? 1 : 0;
}
extern "C" int w2l_time_conv_wide_plan(int B, int Tout, int F, int C, int CO, int K, int stride,
                                       int item, int wgrad, int sms, int* plan) {
  const int tt = wgrad ? wd::wg_layout(F, C, CO, K, stride, item).TT
                       : wd::fwd_layout(F, C, CO, K, stride, item).TT;
  const wd::Plan p = wd::plan(static_cast<long long>(B) * ((Tout + tt - 1) / tt),
                              w2l_time_conv_wide_smem_bytes(F, C, CO, K, stride, item, wgrad),
                              sms);
  plan[0] = tt;
  plan[1] = p.CH;
  plan[2] = p.blocks;
  return 0;
}

// The conv of w2l_time_conv on the wide route (no dilation): CO a multiple
// of 4, 64 < CO <= 1024, K*C <= 16, x 16-byte aligned; a block walks CH
// tiles (w2l_time_conv_wide_plan).
extern "C" int w2l_time_conv_wide(const void* x, const void* w, const void* bias, void* y,
                                  int dtype, int B, int Tin, int F, int C, int CO, int K,
                                  int stride, int lp, int Tout, int relu, int CH, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int item = dtype == w2l::kFloat32 ? 4 : 2;
  if (CH < 1 || lp < 0 || !wd::takes(F, C, CO, K, stride, item, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == w2l::kFloat32)
    return launch_wide<float>(x, w, bias, y, B, Tin, F, C, CO, K, stride, lp, Tout, relu, CH, s);
  if (dtype == w2l::kBFloat16)
    return launch_wide<__nv_bfloat16>(x, w, bias, y, B, Tin, F, C, CO, K, stride, lp, Tout, relu,
                                      CH, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2b on the wide route (w2l_time_conv_wide_takes with wgrad = 1
// says which shapes, w2l_time_conv_wide_plan the stages a block CH): x and
// dy 16-byte aligned; partial holds (blocks, K*C*CO) float32.
extern "C" int w2l_time_conv_wgrad_wide(const void* x, const void* dy, void* partial, void* dw,
                                        int dtype, int B, int Tin, int F, int C, int CO, int K,
                                        int stride, int lp, int Tout, int CH, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int item = dtype == w2l::kFloat32 ? 4 : 2;
  if (CH < 1 || lp < 0 || !wd::takes(F, C, CO, K, stride, item, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == w2l::kFloat32)
    return launch_wgrad_wide<float>(x, dy, partial, dw, B, Tin, F, C, CO, K, stride, lp, Tout,
                                    CH, s);
  if (dtype == w2l::kBFloat16)
    return launch_wgrad_wide<__nv_bfloat16>(x, dy, partial, dw, B, Tin, F, C, CO, K, stride, lp,
                                            Tout, CH, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
