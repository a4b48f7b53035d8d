// Tensor-core pieces shared by the bf16 time-conv kernels (K2 forward and
// dgrad in tconv.cu, K2b in tconv_wgrad.cu): cp.async, ldmatrix and mma.sync
// wrappers, and the ring of window rows that a block stages while it walks
// its time tiles.
//
// A block owns one batch row, TC_FB = 16 frequency positions (one 16-row
// m-tile of the GEMM at each frame) and a run of consecutive time tiles. The
// input frames it needs are staged as rows of a ring in shared memory, bf16,
// by 16-, 8- or 4-byte cp.async issued by every thread: a frame read for one
// tile stays for the next, so each byte is staged once per block and feeds
// K / stride taps. Row layout, two modes:
//   channels (C >= 2): position f of a row at f * Pe elements, channel c at
//     + c; Pe is C rounded up to 8 and then to an odd number of 16-byte
//     units, so the 8 rows an ldmatrix phase reads (8 positions) fall in 8
//     different bank groups; channels C..Pe-1 stay zero.
//   taps (C == 1): a row is the block's 16 positions, 24 elements apart
//     (48 bytes, an odd number of units), so the 8 rows an ldmatrix phase
//     reads (8 frames = 8 taps) meet no bank conflict either.
// The ring holds NR = W + TT * stride rows, W the rows one tile's window
// spans: while a tile computes on its window, the next tile's new rows land
// in slots no window row of this tile occupies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w2l {
namespace tc {

constexpr int TT = 16;       // output frames per tile
constexpr int FB = 16;       // frequency positions per block: one m-tile a frame
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TAP_PITCH = 24;  // elements per ring row in the taps mode

__host__ __device__ inline int pad8(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
// n (a multiple of 8) raised to an odd number of 16-byte units of bf16
__host__ __device__ inline int odd_units(int n) { return ((n >> 3) & 1) ? n : n + 8; }

// One ring: NR rows of RP elements; a row holds FB positions, Pe apart.
struct Ring {
  int tap;  // 1: taps mode (C == 1)
  int Pe;   // elements between positions
  int RP;   // elements per row
  int W;    // rows of one tile's window
  int NR;   // rows of the ring
};

// pe: the pitch a position needs in the channels mode (ignored in the taps
// mode); span: the window's extra rows (K - 1 for a conv of K taps, 0 for a
// plain tile of rows). NR is rounded up to even: a frame of a source dilated
// by 2 then meets the same slots always, and the slots of its zero frames,
// zeroed once, need no copies.
__host__ __device__ inline Ring make_ring(int C, int pe, int stride, int span) {
  Ring r;
  r.tap = C == 1;
  r.Pe = r.tap ? 1 : pe;
  r.RP = r.tap ? TAP_PITCH : FB * pe;
  r.W = (TT - 1) * stride + span + 1;
  r.NR = (r.W + TT * stride + 1) & ~1;
  return r;
}

// Units (16-, 8- or 4-byte copies) one ring row takes, and the entries of
// their table (computed at the start of a kernel; at most 8 C of them, the
// count at 4-byte units).
__host__ __device__ inline int table_entries(int C) { return 8 * C; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// G bytes from device to shared memory, asynchronously; the bytes past
// src_bytes (all of them when it is 0) are zeros and are not read.
__device__ __forceinline__ void cp_async(int G, uint32_t dst, const void* src, int src_bytes) {
  if (G == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
  } else if (G == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x1_trans(uint32_t& r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r) : "r"(addr));
}

// d += a . b on one 16 x 8 tile, 16 deep (k16) or 8 deep (k8), fp32 sums.
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// B fragments of NT n-tiles for one k16 step, from a row-major [k][n] bf16
// matrix in shared memory (ldmatrix.trans), two n-tiles per x4. `base` is the
// address of element (k0, 0); `lane_off` the lane's byte offset,
// ((mat & 1) * 8 + i) * pitch + (mat >> 1) * 8 elements for lane = 8 mat + i.
template <int NT>
__device__ __forceinline__ void load_b16(uint32_t (&b)[NT][2], uint32_t base, int lane_off) {
#pragma unroll
  for (int j = 0; j + 1 < NT; j += 2) {
    uint32_t r[4];
    ldsm_x4_trans(r, base + lane_off + j * 16);
    b[j][0] = r[0];
    b[j][1] = r[1];
    b[j + 1][0] = r[2];
    b[j + 1][1] = r[3];
  }
  if (NT & 1) {
    uint32_t r[2];
    ldsm_x2_trans(r, base + lane_off + (NT - 1) * 16);
    b[NT - 1][0] = r[0];
    b[NT - 1][1] = r[1];
  }
}

// The same for one k8 step: four n-tiles per x4; lane_off = i * pitch + mat
// * 8 elements, in bytes.
template <int NT>
__device__ __forceinline__ void load_b8(uint32_t (&b)[NT], uint32_t base, int lane_off) {
  int j = 0;
#pragma unroll
  for (; j + 3 < NT; j += 4) {
    uint32_t r[4];
    ldsm_x4_trans(r, base + lane_off + j * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) b[j + q] = r[q];
  }
  if ((NT & 3) >= 2) {
    uint32_t r[2];
    ldsm_x2_trans(r, base + lane_off + j * 16);
    b[j] = r[0];
    b[j + 1] = r[1];
    j += 2;
  }
  if (NT & 1) ldsm_x1_trans(b[NT - 1], base + lane_off + (NT - 1) * 16);
}

// Runs n steps of load(fragments) then use(fragments), the next step's
// fragments loaded (ldmatrix) before this step's products (mma), so their
// latency overlaps: two buffers, distinct objects, so that they stay in
// registers. `load` advances its own step.
template <typename Frag, typename Load, typename Use>
__device__ __forceinline__ void pipelined(int n, Frag& f0, Frag& f1, Load load, Use use) {
  if (n <= 0) return;
  load(f0);
  for (int s = 0; s < n; s += 2) {
    if (s + 1 < n) load(f1);
    use(f0);
    if (s + 1 >= n) break;
    if (s + 2 < n) load(f0);
    use(f1);
  }
}

// Issues the copies of a bf16 weight into a [rows][pitch] matrix in shared
// memory: row r is source row src_row(r) of `ncols` elements (ncols even),
// or zeros where src_row gives -1; columns ncols..pitch-1 are zeros. G, the
// bytes of one copy, divides 2 ncols and 2 pitch.
template <typename RowMap>
__device__ __forceinline__ void stage_weight(uint32_t dst, const __nv_bfloat16* src, int rows,
                                             int pitch, int ncols, int G, RowMap src_row,
                                             int tid) {
  const int ge = G / 2;
  const int U = pitch / ge;
  const int dr = THREADS / U, du = THREADS - dr * U;
  int r = tid / U, u = tid - r * U;
  while (r < rows) {
    const int e = u * ge;
    const int sr = src_row(r);
    const bool real = sr >= 0 && e < ncols;
    const __nv_bfloat16* s = real ? src + static_cast<size_t>(sr) * ncols + e : src;
    cp_async(G, dst + 2 * (r * pitch + e), s, real ? G : 0);
    u += du;
    r += dr;
    if (u >= U) {
      u -= U;
      ++r;
    }
  }
}

// Fills `table` with one entry per copy unit of a ring row: the unit's
// element offset in the row slot, and its position f in bits 16 and up.
__device__ __forceinline__ void fill_table(int* table, int C, int Pe, int G, int tid) {
  const int ge = G / 2;
  const int U = FB * C / ge;
  for (int u = tid; u < U; u += THREADS) {
    const int e = u * ge;
    const int f = e / C;
    table[u] = (f * Pe + e - f * C) | (f << 16);
  }
}

// Issues the copies of rows [x0, x0 + n) of a (dilated) source into the
// ring; `src` is the block's batch row and first position, rows F * C
// elements apart. Row x reads source frame x / dil where 0 <= x < Tdil and
// dil divides x; other rows, and positions at or past F, are zeros: copies
// of zeros, except rows that dil does not divide where dil divides NR (their
// slots hold the zeros the ring was cleared to). Slot of row x: (x - xbase)
// mod NR. Every thread issues its share.
__device__ __forceinline__ void stage_rows(uint32_t ring, const __nv_bfloat16* src,
                                           const int* table, const Ring& rg, int x0, int n,
                                           int xbase, int Tdil, int dil, int F, int C,
                                           int fleft, int G, int tid) {
  const int ge = G / 2;
  const int U = FB * C / ge;
  const int dr = THREADS / U, du = THREADS - dr * U;
  int r = tid / U, u = tid - r * U;
  const size_t rowlen = static_cast<size_t>(F) * C;
  const int slot0 = (x0 - xbase) % rg.NR;  // n <= NR: a slot wraps at most once
  const bool skip_gaps = dil > 1 && rg.NR % dil == 0;
  while (r < n) {
    const int x = x0 + r;
    if (skip_gaps && x % dil != 0) {
      u += du;
      r += dr;
      if (u >= U) {
        u -= U;
        ++r;
      }
      continue;
    }
    const int ent = table[u];
    const int f = ent >> 16;
    const bool row_ok = x >= 0 && x < Tdil && (dil == 1 || x % dil == 0);
    int bytes = row_ok ? min(G, (fleft - f) * C * 2) : 0;
    bytes = max(bytes, 0);
    const __nv_bfloat16* s =
        bytes > 0 ? src + static_cast<size_t>(dil == 1 ? x : x / dil) * rowlen + u * ge : src;
    const int slot = slot0 + r < rg.NR ? slot0 + r : slot0 + r - rg.NR;
    cp_async(G, ring + 2 * (slot * rg.RP + (ent & 0xffff)), s, bytes);
    u += du;
    r += dr;
    if (u >= U) {
      u -= U;
      ++r;
    }
  }
}

}  // namespace tc
}  // namespace w2l
