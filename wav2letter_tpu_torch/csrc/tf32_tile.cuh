// fp32 pieces shared by the 3xTF32 time-conv kernels (K2 forward and dgrad in
// tconv.cu, K2b in tconv_wgrad.cu): the rows of input frames a block stages
// in shared memory as fp32, and the cp.async copies that fill them.
//
// A block owns one batch row and FB = 16 frequency positions (one 16-row
// m-tile of the implicit GEMM at each frame). A staged row holds the 16
// positions Pe floats apart, channel c of position f at f * Pe + c; at C = 1
// (the taps mode) the 16 positions lie side by side. The kernels pick Pe and
// the row pitch RP so that the 32 lanes of a 32-bit fragment load hit 32
// banks. Row x of the (dilated) source sits in slot (x - xbase) mod NR.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

// A clock64 stamp of thread 0 (kernels/trace_k2.py defines it); nothing here.
#ifndef W2L_STAMP
#define W2L_STAMP(i)
#endif

#include "mma.cuh"

namespace w2l {
namespace tf32 {

constexpr int FB = 16;  // positions a block: one m-tile a frame

// x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away from
// zero, as cvt.rna.tf32.f32 rounds finite values, by an integer add and a
// mask: the conversion unit runs at a quarter of the rate, and splitting
// the operands is most of these kernels' work beside the products.
__device__ __forceinline__ uint32_t rna(uint32_t x) { return (x + 0x1000u) & 0xFFFFE000u; }

// x = big + small, both TF32 (mma.cuh::split_tf32, by integer rounding).
__device__ __forceinline__ void split(uint32_t x, uint32_t& big, uint32_t& small) {
  big = rna(x);
  small = rna(__float_as_uint(__uint_as_float(x) - __uint_as_float(big)));
}

// A B fragment split once (mma.cuh::BFragTF32), by integer rounding.
__device__ __forceinline__ BFragTF32 bfrag(uint32_t b0, uint32_t b1) {
  BFragTF32 b;
  split(b0, b.big[0], b.small[0]);
  split(b1, b.big[1], b.small[1]);
  return b;
}

// The A operand of one m16n8k8 step split once (mma.cuh::AFrag<float>), by
// integer rounding; d += big . big and e += the cross terms.
struct AFrag32 {
  uint32_t big[4], small[4];
  __device__ __forceinline__ explicit AFrag32(const uint32_t (&r)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(r[i], big[i], small[i]);
  }
  __device__ __forceinline__ void mma(float (&d)[4], float (&e)[4], const BFragTF32& b) const {
    mma_tf32(e, small, b.big[0], b.big[1]);
    mma_tf32(e, big, b.small[0], b.small[1]);
    mma_tf32(d, big, b.big[0], b.big[1]);
  }
};

// n / d and n % d by a multiply-high, exact for 0 <= n with n * d < 2^32: a
// divisor fixed for a kernel is set up once, and the staging loops divide by
// no variable.
struct FastDiv {
  uint32_t m;
  int d;
  __device__ __forceinline__ explicit FastDiv(int d_)
      : m(d_ == 1 ? 0u : 0xFFFFFFFFu / static_cast<uint32_t>(d_) + 1u), d(d_) {}
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), m));
  }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * d; }
};

// The rows a block stages from one source, and how they are copied: G bytes
// (16, 8 or 4) a copy, U copies a row of FB positions of C channels.
struct Rows {
  int Pe;  // floats between positions
  int RP;  // floats a row
  int NR;  // rows (slots)
  int C, G, U;
  FastDiv byC;  // a copy's position: its first float / C
  __device__ __forceinline__ Rows(int Pe_, int RP_, int NR_, int C_, int G_)
      : Pe(Pe_), RP(RP_), NR(NR_), C(C_), G(G_), U(FB * C_ * 4 / G_), byC(C_) {}
};

// Issues the copies of rows [x0, x0 + n), n <= NR, of a (dilated) fp32
// source into the slots of `rows`, by threads tid, tid + nthr, ...: `src`
// is the block's batch row and first position, F * C floats a row. Row x is
// source frame x / dil where 0 <= x < Tdil and dil divides x, else zeros;
// positions at or past fleft are zeros. G divides 4 C and 4 F C (at C = 1,
// where copies span positions, only 4 F), and src is aligned to it.
__device__ __forceinline__ void stage_rows(uint32_t dst, const float* src, const Rows& rows,
                                           int F, int x0, int n, int xbase, int Tdil,
                                           const FastDiv& dil, int fleft, int tid, int nthr) {
  if (n <= 0) return;
  const int ge = rows.G >> 2, U = rows.U, C = rows.C;
  const size_t rowlen = static_cast<size_t>(F) * C;
  const int dr = nthr / U, du = nthr - dr * U;
  int r = tid / U, u = tid - r * U;
  const int slot0 = (x0 - xbase) % rows.NR;
  while (r < n) {
    const int x = x0 + r;
    const int e = u * ge;
    const int f = rows.byC.div(e);
    const int xs = dil.div(x);
    int bytes = 0;
    if (x >= 0 && x < Tdil && xs * dil.d == x) bytes = max(0, min(rows.G, (fleft - f) * C * 4));
    const float* s = bytes > 0 ? src + static_cast<size_t>(xs) * rowlen + e : src;
    const int slot = slot0 + r < rows.NR ? slot0 + r : slot0 + r - rows.NR;
    tc::cp_async(rows.G, dst + 4 * (slot * rows.RP + f * rows.Pe + e - f * C), s, bytes);
    u += du;
    r += dr;
    if (u >= U) {
      u -= U;
      ++r;
    }
  }
}

}  // namespace tf32
}  // namespace w2l
