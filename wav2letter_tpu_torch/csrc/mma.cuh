// mma.sync fragments shared by K1 (mfsc.cu), K4/K4b (attention.cu) and the
// 3xTF32 route of K2/K2b (tconv.cu, tconv_wgrad.cu): one
// 16 x 8 tile product of a 16-row A fragment with an 8-column B fragment,
// fp32 sums, in bf16 (m16n8k16) or in fp32 as three TF32 passes (m16n8k8).
//
// 3xTF32: x = big + small, big = tf32(x) and small = tf32(x - big), both
// rounded to nearest with ties away from zero (cvt.rna); a . b is taken as
// small . big + big . small + big . big. The dropped small . small term is
// ~2^-22 of a product, so the sums keep fp32's digits where plain TF32 keeps
// about three.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w2l {

// d += a . b on one 16 x 8 tile, 32 bytes deep, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small, both TF32 (fp32 bits with the low 13 of the mantissa 0).
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(__uint_as_float(x)));
  const float rest = __uint_as_float(x) - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// A B fragment of one m16n8k8 TF32 step, split once so that several A
// fragments can take it.
struct BFragTF32 {
  uint32_t big[2], small[2];
  BFragTF32() = default;  // halves filled by the caller (split once, at staging)
  __device__ __forceinline__ BFragTF32(uint32_t b0, uint32_t b1) {
    split_tf32(b0, big[0], small[0]);
    split_tf32(b1, big[1], small[1]);
  }
};

// The A operand of one 32-byte deep step of a 16-row tile product, from the
// four registers ldmatrix.x4 gives for it (rows 0-7 and 8-15 of the first and
// of the second 16 bytes), and its product with a B fragment, d + e += a . b.
// bf16: d += a . b by one m16n8k16, e untouched. fp32: three m16n8k8 TF32
// passes, d += big . big and e += small . big + big . small, two chains that
// the tensor cores can overlap (d and e may be the same array: one chain).
template <typename T>
struct AFrag;
template <>
struct AFrag<__nv_bfloat16> {
  uint32_t a[4];
  __device__ __forceinline__ explicit AFrag(const uint32_t (&r)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = r[i];
  }
  __device__ __forceinline__ void mma(float (&d)[4], float (&)[4], uint32_t b0,
                                      uint32_t b1) const {
    mma_bf16(d, a, b0, b1);
  }
};
template <>
struct AFrag<float> {
  uint32_t big[4], small[4];
  AFrag() = default;
  __device__ __forceinline__ explicit AFrag(const uint32_t (&r)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(r[i], big[i], small[i]);
  }
  __device__ __forceinline__ void mma(float (&d)[4], float (&e)[4], const BFragTF32& b) const {
    mma_tf32(e, small, b.big[0], b.big[1]);
    mma_tf32(e, big, b.small[0], b.small[1]);
    mma_tf32(d, big, b.big[0], b.big[1]);
  }
  __device__ __forceinline__ void mma(float (&d)[4], float (&e)[4], uint32_t b0,
                                      uint32_t b1) const {
    mma(d, e, BFragTF32(b0, b1));
  }
};

}  // namespace w2l
