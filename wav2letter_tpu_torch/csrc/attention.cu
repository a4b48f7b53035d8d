// K4: fused multi-head self-attention with the Transformer-XL relative-
// position bias, forward. K4b: its full-recompute backward.
//
// Replace the TPU kernels wav2letter_tpu/ops/pallas/attention.py::fused_mhsa
// (_mhsa_fwd, _fwd_kernel) and ::_mhsa_bwd (_bwd_kernel). Per (batch, head),
// with q already scaled by 1/sqrt(Dh) and heads the column blocks of the
// (B, T, H*Dh) activations:
//   scores[i, j] = q_i . k_j + q_i . Pwin[j - i + T - 1] + mask[b, j]   (fp32)
//   p = softmax_j(scores);  pd = keep ? p / (1 - rate) : 0   (counter hash)
//   out_i = sum_j pd[i, j] v_j
// and backward, for the output gradient g:
//   dv_j = sum_i pd[i, j] g_i;   dpd = g . v^T;   dp = keep ? dpd / (1 - rate) : 0
//   ds = p * (dp - sum_j dp * p)
//   dq_i = sum_j ds[i, j] (k_j + Pwin[j - i + T - 1]);   dk_j = sum_i ds[i, j] q_i
//   dPwin[r] = sum over (b, h) and over j - i + T - 1 = r of ds[i, j] q_i
//
// K4's bound on the H100: the function does 6 B H T^2 Dh operations on
// 8 B T H Dh bytes of q, k, v and out in bf16, 0.75 T per byte, against the
// card's ~295 per byte on the tensor cores: bytes bind it at the transformer
// recipe's T = 192 (144 per byte), operations from T ~ 400 on, and in fp32
// (0.375 T per byte against ~150 per byte at the TF32 rate, ~20 outside the
// tensor cores) operations at any T the recipes use.
//
// K4's design. The TPU kernel keeps a whole (batch, head) in fast memory; the
// q, k, v of one head and its T x T scores do not fit a block's 227 KB here.
// So the grid tiles the queries: one block per (tile of 16, 32 or 64 query
// rows, head, batch), four warps per slab of 16 rows. A slab keeps its 16 x T
// score rows in shared memory in fp32, so a whole row is present and the
// softmax is the plain two-pass one, with no online rescaling. Heads are read
// and written in place with row stride H*Dh; nothing is split, merged or
// padded in device memory. k, Pwin and v stream through shared memory in
// chunks of 128 bytes' worth of rows (64 bf16, 32 fp32) by 16-byte cp.async,
// double-buffered; rows are padded to an odd number of 16-byte units, so that
// ldmatrix meets no bank conflict, and the depth is filled with zeros up to a
// multiple of 32 bytes. Each warp of a slab takes a quarter of every chunk.
// The three products run on the tensor cores as mma.sync tiles of 16 rows
// with fp32 sums: bf16 as m16n8k16; fp32 as m16n8k8 in three TF32 passes
// (x = big + small with big = tf32(x), small = tf32(x - big); big.big +
// big.small + small.big), which keeps fp32's digits where plain TF32 would
// keep ~3. The shear is the index where fragments are stored: a slab forms
// its 16 x (T + 15) product q . Pwin^T and adds element (il, c) of it to
// S[il, rbase + c - (T-1) + i] where that column lies in [0, T); each (row,
// column) belongs to one thread, so there are no atomics. p is rounded to v's
// type and, in bf16, written over the slab's own fp32 score rows as the A
// operand of p . v. Every block streams all of its head's k and v and
// T + rows - 1 rows of Pwin; in bf16, issuing those copies takes about as
// long as the products (kernels/trace_k4.py). The tile height is picked in
// kernels/attention.py to keep as many SMs busy as the shape allows with one
// block each.
//
// The backward runs four launches of THREADS threads on the fp32 pipes, with
// fp32 sums (inputs of either type converted exactly). (1) per tile of
// R = 16 query rows: scores and p (tile_probs: the tile's q rows and its
// R x T score rows in shared memory; each thread takes one key or one row of
// Pwin and forms its products with all R query rows, adding product il of
// Pwin row r to scores[il, r - (T - 1) + i0 + il]), dpd, ds and dq, which
// needs only that tile's rows; pd and ds, rounded to the
// working type, go to scratch (B, H, T, T). (2) per tile of R keys: dv and dk
// as sums over all query rows of that scratch, one owner per output. (3) per
// tile of R rows of Pwin and (b, h): that head's share of dPwin, reading ds
// along the diagonals j - i = r - (T - 1). (4) dPwin = the shares summed in
// (b, h) order. No atomics anywhere: equal inputs give equal bits.
#include "common.cuh"

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int R = 16;    // query rows (or keys, or Pwin rows) per block
constexpr int RG = 8;    // rows per thread in the accumulating products
constexpr int IC = 64;   // rows of scratch staged per step in launches 2 and 3

// 8 consecutive elements as floats; p is 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 2 consecutive elements as floats; p is aligned to 2 elements.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The dropout keep mask: a murmur3-style finalizer over the element's counter
// row * Tp + col mixed with the seed and the (batch, head) index, in uint32
// arithmetic that wraps; keep where the hash is below thresh.
struct Dropout {
  uint32_t mix;
  uint32_t tp;
  uint32_t thresh;
  float scale;
  bool on;
  __device__ __forceinline__ bool keep(int row, int col) const {
    uint32_t x = static_cast<uint32_t>(row) * tp + static_cast<uint32_t>(col) + mix;
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    return x < thresh;
  }
};

__device__ __forceinline__ Dropout make_dropout(int seed, int prog, int tp, unsigned thresh,
                                                float scale, float rate) {
  Dropout d;
  d.mix = static_cast<uint32_t>(seed) * 0x9E3779B9u + static_cast<uint32_t>(prog) * 0x85EBCA6Bu;
  d.tp = static_cast<uint32_t>(tp);
  d.thresh = thresh;
  d.scale = scale;
  d.on = rate > 0.f;
  return d;
}

// For each of n rows (row r at rows + r * stride, Dh elements), one thread
// forms the products with the R rows of xs (shared memory, R x Dh fp32) and
// hands them to emit(r, acc).
template <typename T, typename Emit>
__device__ __forceinline__ void row_dots(const float* xs, int Dh, const T* rows, size_t stride,
                                         int n, Emit emit) {
  for (int r = threadIdx.x; r < n; r += THREADS) {
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    const T* row = rows + static_cast<size_t>(r) * stride;
    for (int d = 0; d < Dh; d += 8) {
      float x[8];
      load8(row + d, x);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(xs + i * Dh + d);
        const float4 b = *reinterpret_cast<const float4*>(xs + i * Dh + d + 4);
        float s = acc[i];
        s = fmaf(a.x, x[0], s); s = fmaf(a.y, x[1], s);
        s = fmaf(a.z, x[2], s); s = fmaf(a.w, x[3], s);
        s = fmaf(b.x, x[4], s); s = fmaf(b.y, x[5], s);
        s = fmaf(b.z, x[6], s); s = fmaf(b.w, x[7], s);
        acc[i] = s;
      }
    }
    emit(r, acc);
  }
}

// a0[ii], a1[ii] += sum over n < N of w(ii, n) * x[n, 2*dp + {0, 1}], for the
// RG rows ii of one thread's group; row n of x is at x + n * stride.
template <typename T, typename W>
__device__ __forceinline__ void accum_rows(const T* x, size_t stride, int N, int dp, W w,
                                           float* a0, float* a1) {
  for (int n = 0; n < N; ++n) {
    const float2 xv = load2(x + static_cast<size_t>(n) * stride + 2 * dp);
#pragma unroll
    for (int ii = 0; ii < RG; ++ii) {
      const float wv = w(ii, n);
      a0[ii] = fmaf(wv, xv.x, a0[ii]);
      a1[ii] = fmaf(wv, xv.y, a1[ii]);
    }
  }
}

// Rows i0 .. i0+R-1 of one head of x (B, T, H*Dh) into shared memory as fp32;
// rows beyond T are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* xs, const T* x, int b, int h, int i0, int Tn,
                                          int H, int Dh) {
  const size_t HD = static_cast<size_t>(H) * Dh;
  for (int idx = threadIdx.x; idx < R * Dh; idx += THREADS) {
    const int il = idx / Dh, d = idx - il * Dh;
    const int i = i0 + il;
    xs[idx] = i < Tn ? w2l::to_f(x[(static_cast<size_t>(b) * Tn + i) * HD + h * Dh + d]) : 0.f;
  }
}

// S[il, j] = q_il . k_j + q_il . Pwin[j - (i0 + il) + T - 1] + mask[b, j] for
// the tile's R rows and all T keys, then p = softmax over j, left in S in
// fp32. Ends synchronized.
template <typename T>
__device__ __forceinline__ void tile_probs(float* S, const float* qs, const T* k, const T* pos,
                                           const float* mask, int b, int h, int i0, int Tn,
                                           int H, int Dh) {
  const size_t HD = static_cast<size_t>(H) * Dh;
  const float* mrow = mask + static_cast<size_t>(b) * Tn;
  row_dots(qs, Dh, k + static_cast<size_t>(b) * Tn * HD + h * Dh, HD, Tn,
           [&](int j, const float* acc) {
             const float m = mrow[j];
#pragma unroll
             for (int il = 0; il < R; ++il) S[il * Tn + j] = acc[il] + m;
           });
  __syncthreads();
  // the rows of Pwin this tile can reach: r = j - i + T - 1 over its i, all j
  const int r0 = Tn - i0 - R;
  const int rlo = r0 > 0 ? r0 : 0;
  const int nr = r0 + Tn + R - 1 - rlo;
  row_dots(qs, Dh, pos + static_cast<size_t>(rlo) * Dh, static_cast<size_t>(Dh), nr,
           [&](int rr, const float* acc) {
             const int jbase = rlo + rr - (Tn - 1) + i0;
#pragma unroll
             for (int il = 0; il < R; ++il) {
               const int j = jbase + il;
               if (j >= 0 && j < Tn) S[il * Tn + j] += acc[il];
             }
           });
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int il = warp; il < R; il += THREADS / 32) {
    float* row = S + il * Tn;
    float m = -INFINITY;
    for (int j = lane; j < Tn; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < Tn; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < Tn; j += 32) row[j] = row[j] / s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------
constexpr int NWC = 4;        // warps that share a 16-row slab of queries, each a slice
constexpr int MAX_SLABS = 4;  // slabs a block at most: 64 query rows, 512 threads
constexpr int CHB = 128;      // a staged chunk holds 128 / sizeof(T) rows of k, Pwin or v
constexpr int VC = 128;       // columns of v per staged chunk
constexpr int VP = VC + 8;    // pitch of a staged v row, in elements

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; with src_bytes = 0
// nothing is read and the 16 bytes are zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
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

// The A operand of one 32-byte deep step of a 16-row tile product, from the
// four registers ldmatrix.x4 gives for it (rows 0-7 and 8-15 of the first and
// of the second 16 bytes), and its product with a B fragment, d + e += a . b.
// bf16: d += a . b by one m16n8k16, e untouched. fp32: three m16n8k8 TF32
// passes, d += big . big and e += small . big + big . small, two chains that
// the tensor cores can overlap.
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
  __device__ __forceinline__ explicit AFrag(const uint32_t (&r)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(r[i], big[i], small[i]);
  }
  __device__ __forceinline__ void mma(float (&d)[4], float (&e)[4], uint32_t b0,
                                      uint32_t b1) const {
    uint32_t bb0, bs0, bb1, bs1;
    split_tf32(b0, bb0, bs0);
    split_tf32(b1, bb1, bs1);
    mma_tf32(e, small, bb0, bb1);
    mma_tf32(e, big, bs0, bs1);
    mma_tf32(d, big, bb0, bb1);
  }
};

// Shared memory of one K4 block of `rows` query rows, elements of es bytes:
// S, the rows x sp fp32 scores (sp = T rounded up to 8, plus 4: an odd number
// of 16-byte units, so ldmatrix of p meets no bank conflict); the q tile,
// rows x kp bytes (the depth, Dh * es rounded up to 32 bytes and filled with
// zeros, plus 16); two staging buffers, each a chunk of CHB / es rows of k or
// Pwin (kp bytes) or of v (VP elements). kernels/attention.py::fwd_smem_bytes
// is the same formula.
struct FwdLayout {
  int sp, depth, kp, stage;
  size_t q_off, stage_off, bytes;
};
__host__ __device__ __forceinline__ FwdLayout fwd_layout(int rows, int Tn, int Dh, int es) {
  FwdLayout L;
  const int ch = CHB / es;
  L.sp = (Tn + 7) / 8 * 8 + 4;
  L.depth = (Dh * es + 31) / 32 * 32;
  L.kp = L.depth + 16;
  L.stage = ch * L.kp > ch * VP * es ? ch * L.kp : ch * VP * es;
  L.q_off = static_cast<size_t>(rows) * L.sp * sizeof(float);
  L.stage_off = L.q_off + static_cast<size_t>(rows) * L.kp;
  L.bytes = L.stage_off + 2 * static_cast<size_t>(L.stage);
  return L;
}

// Rows first .. first+n-1 of a row array (row r at base + r * stride) into
// shared memory at dst, pitch bytes apart, `units` 16-byte units a row, with
// cp.async by every thread of the block. The (row, unit) pairs are dealt out
// in order, so every lane of a warp copies 16 bytes even where a row has
// fewer than 32 units: issuing the copies, not the bytes, is what costs an
// SM here. Rows outside [lo, hi) and units from byte `valid` of a row on are
// zeros.
template <typename T>
__device__ __forceinline__ void load_rows_async(char* dst, int pitch, int n, int units,
                                                const T* base, size_t stride, int first, int lo,
                                                int hi, int valid) {
  const int nt = blockDim.x, sr = nt / units, su = nt - sr * units;
  int row = threadIdx.x / units, u = threadIdx.x - row * units;
  for (int idx = threadIdx.x; idx < n * units; idx += nt) {
    const int r = first + row;
    const bool ok = r >= lo && r < hi && u * 16 < valid;
    const char* src = ok ? reinterpret_cast<const char*>(base + static_cast<size_t>(r) * stride) +
                               u * 16
                         : reinterpret_cast<const char*>(base);
    cp_async16(smem_addr(dst + row * pitch + u * 16), src, ok ? 16 : 0);
    row += sr;  // the pair nt further on
    u += su;
    if (u >= units) {
      u -= units;
      ++row;
    }
  }
}

// acc[nt] = tile nt (NT = 1 or 2 of them) of A . B^T, 16 x 8 each, over
// `depth` bytes: A the 16 rows at a, B the 8 * NT rows at bm, both in shared
// memory, pitch bytes a row. The fragments of the next 32-byte step are
// loaded while the tensor cores work on this one, and even and odd steps sum
// into separate accumulators, so that no product waits for the one before.
template <typename T, int NT>
__device__ __forceinline__ void tile_dots(float (&acc)[NT][4], uint32_t a, uint32_t bm,
                                          int pitch, int depth) {
  float d[2][NT][4] = {}, e[2][NT][4] = {};
  const int lane = threadIdx.x & 31;
  const uint32_t a_lane = a + (lane & 15) * pitch + (lane >> 4) * 16;
  const uint32_t b_lane = bm + ((lane & 7) + (NT == 2 ? (lane >> 4) * 8 : 0)) * pitch +
                          ((lane >> 3) & 1) * 16;
  uint32_t ra[4], rb[2 * NT];
  auto fetch = [&](int kb, uint32_t (&xa)[4], uint32_t (&xb)[2 * NT]) {
    ldsm_x4(xa, a_lane + kb);
    if constexpr (NT == 2) {
      ldsm_x4(xb, b_lane + kb);
    } else {
      ldsm_x2(xb, b_lane + kb);
    }
  };
  fetch(0, ra, rb);
  for (int kb = 0; kb < depth; kb += 64) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      const int kc = kb + 32 * par;
      if (kc >= depth) break;
      uint32_t na[4], nb[2 * NT];
      const bool more = kc + 32 < depth;
      if (more) fetch(kc + 32, na, nb);
      const AFrag<T> af(ra);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) af.mma(d[par][nt], e[par][nt], rb[2 * nt], rb[2 * nt + 1]);
      if (more) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ra[i] = na[i];
#pragma unroll
        for (int i = 0; i < 2 * NT; ++i) rb[i] = nb[i];
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = (d[0][nt][i] + d[1][nt][i]) + (e[0][nt][i] + e[1][nt][i]);
}

// The B fragments of two 8-column tiles (columns n0.., n0+8..) of a staged v
// chunk (rows = keys, VP elements a row), keys ks.. of one 32-byte step.
__device__ __forceinline__ void load_v(uint32_t (&bv)[4], const __nv_bfloat16* vs, int ks,
                                       int n0, int lane) {
  const int kr = ks + (lane & 7) + ((lane >> 3) & 1) * 8, col = n0 + (lane >> 4) * 8;
  ldsm_x4_trans(bv, smem_addr(vs + kr * VP + col));
}
__device__ __forceinline__ void load_v(uint32_t (&bv)[4], const float* vs, int ks, int n0,
                                       int lane) {
  const float* p = vs + (ks + (lane & 3)) * VP + n0 + (lane >> 2);
  bv[0] = __float_as_uint(p[0]);
  bv[1] = __float_as_uint(p[4 * VP]);
  bv[2] = __float_as_uint(p[8]);
  bv[3] = __float_as_uint(p[4 * VP + 8]);
}

// p = softmax_j of four score rows (row r at S4 + r * sp, query row i0 + r),
// by one warp, the rows interleaved; dropout (row, column j); rounded to T
// and written over the row's own leading bytes, 0 from column T to `tail`.
template <typename T>
__device__ __forceinline__ void softmax4(float* S4, int sp, int Tn, int i0, int tail,
                                         const Dropout& drop) {
  const int lane = threadIdx.x & 31;
  float* row[4];
  float m[4], s[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    row[r] = S4 + r * sp;
    m[r] = -INFINITY;
    s[r] = 0.f;
  }
  for (int j = lane; j < Tn; j += 32)
#pragma unroll
    for (int r = 0; r < 4; ++r) m[r] = fmaxf(m[r], row[r][j]);
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = warp_max(m[r]);
  for (int j = lane; j < Tn; j += 32)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = expf(row[r][j] - m[r]);
      row[r][j] = e;
      s[r] += e;
    }
#pragma unroll
  for (int r = 0; r < 4; ++r) s[r] = 1.f / warp_sum(s[r]);
  for (int j0 = 0; j0 < Tn; j0 += 32) {
    const int j = j0 + lane;
    float p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      p[r] = 0.f;
      if (j < Tn) {
        p[r] = row[r][j] * s[r];
        if (drop.on) p[r] = drop.keep(i0 + r, j) ? p[r] * drop.scale : 0.f;
      }
    }
    __syncwarp();  // every lane has read its row[j] before p overwrites row[j0/2 ..]
    if (j < Tn)
#pragma unroll
      for (int r = 0; r < 4; ++r) reinterpret_cast<T*>(row[r])[j] = w2l::from_f<T>(p[r]);
  }
  __syncwarp();
  for (int j = Tn + lane; j < tail; j += 32)
#pragma unroll
    for (int r = 0; r < 4; ++r) reinterpret_cast<T*>(row[r])[j] = w2l::from_f<T>(0.f);
}

// A block: `rows` = 16, 32 or 64 query rows of one (batch, head), in slabs of
// 16; NWC warps a slab. Warp nw of a slab takes slice nw of every staged
// chunk: KW = CH / NWC keys (or rows of Pwin) in the two score products, 4
// rows in the softmax, and the column pairs nw, nw + NWC, .. of each block of
// VC columns of v in p . v.
template <typename T>
__global__ void __launch_bounds__(32 * NWC * MAX_SLABS)
mhsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ pos, const float* __restrict__ mask,
                T* __restrict__ out, int Tn, int H, int Dh, int Tp, int seed, float rate,
                unsigned thresh, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int es = sizeof(T);
  constexpr int CH = CHB / es;         // rows a staged chunk
  constexpr int KW = CH / NWC;         // of them a warp's slice
  constexpr int NT = KW / 8;           // 8-row tiles in a slice
  constexpr int kstep = 32 / es;       // keys per 32-byte step of p . v
  constexpr int PW = VC / 16 / NWC;    // column pairs of v a warp
  const int rows = blockDim.x / (2 * NWC);
  const FwdLayout L = fwd_layout(rows, Tn, Dh, es);
  char* qs = reinterpret_cast<char*>(smem) + L.q_off;
  char* stage = reinterpret_cast<char*>(smem) + L.stage_off;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slab = warp / NWC, nw = warp % NWC;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const int iw = i0 + 16 * slab;  // the slab's first query row
  const bool live = iw < Tn;      // slabs at or beyond T compute nothing
  const size_t HD = static_cast<size_t>(H) * Dh;
  const size_t head = static_cast<size_t>(b) * Tn * HD + static_cast<size_t>(h) * Dh;
  const int units = L.depth / 16, valid = Dh * es;
  float* Sw = smem + 16 * slab * L.sp;  // the slab's 16 score rows
  const uint32_t qw = smem_addr(qs + 16 * slab * L.kp);
  const float* mrow = mask + static_cast<size_t>(b) * Tn;
  // Pwin rows rlo .. rlo + T + rows - 2 meet the block's rows, wlo .. whi the slab's
  const int rlo = Tn - rows - i0;
  const int wlo = Tn - 16 - iw, whi = 2 * Tn - 2 - iw;
  const uint32_t pw = smem_addr(Sw) + (lane & 15) * L.sp * 4 + (lane >> 4) * 16;

  // One pipeline of chunks through the two staging buffers: nk chunks of k
  // (S = q . k^T + mask), np chunks of Pwin (S += the sheared q . Pwin^T),
  // then for each block of VC columns of v, nk chunks of v (out = p . v). The
  // next chunk is in flight while one is used; the softmax runs in the step
  // of the first chunk of v, ahead of its products.
  const int nk = (Tn + CH - 1) / CH, np = (Tn + rows - 1 + CH - 1) / CH;
  const int n = nk + np + (Dh + VC - 1) / VC * nk;
  auto load = [&](int c, char* buf) {
    if (c < nk) {
      load_rows_async(buf, L.kp, CH, units, k + head, HD, c * CH, 0, Tn, valid);
    } else if (c < nk + np) {
      load_rows_async(buf, L.kp, CH, units, pos, static_cast<size_t>(Dh), rlo + (c - nk) * CH,
                      0, 2 * Tn - 1, valid);
    } else {
      const int cb = (c - nk - np) / nk * VC, cv = (c - nk - np) % nk;
      const int wdt = Dh - cb < VC ? Dh - cb : VC;
      load_rows_async(buf, VP * es, CH, VC * es / 16, v + head + cb, HD, cv * CH, 0, Tn,
                      wdt * es);
    }
  };
  float o[2 * PW][4], oe[2 * PW][4];  // p . v: the main and (fp32) the small-term sums
  load_rows_async(qs, L.kp, rows, units, q + head, HD, i0, 0, Tn, valid);
  load(0, stage);
  cp_async_commit();
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) load(c + 1, stage + ((c + 1) & 1) * L.stage);
    cp_async_commit();  // one group a chunk, the last one empty
    cp_async_wait<1>();  // chunk c has arrived
    __syncthreads();
    const char* buf = stage + (c & 1) * L.stage;
    if (c < nk) {
      if (live) {
        const int j0 = c * CH + nw * KW + 2 * t;  // + nt * 8 + (e & 1)
        float mk[NT][2];  // the key mask, read ahead of the products
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int j = j0 + nt * 8 + x;
            mk[nt][x] = j < Tn ? mrow[j] : 0.f;
          }
        float acc[NT][4];
        tile_dots<T, NT>(acc, qw, smem_addr(buf) + nw * KW * L.kp, L.kp, L.depth);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = g + (e >> 1) * 8, j = j0 + nt * 8 + (e & 1);
            if (j < Tn) Sw[il * L.sp + j] = acc[nt][e] + mk[nt][e & 1];
          }
      }
    } else if (c < nk + np) {
      const int rc = rlo + (c - nk) * CH + nw * KW;  // this warp's first row of Pwin
      if (live && rc + KW - 1 >= wlo && rc <= whi) {
        float acc[NT][4];
        tile_dots<T, NT>(acc, qw, smem_addr(buf) + nw * KW * L.kp, L.kp, L.depth);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = g + (e >> 1) * 8;
            const int j = rc + nt * 8 + 2 * t + (e & 1) - (Tn - 1) + iw + il;
            if (j >= 0 && j < Tn) Sw[il * L.sp + j] += acc[nt][e];
          }
      }
    } else {
      const int cv = (c - nk - np) % nk, cb = (c - nk - np) / nk * VC;
      const int wdt = Dh - cb < VC ? Dh - cb : VC;
      if (c == nk + np) {  // p, once S is whole; every warp of the slab reads it
        if (live)
          softmax4<T>(Sw + 4 * nw * L.sp, L.sp, Tn, iw + 4 * nw, (Tn + kstep - 1) / kstep * kstep,
                      make_dropout(seed, b * H + h, Tp, thresh, scale, rate));
        __syncthreads();
      }
      if (cv == 0) {
#pragma unroll
        for (int nt = 0; nt < 2 * PW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nt][e] = oe[nt][e] = 0.f;
      }
      if (live) {
        const T* vs = reinterpret_cast<const T*>(buf);
#pragma unroll
        for (int ks = 0; ks < CH; ks += kstep) {
          const int key0 = cv * CH + ks;
          if (key0 >= Tn) break;
          uint32_t r[4];
          ldsm_x4(r, pw + key0 * es);
          const AFrag<T> af(r);
#pragma unroll
          for (int pp = 0; pp < PW; ++pp) {
            const int c0 = (nw + pp * NWC) * 16;  // the pair's first column in the block
            if (c0 >= wdt) continue;
            uint32_t bv[4];
            load_v(bv, vs, ks, c0, lane);
            af.mma(o[2 * pp], oe[2 * pp], bv[0], bv[1]);
            if (c0 + 8 < wdt) af.mma(o[2 * pp + 1], oe[2 * pp + 1], bv[2], bv[3]);
          }
        }
        if (cv == nk - 1) {
#pragma unroll
          for (int nt = 0; nt < 2 * PW; ++nt) {
            const int cl = (nw + (nt >> 1) * NWC) * 16 + (nt & 1) * 8;  // in the block
            if (cl >= wdt) continue;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int i = iw + g + 8 * hf;
              if (i < Tn)
                store2(out + head + static_cast<size_t>(i) * HD + cb + cl + 2 * t,
                       o[nt][2 * hf] + oe[nt][2 * hf], o[nt][2 * hf + 1] + oe[nt][2 * hf + 1]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K4b, launch 1: per query tile, pd and ds to scratch, and dq
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ pos, const float* __restrict__ mask,
                     const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ pd_out,
                     T* __restrict__ ds_out, int Tn, int H, int Dh, int Tp, int seed,
                     float rate, unsigned thresh, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [R, Dh]
  float* gs = qs + R * Dh;     // [R, Dh]
  float* S = gs + R * Dh;      // [R, T]: p, then ds
  float* DP = S + R * Tn;      // [R, T]: dpd, then dp
  const int i0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const size_t HD = static_cast<size_t>(H) * Dh;
  load_tile(qs, q, b, h, i0, Tn, H, Dh);
  load_tile(gs, g, b, h, i0, Tn, H, Dh);
  __syncthreads();
  tile_probs(S, qs, k, pos, mask, b, h, i0, Tn, H, Dh);
  const T* kb = k + static_cast<size_t>(b) * Tn * HD + h * Dh;
  row_dots(gs, Dh, v + static_cast<size_t>(b) * Tn * HD + h * Dh, HD, Tn,
           [&](int j, const float* acc) {
#pragma unroll
             for (int il = 0; il < R; ++il) DP[il * Tn + j] = acc[il];
           });
  __syncthreads();
  const Dropout drop = make_dropout(seed, b * H + h, Tp, thresh, scale, rate);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int il = warp; il < R; il += THREADS / 32) {
    const int i = i0 + il;
    float* prow = S + il * Tn;
    float* drow = DP + il * Tn;
    const size_t srow = ((static_cast<size_t>(b) * H + h) * Tn + i) * Tn;
    float dot = 0.f;
    for (int j = lane; j < Tn; j += 32) {
      const float p = prow[j];
      float dp = drow[j], pd = p;
      if (drop.on) {
        const bool kp = drop.keep(i, j);
        dp = kp ? dp * drop.scale : 0.f;
        pd = kp ? p * drop.scale : 0.f;
      }
      drow[j] = dp;
      dot = fmaf(dp, p, dot);
      if (i < Tn) pd_out[srow + j] = w2l::from_f<T>(pd);
    }
    dot = warp_sum(dot);
    for (int j = lane; j < Tn; j += 32) {
      const T ds = w2l::from_f<T>(prow[j] * (drow[j] - dot));
      prow[j] = w2l::to_f(ds);
      if (i < Tn) ds_out[srow + j] = ds;
    }
  }
  __syncthreads();
  // dq_i = sum_j ds[i, j] k_j + sum_r ds[i, r - (T-1) + i] Pwin[r], one sum
  const int half = Dh / 2;
  const int r0 = Tn - i0 - R;
  const int rlo = r0 > 0 ? r0 : 0;
  const int nr = r0 + Tn + R - 1 - rlo;
  for (int item = threadIdx.x; item < (R / RG) * half; item += THREADS) {
    const int gq = item / half, dp = item - gq * half;
    float a0[RG], a1[RG];
#pragma unroll
    for (int ii = 0; ii < RG; ++ii) a0[ii] = a1[ii] = 0.f;
    const float* Sg = S + gq * RG * Tn;
    accum_rows(kb, HD, Tn, dp, [&](int ii, int n) { return Sg[ii * Tn + n]; }, a0, a1);
    const int jbase = rlo - (Tn - 1) + i0 + gq * RG;
    accum_rows(pos + static_cast<size_t>(rlo) * Dh, static_cast<size_t>(Dh), nr, dp,
               [&](int ii, int n) {
                 const int j = jbase + n + ii;
                 return (j >= 0 && j < Tn) ? Sg[ii * Tn + j] : 0.f;
               },
               a0, a1);
#pragma unroll
    for (int ii = 0; ii < RG; ++ii) {
      const int i = i0 + gq * RG + ii;
      if (i < Tn)
        store2(dq + (static_cast<size_t>(b) * Tn + i) * HD + h * Dh + 2 * dp, a0[ii], a1[ii]);
    }
  }
}

// out[c0 + cl, :] = sum over rows i < T of w[i, col(i, cl)] * x[b, i, head h],
// for the R outputs cl of this block; w is one (T, T) slice of scratch and
// col(i, cl) the column of it that output cl reads in row i (negative or >= T:
// nothing). Steps of IC rows of w are staged in shared memory.
template <typename T, typename Col>
__device__ __forceinline__ void column_sums(const T* w, const T* xb, size_t HD, int Tn, int Dh,
                                            float* stage, Col col, float* a0, float* a1,
                                            int g, int dp, bool active) {
  for (int ic0 = 0; ic0 < Tn; ic0 += IC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < IC * R; idx += THREADS) {
      const int ii = idx / R, cl = idx - ii * R;
      const int i = ic0 + ii;
      const int j = col(i, cl);
      stage[idx] = (i < Tn && j >= 0 && j < Tn)
                       ? w2l::to_f(w[static_cast<size_t>(i) * Tn + j]) : 0.f;
    }
    __syncthreads();
    if (active) {
      const int n = Tn - ic0 < IC ? Tn - ic0 : IC;
      const float* sg = stage + g * RG;
      accum_rows(xb + static_cast<size_t>(ic0) * HD, HD, n, dp,
                 [&](int ii, int nn) { return sg[nn * R + ii]; }, a0, a1);
    }
  }
}

// ---------------------------------------------------------------------------
// K4b, launch 2: per tile of R keys, dv = pd^T g and dk = ds^T q
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ g,
                     const T* __restrict__ pd, const T* __restrict__ ds,
                     T* __restrict__ dk, T* __restrict__ dv, int Tn, int H, int Dh) {
  __shared__ float stage[IC * R];
  const int j0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const size_t HD = static_cast<size_t>(H) * Dh;
  const size_t slice = (static_cast<size_t>(b) * H + h) * Tn * Tn;
  const int half = Dh / 2;
  const bool active = threadIdx.x < (R / RG) * half;
  const int gk = threadIdx.x / half, dp = threadIdx.x - gk * half;
  const size_t head = static_cast<size_t>(b) * Tn * HD + h * Dh;
  auto col = [&](int, int cl) { return j0 + cl; };
  for (int which = 0; which < 2; ++which) {
    float a0[RG], a1[RG];
#pragma unroll
    for (int ii = 0; ii < RG; ++ii) a0[ii] = a1[ii] = 0.f;
    column_sums((which == 0 ? pd : ds) + slice, (which == 0 ? g : q) + head, HD, Tn, Dh,
                stage, col, a0, a1, gk, dp, active);
    if (active) {
      T* dst = which == 0 ? dv : dk;
#pragma unroll
      for (int ii = 0; ii < RG; ++ii) {
        const int j = j0 + gk * RG + ii;
        if (j < Tn) store2(dst + head + static_cast<size_t>(j) * HD + 2 * dp, a0[ii], a1[ii]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4b, launch 3: per tile of R rows of Pwin, this (b, h)'s share of dPwin
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_pos_kernel(const T* __restrict__ q, const T* __restrict__ ds,
                    float* __restrict__ part, int Tn, int H, int Dh) {
  __shared__ float stage[IC * R];
  const int r0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const size_t HD = static_cast<size_t>(H) * Dh;
  const int W = 2 * Tn - 1;
  const size_t slice = (static_cast<size_t>(b) * H + h) * Tn * Tn;
  const int half = Dh / 2;
  const bool active = threadIdx.x < (R / RG) * half;
  const int gr = threadIdx.x / half, dp = threadIdx.x - gr * half;
  float a0[RG], a1[RG];
#pragma unroll
  for (int ii = 0; ii < RG; ++ii) a0[ii] = a1[ii] = 0.f;
  // row r of Pwin met ds[i, j] where j - i + T - 1 = r
  auto col = [&](int i, int cl) { return r0 + cl < W ? r0 + cl + i - (Tn - 1) : -1; };
  column_sums(ds + slice, q + static_cast<size_t>(b) * Tn * HD + h * Dh, HD, Tn, Dh, stage,
              col, a0, a1, gr, dp, active);
  if (active) {
    float* dst = part + (static_cast<size_t>(b) * H + h) * W * Dh;
#pragma unroll
    for (int ii = 0; ii < RG; ++ii) {
      const int r = r0 + gr * RG + ii;
      if (r < W) store2(dst + static_cast<size_t>(r) * Dh + 2 * dp, a0[ii], a1[ii]);
    }
  }
}

// K4b, launch 4: dPwin = the (b, h) shares summed in order.
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_pos_sum_kernel(const float* __restrict__ part, float* __restrict__ dpos, int n,
                        int BH) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int p = 0; p < BH; ++p) s += part[static_cast<size_t>(p) * n + idx];
  dpos[idx] = s;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* pos, const void* mask,
               void* out, int B, int Tn, int H, int Dh, int Tp, int seed, float rate,
               unsigned thresh, float scale, int rows, cudaStream_t stream) {
  if (rows != 16 && rows != 32 && rows != 64) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_layout(rows, Tn, Dh, sizeof(T)).bytes;
  w2l::allow_smem(mhsa_fwd_kernel<T>, smem);
  const dim3 grid((Tn + rows - 1) / rows, H, B);
  mhsa_fwd_kernel<T><<<grid, 2 * NWC * rows, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(pos), static_cast<const float*>(mask), static_cast<T*>(out), Tn, H,
      Dh, Tp, seed, rate, thresh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* pos, const void* mask,
               const void* g, void* dq, void* dk, void* dv, void* dpos, void* pd, void* ds,
               void* part, int B, int Tn, int H, int Dh, int Tp, int seed, float rate,
               unsigned thresh, float scale, cudaStream_t stream) {
  const size_t smem =
      2 * (static_cast<size_t>(R) * Dh + static_cast<size_t>(R) * Tn) * sizeof(float);
  w2l::allow_smem(mhsa_bwd_rows_kernel<T>, smem);
  const dim3 grid((Tn + R - 1) / R, H, B);
  mhsa_bwd_rows_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(pos), static_cast<const float*>(mask), static_cast<const T*>(g),
      static_cast<T*>(dq), static_cast<T*>(pd), static_cast<T*>(ds), Tn, H, Dh, Tp, seed, rate,
      thresh, scale);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  mhsa_bwd_keys_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(g), static_cast<const T*>(pd),
      static_cast<const T*>(ds), static_cast<T*>(dk), static_cast<T*>(dv), Tn, H, Dh);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int W = 2 * Tn - 1;
  const dim3 pgrid((W + R - 1) / R, H, B);
  mhsa_bwd_pos_kernel<T><<<pgrid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ds), static_cast<float*>(part), Tn, H, Dh);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int n = W * Dh;
  mhsa_bwd_pos_sum_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dpos), n, B * H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest head width the backward's one-item-per-thread launches take.
extern "C" int w2l_mhsa_max_head_dim() { return 2 * THREADS / (R / RG); }

// Dynamic shared memory of K4 at `rows` query rows a block, and of K4b's
// first launch.
extern "C" int w2l_mhsa_fwd_smem_bytes(int rows, int Tn, int Dh, int dtype) {
  return static_cast<int>(fwd_layout(rows, Tn, Dh, dtype == w2l::kBFloat16 ? 2 : 4).bytes);
}
extern "C" int w2l_mhsa_bwd_smem_bytes(int Tn, int Dh) {
  return static_cast<int>(2 * (R * Dh + R * Tn) * sizeof(float));
}

// q, k, v, out (B, T, H*Dh) and pos (2T-1, Dh) of one dtype; mask (B, T)
// float32, added to the scores over keys. Dh a multiple of 8; rows, the query
// rows a block, 16, 32 or 64.
extern "C" int w2l_mhsa_fwd(const void* q, const void* k, const void* v, const void* pos,
                            const void* mask, void* out, int dtype, int B, int Tn, int H,
                            int Dh, int Tp, int seed, float rate, unsigned thresh,
                            float scale, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == w2l::kFloat32)
    return launch_fwd<float>(q, k, v, pos, mask, out, B, Tn, H, Dh, Tp, seed, rate, thresh,
                             scale, rows, s);
  if (dtype == w2l::kBFloat16)
    return launch_fwd<__nv_bfloat16>(q, k, v, pos, mask, out, B, Tn, H, Dh, Tp, seed, rate,
                                     thresh, scale, rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As the forward, plus g, dq, dk, dv (B, T, H*Dh) of the same dtype; dpos
// (2T-1, Dh) float32; scratch pd, ds (B, H, T, T) of the dtype and part
// (B*H, 2T-1, Dh) float32. Dh a multiple of 8, at most w2l_mhsa_max_head_dim().
extern "C" int w2l_mhsa_bwd(const void* q, const void* k, const void* v, const void* pos,
                            const void* mask, const void* g, void* dq, void* dk, void* dv,
                            void* dpos, void* pd, void* ds, void* part, int dtype, int B,
                            int Tn, int H, int Dh, int Tp, int seed, float rate,
                            unsigned thresh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == w2l::kFloat32)
    return launch_bwd<float>(q, k, v, pos, mask, g, dq, dk, dv, dpos, pd, ds, part, B, Tn, H,
                             Dh, Tp, seed, rate, thresh, scale, s);
  if (dtype == w2l::kBFloat16)
    return launch_bwd<__nv_bfloat16>(q, k, v, pos, mask, g, dq, dk, dv, dpos, pd, ds, part, B,
                                     Tn, H, Dh, Tp, seed, rate, thresh, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
