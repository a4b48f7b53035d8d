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
// tensor cores) operations at any T the recipes use. K4b does 16 B H T^2 Dh
// operations on ~14 B T H Dh bytes: the same picture, 1.1 T per byte.
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
// K4b's design: four launches, every product on the same mma.sync tiles as
// K4's (chunk_product, tile_dots), every sum with one owner and a fixed order,
// no atomics: equal inputs give equal bits. Outputs are formed a block of
// 64, 128 or 192 columns at a time (PW column pairs a warp, by Dh), so a head
// of up to 192 streams its inputs once.
// (1) Per tile of 16, 32, 48 or 64 query rows, K4's block and layout: the score phase as K4's
// (ScorePhase), p kept in fp32 and pd, rounded, written to a (B, H, T, T8)
// scratch (T8 = T rounded up to 8, the columns past T zeros, so every row of
// it starts 16-byte aligned for cp.async); then g takes q's place in shared
// memory and v streams through twice as K4's k does: dpd = g . v^T forms, per
// fragment, the partial sums of D = sum_j dp p (the warps' shares of a row
// meet in 4 spare floats past its scores), and on the second pass ds =
// p (dp - D), rounded to the working type, in place of p; ds goes to a second
// scratch and, rounded, over the row's leading bytes as K4's p does; then the
// score phase's chunks of k and Pwin stream again for dq = ds . k + dqp . Pwin,
// as K4's p . v with those rows as B, and the A operand of dqp . Pwin gathered
// from ds along the shear (dqp[i, r] = ds[i, r - (T-1) + i]). (2) Per tile of
// keys: dv = pd^T . g and dk = ds^T . q, the scratch tile staged by cp.async
// and transposed by ldmatrix.trans (bf16) or read as the fp32 fragment wants
// it. (3) Per tile of 64 rows of Pwin, block of columns and group of (b, h):
// dqp^T . q, summed over the group's (b, h) in order inside the block; an
// aligned window of ds staged a chunk of query rows at a time and the A
// operand gathered along its diagonals. (4) dPwin = the groups' shares summed
// in order. The only limit on T and Dh is launch 1's shared memory, which is
// K4's.
#include "common.cuh"
#include "mma.cuh"

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;  // threads a block of launch 4

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

using w2l::AFrag;  // csrc/mma.cuh: the bf16 and 3xTF32 tile products

// The registers ldmatrix.x4 would give for the A operand of one 32-byte deep
// step (see AFrag), from el(row, col), the element at row < 16 and column
// < 32 bytes' worth of the operand: for operands that are not rows of shared
// memory, such as ds along its diagonals or a transposed fp32 tile.
template <typename T, typename El>
__device__ __forceinline__ void gather_a(uint32_t (&r)[4], int lane, El el) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = g + (m & 1) * 8;
    if constexpr (sizeof(T) == 2) {
      const int col = (m >> 1) * 8 + 2 * t;
      const __nv_bfloat162 x = __halves2bfloat162(el(row, col), el(row, col + 1));
      r[m] = *reinterpret_cast<const uint32_t*>(&x);
    } else {
      r[m] = __float_as_uint(el(row, (m >> 1) * 4 + t));
    }
  }
}

// Shared memory of one K4 block of `rows` query rows, elements of es bytes:
// S, the rows x sp fp32 scores (sp = T rounded up to 8, plus 4: an odd number
// of 16-byte units, so ldmatrix of p meets no bank conflict); the q tile,
// rows x kp bytes (the depth, Dh * es rounded up to 32 bytes and filled with
// zeros, plus 16); two staging buffers, each a chunk of CHB / es rows of k or
// Pwin (kp bytes) or of v (VP elements). kernels/attention.py::fwd_smem_bytes
// is the same formula. K4b's first launch has the same layout.
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
// SM here. Rows outside [lo, hi) and units outside bytes [from, valid) of a
// row are zeros. A staged row starts `off` bytes (a multiple of 16, maybe
// negative) from its row in device memory; only bytes from the row's start
// on are read.
template <typename T>
__device__ __forceinline__ void load_rows_async(char* dst, int pitch, int n, int units,
                                                const T* base, size_t stride, int first, int lo,
                                                int hi, int valid, int from = 0, int off = 0) {
  const int nt = blockDim.x, sr = nt / units, su = nt - sr * units;
  int row = threadIdx.x / units, u = threadIdx.x - row * units;
  for (int idx = threadIdx.x; idx < n * units; idx += nt) {
    const int r = first + row;
    const bool ok = r >= lo && r < hi && u * 16 >= from && u * 16 < valid;
    const char* src = ok ? reinterpret_cast<const char*>(base + static_cast<size_t>(r) * stride) +
                               off + u * 16
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

// The B fragments of two 8-column tiles (columns n0.., n0+8..) of a staged
// chunk of v (rows = keys, vp elements a row), keys ks.. of one 32-byte step;
// the second tile only where `two` (a row may end after the first).
__device__ __forceinline__ void load_v(uint32_t (&bv)[4], const __nv_bfloat16* vs, int vp,
                                       int ks, int n0, bool two, int lane) {
  const int kr = ks + (lane & 7) + ((lane >> 3) & 1) * 8, col = n0 + (two ? lane >> 4 : 0) * 8;
  ldsm_x4_trans(bv, smem_addr(vs + kr * vp + col));
}
__device__ __forceinline__ void load_v(uint32_t (&bv)[4], const float* vs, int vp, int ks,
                                       int n0, bool two, int lane) {
  const float* p = vs + (ks + (lane & 3)) * vp + n0 + (lane >> 2);
  bv[0] = __float_as_uint(p[0]);
  bv[1] = __float_as_uint(p[4 * vp]);
  bv[2] = two ? __float_as_uint(p[8]) : 0u;
  bv[3] = two ? __float_as_uint(p[4 * vp + 8]) : 0u;
}

// The accumulators of one 16-row slab's share of a product with a staged
// chunk, PW column pairs a warp (a block of 16 * NWC * PW columns), the main
// and (fp32) the small-term sums. K4 takes blocks of VC columns.
template <int PW>
using Acc = float[2 * PW][4];

template <int PW>
__device__ __forceinline__ void zero_acc(Acc<PW>& o, Acc<PW>& oe) {
#pragma unroll
  for (int nt = 0; nt < 2 * PW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = oe[nt][e] = 0.f;
}

// o + oe += A . X over one staged chunk: X the chunk's rows (keys, rows of
// Pwin or query rows), vp elements a row, of which the warp takes the column
// pairs nw, nw + NWC, .. of a block of wdt <= 16 * NWC * PW columns; chunk
// row ks is row first + ks of X, and only the 32-byte deep steps that meet
// rows [lo, hi) are taken. aload(r, ks, x0) gives the A operand of the step
// at chunk row ks (x0 = first + ks) as ldsm_x4 would.
template <int PW, typename T, typename ALoad>
__device__ __forceinline__ void chunk_product(Acc<PW>& o, Acc<PW>& oe, const T* xs, int vp,
                                              int first, int lo, int hi, int wdt, int nw,
                                              int lane, ALoad aload) {
  constexpr int CH = CHB / sizeof(T), kstep = 32 / sizeof(T);
#pragma unroll
  for (int ks = 0; ks < CH; ks += kstep) {
    const int x0 = first + ks;
    if (x0 >= hi) break;
    if (x0 + kstep <= lo) continue;
    uint32_t r[4];
    aload(r, ks, x0);
    const AFrag<T> af(r);
#pragma unroll
    for (int pp = 0; pp < PW; ++pp) {
      const int c0 = (nw + pp * NWC) * 16;  // the pair's first column in the block
      if (c0 >= wdt) continue;
      const bool two = c0 + 8 < wdt;
      uint32_t bv[4];
      load_v(bv, xs, vp, ks, c0, two, lane);
      af.mma(o[2 * pp], oe[2 * pp], bv[0], bv[1]);
      if (two) af.mma(o[2 * pp + 1], oe[2 * pp + 1], bv[2], bv[3]);
    }
  }
}

// The slab's sums of chunk_product, rows i0 + g and i0 + g + 8 (those below
// n), to out (row i at out + i * stride), columns cb + the warp's pairs.
template <int PW, typename O>
__device__ __forceinline__ void store_acc(O* out, size_t stride, int i0, int n, int cb, int wdt,
                                          const Acc<PW>& o, const Acc<PW>& oe, int nw,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2 * PW; ++nt) {
    const int cl = (nw + (nt >> 1) * NWC) * 16 + (nt & 1) * 8;  // in the block
    if (cl >= wdt) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + g + 8 * hf;
      if (i < n)
        store2(out + static_cast<size_t>(i) * stride + cb + cl + 2 * t,
               o[nt][2 * hf] + oe[nt][2 * hf], o[nt][2 * hf + 1] + oe[nt][2 * hf + 1]);
    }
  }
}

// The score phase of K4 and of K4b's first launch, for the slab of 16 query
// rows (from iw) of a block of `rows` (from i0) of one (batch, head): the
// chunks c < nk of k give S = q . k^T + mask, the chunks nk .. nk + np - 1 of
// Pwin add the sheared q . Pwin^T, each fragment stored where its (row,
// column) lies. Pwin rows rlo .. rlo + T + rows - 2 meet the block's rows,
// wlo .. whi the slab's.
template <typename T>
struct ScorePhase {
  static constexpr int es = sizeof(T);
  static constexpr int CH = CHB / es;  // rows a staged chunk
  static constexpr int KW = CH / NWC;  // of them a warp's slice
  static constexpr int NT = KW / 8;    // 8-row tiles in a slice
  FwdLayout L;
  const T* k;
  const T* pos;
  const float* mrow;
  float* Sw;    // the slab's 16 score rows
  uint32_t qw;  // the slab's 16 rows of the q tile
  size_t HD, head;
  int Tn, Dh, nk, np, rlo, wlo, whi, iw, units, valid, nw, lane;
  bool live;  // slabs at or beyond T compute nothing

  __device__ __forceinline__ ScorePhase(float* smem, int rows, const T* k_, const T* pos_,
                                        const float* mask, int Tn_, int H, int Dh_, int b,
                                        int h, int i0)
      : L(fwd_layout(rows, Tn_, Dh_, es)), k(k_), pos(pos_), Tn(Tn_), Dh(Dh_) {
    const int warp = threadIdx.x >> 5, slab = warp / NWC;
    lane = threadIdx.x & 31;
    nw = warp % NWC;
    iw = i0 + 16 * slab;
    live = iw < Tn;
    HD = static_cast<size_t>(H) * Dh;
    head = static_cast<size_t>(b) * Tn * HD + static_cast<size_t>(h) * Dh;
    units = L.depth / 16;
    valid = Dh * es;
    Sw = smem + 16 * slab * L.sp;
    qw = smem_addr(reinterpret_cast<char*>(smem) + L.q_off + 16 * slab * L.kp);
    mrow = mask + static_cast<size_t>(b) * Tn;
    rlo = Tn - rows - i0;
    wlo = Tn - 16 - iw;
    whi = 2 * Tn - 2 - iw;
    nk = (Tn + CH - 1) / CH;
    np = (Tn + rows - 1 + CH - 1) / CH;
  }

  __device__ __forceinline__ void load(int c, char* buf) const {
    if (c < nk) {
      load_rows_async(buf, L.kp, CH, units, k + head, HD, c * CH, 0, Tn, valid);
    } else {
      load_rows_async(buf, L.kp, CH, units, pos, static_cast<size_t>(Dh), rlo + (c - nk) * CH,
                      0, 2 * Tn - 1, valid);
    }
  }

  __device__ __forceinline__ void step(int c, const char* buf) const {
    const int g = lane >> 2, t = lane & 3;
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
    } else {
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
    }
  }
};

// Four score rows (row r at S4 + r * sp) by one warp: exp(x - the row's max)
// in place over columns < Tn, and s[r] = 1 / the row's sum.
__device__ __forceinline__ void exp_rows4(float* S4, int sp, int Tn, float (&s)[4]) {
  const int lane = threadIdx.x & 31;
  float m[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
  }
  for (int j = lane; j < Tn; j += 32)
#pragma unroll
    for (int r = 0; r < 4; ++r) m[r] = fmaxf(m[r], S4[r * sp + j]);
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = warp_max(m[r]);
  for (int j = lane; j < Tn; j += 32)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = expf(S4[r * sp + j] - m[r]);
      S4[r * sp + j] = e;
      s[r] += e;
    }
#pragma unroll
  for (int r = 0; r < 4; ++r) s[r] = 1.f / warp_sum(s[r]);
}

// p = softmax_j of four score rows (row r at S4 + r * sp, query row i0 + r),
// by one warp, the rows interleaved; dropout (row, column j); rounded to T
// and written over the row's own leading bytes, 0 from column T to `tail`.
template <typename T>
__device__ __forceinline__ void softmax4(float* S4, int sp, int Tn, int i0, int tail,
                                         const Dropout& drop) {
  const int lane = threadIdx.x & 31;
  float* row[4];
  float s[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) row[r] = S4 + r * sp;
  exp_rows4(S4, sp, Tn, s);
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
  constexpr int kstep = 32 / es;       // keys per 32-byte step of p . v
  const int rows = blockDim.x / (2 * NWC);
  const int i0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const ScorePhase<T> sc(smem, rows, k, pos, mask, Tn, H, Dh, b, h, i0);
  const FwdLayout& L = sc.L;
  char* qs = reinterpret_cast<char*>(smem) + L.q_off;
  char* stage = reinterpret_cast<char*>(smem) + L.stage_off;
  const int lane = sc.lane, nw = sc.nw, iw = sc.iw, nk = sc.nk, np = sc.np;
  const uint32_t pw = smem_addr(sc.Sw) + (lane & 15) * L.sp * 4 + (lane >> 4) * 16;

  // One pipeline of chunks through the two staging buffers: nk chunks of k
  // (S = q . k^T + mask), np chunks of Pwin (S += the sheared q . Pwin^T),
  // then for each block of VC columns of v, nk chunks of v (out = p . v). The
  // next chunk is in flight while one is used; the softmax runs in the step
  // of the first chunk of v, ahead of its products.
  const int n = nk + np + (Dh + VC - 1) / VC * nk;
  auto load = [&](int c, char* buf) {
    if (c < nk + np) {
      sc.load(c, buf);
    } else {
      const int cb = (c - nk - np) / nk * VC, cv = (c - nk - np) % nk;
      const int wdt = Dh - cb < VC ? Dh - cb : VC;
      load_rows_async(buf, VP * es, CH, VC * es / 16, v + sc.head + cb, sc.HD, cv * CH, 0, Tn,
                      wdt * es);
    }
  };
  constexpr int PW = VC / 16 / NWC;
  Acc<PW> o, oe;  // p . v
  load_rows_async(qs, L.kp, rows, sc.units, q + sc.head, sc.HD, i0, 0, Tn, sc.valid);
  load(0, stage);
  cp_async_commit();
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) load(c + 1, stage + ((c + 1) & 1) * L.stage);
    cp_async_commit();  // one group a chunk, the last one empty
    cp_async_wait<1>();  // chunk c has arrived
    __syncthreads();
    const char* buf = stage + (c & 1) * L.stage;
    if (c < nk + np) {
      sc.step(c, buf);
    } else {
      const int cv = (c - nk - np) % nk, cb = (c - nk - np) / nk * VC;
      const int wdt = Dh - cb < VC ? Dh - cb : VC;
      if (c == nk + np) {  // p, once S is whole; every warp of the slab reads it
        if (sc.live)
          softmax4<T>(sc.Sw + 4 * nw * L.sp, L.sp, Tn, iw + 4 * nw,
                      (Tn + kstep - 1) / kstep * kstep,
                      make_dropout(seed, b * H + h, Tp, thresh, scale, rate));
        __syncthreads();
      }
      if (cv == 0) zero_acc<PW>(o, oe);
      if (sc.live) {
        chunk_product<PW>(o, oe, reinterpret_cast<const T*>(buf), VP, cv * CH, 0, Tn, wdt, nw,
                          lane, [&](uint32_t (&r)[4], int, int x0) { ldsm_x4(r, pw + x0 * es); });
        if (cv == nk - 1) store_acc<PW>(out + sc.head, sc.HD, iw, Tn, cb, wdt, o, oe, nw, lane);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K4b, launch 1: per query tile, pd and ds to scratch, and dq
// ---------------------------------------------------------------------------
// p = softmax_j of four score rows (row r at S4 + r * sp, query row i0 + r)
// by one warp, left in place in fp32; pd = p with dropout, rounded to T, to
// row i0 + r of pd (sT elements a row, columns T .. sT - 1 zeros), rows < T.
template <typename T>
__device__ __forceinline__ void probs4(float* S4, int sp, int Tn, int i0, int sT,
                                       const Dropout& drop, T* pd) {
  const int lane = threadIdx.x & 31;
  float s[4];
  exp_rows4(S4, sp, Tn, s);
  for (int j = lane; j < sT; j += 32)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float p = 0.f;
      if (j < Tn) {
        p = S4[r * sp + j] * s[r];
        S4[r * sp + j] = p;
        if (drop.on) p = drop.keep(i0 + r, j) ? p * drop.scale : 0.f;
      }
      if (i0 + r < Tn) pd[static_cast<size_t>(i0 + r) * sT + j] = w2l::from_f<T>(p);
    }
}

// Four rows of fp32 values that are already of T (row r at S4 + r * sp,
// query row i0 + r) by one warp: to row i0 + r of out (sT elements a row,
// columns T .. sT - 1 zeros), rows < T, and written as T over the row's own
// leading bytes, 0 from column T to `tail`.
template <typename T>
__device__ __forceinline__ void round_rows4(float* S4, int sp, int Tn, int i0, int tail, int sT,
                                            T* out) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < sT; j0 += 32) {
    const int j = j0 + lane;
    T x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x[r] = w2l::from_f<T>(j < Tn ? S4[r * sp + j] : 0.f);
      if (j < sT && i0 + r < Tn) out[static_cast<size_t>(i0 + r) * sT + j] = x[r];
    }
    __syncwarp();  // every lane has read its column before T's overwrite columns j0/2 ..
    if (j < Tn)
#pragma unroll
      for (int r = 0; r < 4; ++r) reinterpret_cast<T*>(S4 + r * sp)[j] = x[r];
  }
  __syncwarp();
  for (int j = Tn + lane; j < tail; j += 32)
#pragma unroll
    for (int r = 0; r < 4; ++r) reinterpret_cast<T*>(S4 + r * sp)[j] = w2l::from_f<T>(0.f);
}

// K4's block and layout. One pipeline of chunks: K4's score phase (nk chunks
// of k, np of Pwin); g's tile in q's place; two passes of nk chunks of v
// (dpd = g . v^T: first D's shares, then ds); then for each block of
// 16 * NWC * PW columns, the score phase's chunks again (dq = ds . k +
// dqp . Pwin, B read from the rows staged for q . k^T). The softmax runs in
// the first step of v, the rounding of ds in the first step of dq.
template <typename T, int PW>
__global__ void __launch_bounds__(32 * NWC * MAX_SLABS)
mhsa_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ pos, const float* __restrict__ mask,
                     const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ pd_out,
                     T* __restrict__ ds_out, int Tn, int H, int Dh, int Tp, int seed,
                     float rate, unsigned thresh, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int es = sizeof(T);
  constexpr int CH = CHB / es, KW = CH / NWC, NT = KW / 8, kstep = 32 / es;
  constexpr int CB = 16 * NWC * PW;  // columns of dq a block of them
  const int rows = blockDim.x / (2 * NWC);
  const int i0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const ScorePhase<T> sc(smem, rows, k, pos, mask, Tn, H, Dh, b, h, i0);
  const FwdLayout& L = sc.L;
  char* qs = reinterpret_cast<char*>(smem) + L.q_off;
  char* stage = reinterpret_cast<char*>(smem) + L.stage_off;
  const int lane = sc.lane, nw = sc.nw, iw = sc.iw, nk = sc.nk, np = sc.np;
  const int g = lane >> 2, t = lane & 3;
  float* Sw = sc.Sw;
  const int sT = (Tn + 7) / 8 * 8;  // the scratch's row pitch
  const size_t slice = (static_cast<size_t>(b) * H + h) * Tn * sT;
  const Dropout drop = make_dropout(seed, b * H + h, Tp, thresh, scale, rate);
  const int s1 = nk + np, s2 = s1 + nk, s3 = s2 + nk;  // first steps: pass 1, pass 2, dq
  const int n = s3 + (Dh + CB - 1) / CB * (nk + np);
  const uint32_t pw = smem_addr(Sw) + (lane & 15) * L.sp * 4 + (lane >> 4) * 16;
  const T* dsw = reinterpret_cast<const T*>(Sw);  // ds as T, L.sp * 4 / es a row
  const int rowel = L.sp * 4 / es;
  auto load = [&](int c, char* buf) {
    if (c < s1) {
      sc.load(c, buf);
    } else if (c < s3) {
      load_rows_async(buf, L.kp, CH, sc.units, v + sc.head, sc.HD, (c - s1) % nk * CH, 0, Tn,
                      sc.valid);
    } else {
      sc.load((c - s3) % (nk + np), buf);  // k and Pwin again, for dq
    }
  };
  float dsum[2] = {0.f, 0.f}, dtot[2] = {0.f, 0.f};  // D of rows g, g + 8: shares, whole
  Acc<PW> o, oe;  // dq
  load_rows_async(qs, L.kp, rows, sc.units, q + sc.head, sc.HD, i0, 0, Tn, sc.valid);
  load(0, stage);
  cp_async_commit();
  for (int c = 0; c < n; ++c) {
    if (c == s1) {  // g in q's place, which the last score step has left
      load_rows_async(qs, L.kp, rows, sc.units, dout + sc.head, sc.HD, i0, 0, Tn, sc.valid);
      cp_async_commit();
    }
    if (c + 1 < n) load(c + 1, stage + ((c + 1) & 1) * L.stage);
    cp_async_commit();  // one group a chunk, the last one empty
    cp_async_wait<1>();  // chunk c (and g) have arrived
    __syncthreads();
    const char* buf = stage + (c & 1) * L.stage;
    if (c < s1) {
      sc.step(c, buf);
    } else if (c < s3) {
      const bool pass2 = c >= s2;
      if (c == s1) {  // p, once S is whole
        if (sc.live)
          probs4<T>(Sw + 4 * nw * L.sp, L.sp, Tn, iw + 4 * nw, sT, drop, pd_out + slice);
        __syncthreads();
      }
      if (c == s2) {  // D, the four warps' shares in order
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* dsh = Sw + (g + 8 * hf) * L.sp + L.sp - 4;
          dtot[hf] = ((dsh[0] + dsh[1]) + dsh[2]) + dsh[3];
        }
      }
      if (sc.live) {
        const int j0 = (c - s1) % nk * CH + nw * KW + 2 * t;  // + nt * 8 + (e & 1)
        float acc[NT][4];
        tile_dots<T, NT>(acc, sc.qw, smem_addr(buf) + nw * KW * L.kp, L.kp, L.depth);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = g + (e >> 1) * 8, j = j0 + nt * 8 + (e & 1);
            if (j < Tn) {
              float dp = acc[nt][e];
              if (drop.on) dp = drop.keep(iw + il, j) ? dp * drop.scale : 0.f;
              float* s = Sw + il * L.sp + j;
              if (pass2)
                *s = w2l::to_f(w2l::from_f<T>(*s * (dp - dtot[e >> 1])));
              else
                dsum[e >> 1] = fmaf(dp, *s, dsum[e >> 1]);
            }
          }
        if (c == s2 - 1) {  // this warp's share of D, after its last chunk of pass 1
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float x = dsum[hf];
            x += __shfl_xor_sync(0xffffffffu, x, 1);
            x += __shfl_xor_sync(0xffffffffu, x, 2);
            if (t == 0) Sw[(g + 8 * hf) * L.sp + L.sp - 4 + nw] = x;  // past the T scores
          }
        }
      }
    } else {
      const int cc = (c - s3) % (nk + np), cb = (c - s3) / (nk + np) * CB;
      const int wdt = Dh - cb < CB ? Dh - cb : CB;
      if (c == s3) {  // ds as T: to scratch, and over the rows' leading bytes
        if (sc.live)
          round_rows4<T>(Sw + 4 * nw * L.sp, L.sp, Tn, iw + 4 * nw,
                         (Tn + kstep - 1) / kstep * kstep, sT, ds_out + slice);
        __syncthreads();
      }
      if (cc == 0) zero_acc<PW>(o, oe);
      if (sc.live) {
        const T* xs = reinterpret_cast<const T*>(buf) + cb;  // kp bytes a row
        const int vp = L.kp / es;
        if (cc < nk) {
          chunk_product<PW>(o, oe, xs, vp, cc * CH, 0, Tn, wdt, nw, lane,
                            [&](uint32_t (&r)[4], int, int x0) { ldsm_x4(r, pw + x0 * es); });
        } else {
          // dqp[il, r] = ds[il, r - (T-1) + iw + il], the rows of Pwin the slab meets
          chunk_product<PW>(o, oe, xs, vp, sc.rlo + (cc - nk) * CH, sc.wlo, sc.whi + 1, wdt, nw,
                            lane, [&](uint32_t (&r)[4], int, int x0) {
                              gather_a<T>(r, lane, [&](int il, int cl) {
                                const int j = x0 + cl - (Tn - 1) + iw + il;
                                return j >= 0 && j < Tn ? dsw[il * rowel + j]
                                                        : w2l::from_f<T>(0.f);
                              });
                            });
        }
        if (cc == nk + np - 1)
          store_acc<PW>(dq + sc.head, sc.HD, iw, Tn, cb, wdt, o, oe, nw, lane);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K4b, launch 2: per tile of keys, dv = pd^T . g and dk = ds^T . q
// ---------------------------------------------------------------------------
// One staging buffer: a tile of CHB / es query rows by `rows` keys of pd or ds
// (tp bytes a row: an odd number of 16-byte units) and the same query rows of
// g or q, cb columns (cb + 8 elements a row).
struct KeysLayout {
  int tp, stage;
  size_t bytes;
};
__host__ __device__ __forceinline__ KeysLayout keys_layout(int rows, int es, int cb) {
  KeysLayout L;
  const int ch = CHB / es;
  L.tp = rows * es + 16;
  L.stage = ch * L.tp + ch * (cb + 8) * es;
  L.bytes = 2 * static_cast<size_t>(L.stage);
  return L;
}

// The A operand of one 32-byte deep step whose rows are 16 keys (columns col0..
// of a staged tile) and whose depth is query rows ks.. of it: the tile's
// transpose, by ldmatrix.trans in bf16 and as the fp32 fragment wants it.
__device__ __forceinline__ void load_a_trans(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                             int pitch, int ks, int col0, int lane) {
  const int row = ks + (lane & 7) + ((lane >> 4) & 1) * 8, col = col0 + ((lane >> 3) & 1) * 8;
  ldsm_x4_trans(r, smem_addr(reinterpret_cast<const char*>(tile) + row * pitch) + col * 2);
}
__device__ __forceinline__ void load_a_trans(uint32_t (&r)[4], const float* tile, int pitch,
                                             int ks, int col0, int lane) {
  const int pe = pitch / 4;
  gather_a<float>(r, lane, [&](int jl, int il) { return tile[(ks + il) * pe + col0 + jl]; });
}

// Blocks of `rows` = 16, 32 or 64 keys in slabs of 16, NWC warps a slab as in
// K4; for each block of CB = 16 * NWC * PW columns, ni chunks of query rows
// for dv, then ni for dk.
template <typename T, int PW>
__global__ void __launch_bounds__(32 * NWC * MAX_SLABS)
mhsa_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ g, const T* __restrict__ pd,
                     const T* __restrict__ ds, T* __restrict__ dk, T* __restrict__ dv, int Tn,
                     int H, int Dh) {
  extern __shared__ __align__(16) float smem[];
  constexpr int es = sizeof(T), CH = CHB / es, CB = 16 * NWC * PW;
  const int rows = blockDim.x / (2 * NWC);
  const KeysLayout L = keys_layout(rows, es, CB);
  char* stage = reinterpret_cast<char*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slab = warp / NWC, nw = warp % NWC;
  const int j0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const int jw = j0 + 16 * slab;  // the slab's first key
  const size_t HD = static_cast<size_t>(H) * Dh;
  const size_t head = static_cast<size_t>(b) * Tn * HD + static_cast<size_t>(h) * Dh;
  const int sT = (Tn + 7) / 8 * 8;
  const size_t slice = (static_cast<size_t>(b) * H + h) * Tn * sT;
  const int ni = (Tn + CH - 1) / CH;
  const int n = (Dh + CB - 1) / CB * 2 * ni;
  auto load = [&](int c, char* buf) {
    const int cb = c / (2 * ni) * CB, which = c / ni & 1, ic = c % ni;
    const int wdt = Dh - cb < CB ? Dh - cb : CB;
    load_rows_async(buf, L.tp, CH, rows * es / 16, (which ? ds : pd) + slice + j0,
                    static_cast<size_t>(sT), ic * CH, 0, Tn, (sT - j0) * es);
    load_rows_async(buf + CH * L.tp, (CB + 8) * es, CH, CB * es / 16,
                    (which ? q : g) + head + cb, HD, ic * CH, 0, Tn, wdt * es);
  };
  Acc<PW> o, oe;
  load(0, stage);
  cp_async_commit();
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) load(c + 1, stage + ((c + 1) & 1) * L.stage);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const char* buf = stage + (c & 1) * L.stage;
    const int cb = c / (2 * ni) * CB, which = c / ni & 1, ic = c % ni;
    const int wdt = Dh - cb < CB ? Dh - cb : CB;
    if (ic == 0) zero_acc<PW>(o, oe);
    if (jw < Tn) {
      const T* tile = reinterpret_cast<const T*>(buf);
      chunk_product<PW>(o, oe, reinterpret_cast<const T*>(buf + CH * L.tp), CB + 8, ic * CH, 0,
                        Tn, wdt, nw, lane, [&](uint32_t (&r)[4], int ks, int) {
                          load_a_trans(r, tile, L.tp, ks, 16 * slab, lane);
                        });
      if (ic == ni - 1)
        store_acc<PW>((which ? dk : dv) + head, HD, jw, Tn, cb, wdt, o, oe, nw, lane);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K4b, launch 3: per tile of Pwin rows, columns and group of (b, h), dqp^T . q
// ---------------------------------------------------------------------------
constexpr int POS_ROWS = 64;  // rows of Pwin a block of launch 3

// One staging buffer: a window of ds, CHB / es query rows by POS_ROWS +
// CHB / es + 8 columns (wp bytes a row), and the same query rows of q, cb
// columns (cb + 8 elements a row).
struct PosLayout {
  int wp, stage;
  size_t bytes;
};
__host__ __device__ __forceinline__ PosLayout pos_layout(int es, int cb) {
  PosLayout L;
  const int ch = CHB / es;
  L.wp = (POS_ROWS + ch + 8) * es;
  L.stage = ch * L.wp + ch * (cb + 8) * es;
  L.bytes = 2 * static_cast<size_t>(L.stage);
  return L;
}

// Rows r0 .. r0 + 63 of Pwin meet ds[i, r - (T-1) + i] for query rows i in
// [ilo, ihi); for each (b, h) of the block's group in order, the chunks of
// those rows: the window of ds whose columns a chunk's diagonals cross,
// aligned down to 8 elements, and the chunk's rows of q, the block's CB =
// 16 * NWC * PW columns.
template <typename T, int PW>
__global__ void __launch_bounds__(32 * NWC * MAX_SLABS)
mhsa_bwd_pos_kernel(const T* __restrict__ q, const T* __restrict__ ds, float* __restrict__ part,
                    int B, int Tn, int H, int Dh, int groups) {
  extern __shared__ __align__(16) float smem[];
  constexpr int es = sizeof(T), CH = CHB / es, CB = 16 * NWC * PW;
  const PosLayout L = pos_layout(es, CB);
  char* stage = reinterpret_cast<char*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slab = warp / NWC, nw = warp % NWC;
  const int r0 = blockIdx.x * POS_ROWS, cb = blockIdx.y * CB, grp = blockIdx.z;
  const int W = 2 * Tn - 1, BH = B * H;
  const int rw = r0 + 16 * slab;  // the slab's first row of Pwin
  const int wdt = Dh - cb < CB ? Dh - cb : CB;
  const size_t HD = static_cast<size_t>(H) * Dh;
  const int sT = (Tn + 7) / 8 * 8;
  const int bh0 = grp * BH / groups, bh1 = (grp + 1) * BH / groups;
  const int ilo = Tn - r0 - POS_ROWS > 0 ? Tn - r0 - POS_ROWS : 0;
  const int ihi = 2 * Tn - 1 - r0 < Tn ? 2 * Tn - 1 - r0 : Tn;
  const int ni = (ihi - ilo + CH - 1) / CH;
  const int n = (bh1 - bh0) * ni;
  const int we = L.wp / es;  // elements a window row
  // the window's first column for the chunk from query row i0
  auto wbase = [&](int i0) { return (r0 - (Tn - 1) + i0) & ~7; };
  auto load = [&](int c, char* buf) {
    const int bh = bh0 + c / ni, i0 = ilo + c % ni * CH;
    const int c0 = wbase(i0);
    load_rows_async(buf, L.wp, CH, L.wp / 16, ds + static_cast<size_t>(bh) * Tn * sT,
                    static_cast<size_t>(sT), i0, 0, Tn, (sT - c0) * es, c0 < 0 ? -c0 * es : 0,
                    c0 * es);
    load_rows_async(buf + CH * L.wp, (CB + 8) * es, CH, CB * es / 16,
                    q + static_cast<size_t>(bh / H) * Tn * HD + static_cast<size_t>(bh % H) * Dh +
                        cb,
                    HD, i0, 0, Tn, wdt * es);
  };
  Acc<PW> o, oe;
  zero_acc<PW>(o, oe);
  load(0, stage);
  cp_async_commit();
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) load(c + 1, stage + ((c + 1) & 1) * L.stage);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const char* buf = stage + (c & 1) * L.stage;
    if (rw < W) {
      const int i0 = ilo + c % ni * CH;
      const int off = r0 - (Tn - 1) + i0 - wbase(i0) + 16 * slab;  // window column of (rw, i0)
      const T* win = reinterpret_cast<const T*>(buf);
      chunk_product<PW>(o, oe, reinterpret_cast<const T*>(buf + CH * L.wp), CB + 8, i0, 0, Tn,
                        wdt, nw, lane, [&](uint32_t (&r)[4], int ks, int) {
                          gather_a<T>(r, lane, [&](int rl, int il) {
                            return win[(ks + il) * we + off + rl + ks + il];
                          });
                        });
    }
    __syncthreads();
  }
  if (rw < W)
    store_acc<PW>(part + static_cast<size_t>(grp) * W * Dh, static_cast<size_t>(Dh), rw, W, cb, wdt,
              o, oe, nw, lane);
}

// K4b, launch 4: dPwin = the groups' shares summed in order.
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_pos_sum_kernel(const float* __restrict__ part, float* __restrict__ dpos, int n,
                        int groups) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int p = 0; p < groups; ++p) s += part[static_cast<size_t>(p) * n + idx];
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

// The tile height of launch 2: the fewest keys a block (16, 32, 48) whose
// blocks fit one a SM, else 64 (each block streams its head's q and g once).
int keys_rows(int B, int Tn, int H, int sms) {
  for (int r = 16; r < 64; r += 16)
    if (static_cast<long long>((Tn + r - 1) / r) * H * B <= sms) return r;
  return 64;
}

// Column pairs a warp of K4b: one block of columns up to Dh = 192.
int bwd_pw(int Dh) { return Dh > 128 ? 3 : Dh > 64 ? 2 : 1; }

// Groups of (b, h) in launch 3: enough blocks for two waves, at most B * H.
int pos_groups(int B, int Tn, int H, int Dh, int sms) {
  const int cb = 16 * NWC * bwd_pw(Dh);
  const int blocks = (2 * Tn - 1 + POS_ROWS - 1) / POS_ROWS * ((Dh + cb - 1) / cb);
  const int want = (2 * sms + blocks - 1) / blocks;
  return want < B * H ? want : B * H;
}

template <typename T, int PW>
int launch_bwd_pw(const void* q, const void* k, const void* v, const void* pos, const void* mask,
               const void* g, void* dq, void* dk, void* dv, void* dpos, void* pd, void* ds,
               void* part, int B, int Tn, int H, int Dh, int Tp, int seed, float rate,
               unsigned thresh, float scale, int rows, int sms, cudaStream_t stream) {
  constexpr int es = sizeof(T), CB = 16 * NWC * PW;
  const size_t smem = fwd_layout(rows, Tn, Dh, es).bytes;
  w2l::allow_smem(mhsa_bwd_rows_kernel<T, PW>, smem);
  mhsa_bwd_rows_kernel<T, PW>
      <<<dim3((Tn + rows - 1) / rows, H, B), 2 * NWC * rows, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(pos), static_cast<const float*>(mask), static_cast<const T*>(g),
          static_cast<T*>(dq), static_cast<T*>(pd), static_cast<T*>(ds), Tn, H, Dh, Tp, seed,
          rate, thresh, scale);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int kr = keys_rows(B, Tn, H, sms);
  const size_t ksmem = keys_layout(kr, es, CB).bytes;
  w2l::allow_smem(mhsa_bwd_keys_kernel<T, PW>, ksmem);
  mhsa_bwd_keys_kernel<T, PW><<<dim3((Tn + kr - 1) / kr, H, B), 2 * NWC * kr, ksmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(g), static_cast<const T*>(pd),
      static_cast<const T*>(ds), static_cast<T*>(dk), static_cast<T*>(dv), Tn, H, Dh);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int W = 2 * Tn - 1, groups = pos_groups(B, Tn, H, Dh, sms);
  const size_t psmem = pos_layout(es, CB).bytes;
  w2l::allow_smem(mhsa_bwd_pos_kernel<T, PW>, psmem);
  const dim3 pgrid((W + POS_ROWS - 1) / POS_ROWS, (Dh + CB - 1) / CB, groups);
  mhsa_bwd_pos_kernel<T, PW><<<pgrid, 2 * NWC * POS_ROWS, psmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ds), static_cast<float*>(part), B, Tn, H,
      Dh, groups);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int n = W * Dh;
  mhsa_bwd_pos_sum_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dpos), n, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* pos, const void* mask,
               const void* g, void* dq, void* dk, void* dv, void* dpos, void* pd, void* ds,
               void* part, int B, int Tn, int H, int Dh, int Tp, int seed, float rate,
               unsigned thresh, float scale, int rows, int sms, cudaStream_t stream) {
  if (rows % 16 || rows < 16 || rows > 16 * MAX_SLABS)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bwd_pw(Dh)) {
    case 1:
      return launch_bwd_pw<T, 1>(q, k, v, pos, mask, g, dq, dk, dv, dpos, pd, ds, part, B, Tn, H,
                              Dh, Tp, seed, rate, thresh, scale, rows, sms, stream);
    case 2:
      return launch_bwd_pw<T, 2>(q, k, v, pos, mask, g, dq, dk, dv, dpos, pd, ds, part, B, Tn, H,
                              Dh, Tp, seed, rate, thresh, scale, rows, sms, stream);
    default:
      return launch_bwd_pw<T, 3>(q, k, v, pos, mask, g, dq, dk, dv, dpos, pd, ds, part, B, Tn, H,
                              Dh, Tp, seed, rate, thresh, scale, rows, sms, stream);
  }
}

size_t bwd_smem_bytes(int rows, int Tn, int Dh, int es) {
  const int cb = 16 * NWC * bwd_pw(Dh);
  const size_t a = fwd_layout(rows, Tn, Dh, es).bytes, b = keys_layout(64, es, cb).bytes,
               c = pos_layout(es, cb).bytes;
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

}  // namespace

// Dynamic shared memory of K4 at `rows` query rows a block; of K4b at `rows`
// query rows in its first launch, the largest of its three launches (the
// second at its tallest tile).
extern "C" int w2l_mhsa_fwd_smem_bytes(int rows, int Tn, int Dh, int dtype) {
  return static_cast<int>(fwd_layout(rows, Tn, Dh, dtype == w2l::kBFloat16 ? 2 : 4).bytes);
}
extern "C" int w2l_mhsa_bwd_smem_bytes(int rows, int Tn, int Dh, int dtype) {
  return static_cast<int>(bwd_smem_bytes(rows, Tn, Dh, dtype == w2l::kBFloat16 ? 2 : 4));
}

// The widest head K4b takes at all: the largest multiple of 8 whose layout
// fits a block at T = 1 and 16 query rows.
extern "C" int w2l_mhsa_max_head_dim(int dtype, int max_smem) {
  const int es = dtype == w2l::kBFloat16 ? 2 : 4;
  int Dh = 0;
  while (bwd_smem_bytes(16, 1, Dh + 8, es) <= static_cast<size_t>(max_smem)) Dh += 8;
  return Dh;
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
// (2T-1, Dh) float32; scratch pd, ds (B, H, T, T rounded up to 8) of the dtype
// and part (B*H, 2T-1, Dh) float32; rows, the query rows a block of the first
// launch (16, 32, 48 or 64); sms, the card's SMs, which set the other launches'
// tiles.
extern "C" int w2l_mhsa_bwd(const void* q, const void* k, const void* v, const void* pos,
                            const void* mask, const void* g, void* dq, void* dk, void* dv,
                            void* dpos, void* pd, void* ds, void* part, int dtype, int B,
                            int Tn, int H, int Dh, int Tp, int seed, float rate,
                            unsigned thresh, float scale, int rows, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == w2l::kFloat32)
    return launch_bwd<float>(q, k, v, pos, mask, g, dq, dk, dv, dpos, pd, ds, part, B, Tn, H,
                             Dh, Tp, seed, rate, thresh, scale, rows, sms, s);
  if (dtype == w2l::kBFloat16)
    return launch_bwd<__nv_bfloat16>(q, k, v, pos, mask, g, dq, dk, dv, dpos, pd, ds, part, B,
                                     Tn, H, Dh, Tp, seed, rate, thresh, scale, rows, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
