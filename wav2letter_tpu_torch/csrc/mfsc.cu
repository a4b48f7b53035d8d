// K1: fused MFSC core — framing, windowed |DFT|, mel projection, log.
//
// Replaces the TPU kernel wav2letter_tpu/ops/pallas/mel.py::pallas_mfsc
// (_mel_kernel), whose oracle is features/frontend.py::Featurizer.__call__:
//   re = frames @ cos, im = frames @ sin   (Hamming window folded in)
//   mag = sqrt(max(re^2 + im^2, 1e-20))
//   out = log(max(mag @ mel_fb, mel_floor))
// Unlike the TPU kernel, this one frames inside the kernel: it reads the
// pre-emphasized audio (B, S) and frame t starts at sample t * stride, so the
// (B, T, frame) tensor of overlapping frames never exists in device memory.
//
// Bound on the H100: bytes. At the flagship shapes (frame 400, n_fft 512,
// 257 bins, 80 mels) the function needs per frame a real FFT of 512 points
// (~11.5 kFLOP), the 257 magnitudes and ~2 multiply-adds per bin for the
// triangular filterbank: ~13 kFLOP, against ~1 kB moved (160 new audio
// samples in, 80 floats out), ~13 FLOP per byte, under the ~20 FLOP per byte
// at which the CUDA cores' fp32 rate (67 TFLOP/s) would take over from the
// 3.35 TB/s of HBM. Like the TPU kernel, this one keeps the caller's dense
// matrices: it computes the DFT and the mel projection as dense products
// (~1.3 MFLOP per frame in 3xTF32, ~100x what the function needs), so its own
// arithmetic limits it. An FFT and a sparse filterbank would reach the bytes
// bound but ignore the caller's cos, sin and filterbank.
//
// Two routes, picked by kernels/mfsc.py::route (C twin w2l_mfsc_tc_takes).
//
// Tensor cores (mfsc_tc_kernel; stride a multiple of 8, n_bins <= 320, cos
// and sin 16-byte aligned). One block of 8 warps per (batch row, tile of TT =
// 16, 32 or 48 frames; kernels/mfsc.py::tile_frames picks the tile that
// leaves the busiest SM the least work). The block stages its audio span
// once by cp.async as rows of `stride` samples at a pitch of an odd number
// of 16-byte units (164 floats for stride 160): frame t, sample j is row
// t + j / stride, column j % stride, so a tile of 16 frames, 8 samples deep,
// is 16 rows of shared memory that ldmatrix reads without bank conflicts (an
// 8-deep step never crosses a row since stride % 8 == 0). The DFT is one
// product, M = frames, N = cos | sin (bins padded to a multiple of 8), K =
// frame samples, as mma.sync m16n8k8 TF32 in three passes (csrc/mma.cuh:
// small.big + big.small + big.big, fp32 sums), so it keeps fp32's digits.
// The cos and sin rows stream 8 rows a chunk by 16-byte cp.async through
// four buffers (three chunks in flight while one is used). Their rows of
// n_bins floats start wherever 16-byte units fall (257 floats a row): each
// staged row keeps the 16-byte alignment of its source, so a lane reads bin
// n of row j at j * 2 * pb + (j * n_bins) % 4 + n, with pb = 4 (mod 16) so
// that a B fragment's 32 reads meet at most 2-way bank conflicts. Every
// block streams all of cos and sin (845 KB at the flagship's shapes) from
// L2, and L2's bandwidth limits those copies (kernels/trace_k1.py), so a
// larger tile streams fewer bytes a frame. Warp w owns the bin tiles w,
// w + 8, ...: the re and im tiles of one bin lie in the same thread's
// fragments, so the magnitude forms in registers and goes to shared memory,
// 0 in the pad bins. The mel product is a second 3xTF32 tile product from
// there (K = bins padded to 8, N = n_mels), its B fragments read from mel_fb
// through the read-only cache; then log(max(., mel_floor)) and the stores.
//
// CUDA cores (mfsc_cc_kernel; any stride, n_bins <= 288): one block per
// (batch row, 32 frames), the audio span in shared memory, the cos/sin rows
// streaming through it 8 at a time; each thread keeps 4 frames x 9 bins of
// fp32 sums; the magnitudes then go to shared memory for the mel product.
#include "common.cuh"
#include "mma.cuh"
#include "tc_tile.cuh"

namespace {

using w2l::AFrag;
using w2l::BFragTF32;
using w2l::tc::cp_async;
using w2l::tc::cp_async_commit;
using w2l::tc::cp_async_wait;
using w2l::tc::ldsm_x4;
using w2l::tc::smem_addr;

// ---------------------------------------------------------------------------
// tensor cores
// ---------------------------------------------------------------------------
constexpr int TC_THREADS = 256;
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int NTW = 5;   // bin tiles a warp at most: 8 * 8 * 5 = 320 bins
constexpr int KC = 8;    // cos/sin rows a chunk: one 8-deep step
constexpr int NBUF = 4;  // chunk buffers

// Shared memory of one block of tt frames (kernels/mfsc.py::tc_smem_bytes is
// the same formula). Floats: the audio, rows_a rows of pa; then the chunk
// buffers, NBUF x KC rows of 2 * pb (cos, then sin), which the tt x pm
// magnitudes reuse after the DFT.
struct K1Layout {
  int kf;      // frame rounded up to 8: the depth of the DFT product
  int rows_a;  // staged audio rows of `stride` samples
  int pa;      // their pitch: stride rounded up to an odd number of 16-byte units
  int np;      // bins rounded up to 8
  int units;   // 16-byte units copied a cos or sin row
  int pb;      // floats of a staged cos (or sin) row, 4 (mod 16)
  int pm;      // pitch of a magnitude row: np rounded up to an odd number of units
  size_t bytes;
};

__host__ __device__ inline int odd_units(int n) {
  int u = (n + 3) / 4;
  return 4 * (u | 1);
}

__host__ __device__ inline K1Layout k1_layout(int tt, int frame, int stride, int n_bins) {
  K1Layout L;
  L.kf = (frame + 7) / 8 * 8;
  L.rows_a = tt + (L.kf - 1) / stride;
  L.pa = odd_units(stride);
  L.np = (n_bins + 7) / 8 * 8;
  L.units = (n_bins + 6 + 3) / 4;  // a row's span, shifted by up to 3, and its tail
  const int need = 4 * L.units > L.np + 3 ? 4 * L.units : L.np + 3;
  L.pb = (need - 4 + 15) / 16 * 16 + 4;
  L.pm = odd_units(L.np);
  const int stage = NBUF * KC * 2 * L.pb;
  const int mag = tt * L.pm;
  L.bytes = sizeof(float) * (static_cast<size_t>(L.rows_a) * L.pa + (stage > mag ? stage : mag));
  return L;
}

// MT 16-frame tiles a block (TT = 16 * MT): two blocks an SM up to MT = 2,
// one at MT = 3 (whose 120 sums a thread take more than half the
// registers). vec: the audio rows start 16-byte aligned (copied 16 bytes at
// a time, else 4).
template <int MT>
__global__ void __launch_bounds__(TC_THREADS, MT < 3 ? 2 : 1)
mfsc_tc_kernel(const float* __restrict__ audio, const float* __restrict__ cos_mat,
               const float* __restrict__ sin_mat, const float* __restrict__ mel_fb,
               float* __restrict__ out, int S, int T, int frame, int stride, int n_bins,
               int n_mels, float mel_floor, int vec) {
  constexpr int TT = 16 * MT;
  extern __shared__ __align__(16) float k1_smem[];
  const K1Layout L = k1_layout(TT, frame, stride, n_bins);
  float* xs = k1_smem;                              // [rows_a][pa] audio
  float* stage = k1_smem + L.rows_a * L.pa;         // [NBUF][KC][2 pb] cos | sin
  float* mag = stage;                               // [TT][pm], after the DFT
  const int chunk = KC * 2 * L.pb;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  // the audio span: rows_a rows of `stride` samples from sample t0 * stride
  {
    const float* a = audio + static_cast<size_t>(b) * S;
    const long long s0 = static_cast<long long>(t0) * stride;
    if (vec) {
      const int ua = stride / 4;
      for (int i = tid; i < L.rows_a * ua; i += TC_THREADS) {
        const int r = i / ua, u = i - r * ua;
        const long long s = s0 + static_cast<long long>(r) * stride + 4 * u;
        const long long left = S - s;
        const int bytes = left >= 4 ? 16 : left > 0 ? static_cast<int>(4 * left) : 0;
        cp_async(16, smem_addr(xs + r * L.pa + 4 * u), bytes ? a + s : a, bytes);
      }
    } else {
      for (int i = tid; i < L.rows_a * stride; i += TC_THREADS) {
        const int r = i / stride, u = i - r * stride;
        const long long s = s0 + static_cast<long long>(r) * stride + u;
        cp_async(4, smem_addr(xs + r * L.pa + u), s < S ? a + s : a, s < S ? 4 : 0);
      }
    }
  }

  // Chunk c: rows 8c .. 8c+7 of cos and sin. Row j's units start at
  // floor4(j * n_bins); staged, row r of the chunk at r * 2 pb (+ pb: sin),
  // so bin n of it sits at r * 2 pb + (r * n_bins) % 4 + n. The (row, unit)
  // pairs, 16 rows of `units`, are dealt to the threads in order; units past
  // the matrices' end, and rows past the frame, are zeros.
  const long long total = static_cast<long long>(frame) * n_bins;
  const int pairs = 2 * KC * L.units;
  const int row0 = tid / L.units, u0 = tid - row0 * L.units;
  const int srow = TC_THREADS / L.units, sunit = TC_THREADS - srow * L.units;
  auto issue_chunk = [&](int c) {
    float* buf = stage + (c % NBUF) * chunk;
    int row = row0, u = u0;
    for (int i = tid; i < pairs; i += TC_THREADS) {
      const int r = row % KC, j = KC * c + r;
      const float* m = row < KC ? cos_mat : sin_mat;
      const long long e = static_cast<long long>(j) * n_bins - ((r * n_bins) & 3) + 4 * u;
      const long long left = total - e;
      const int bytes = j >= frame ? 0 : left >= 4 ? 16 : left > 0 ? static_cast<int>(4 * left) : 0;
      cp_async(16, smem_addr(buf + r * 2 * L.pb + (row / KC) * L.pb + 4 * u), bytes ? m + e : m,
               bytes);
      row += srow;
      u += sunit;
      if (u >= L.units) {
        u -= L.units;
        ++row;
      }
    }
  };

  // groups: the audio with chunk 0, then one a chunk, NBUF - 1 in flight
  const int KS = L.kf / KC;
  for (int c = 0; c < NBUF - 1; ++c) {
    if (c < KS) issue_chunk(c);
    cp_async_commit();
  }

  const int NT = L.np / 8;
  float re[MT][NTW][4], im[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) re[mt][i][e] = im[mt][i][e] = 0.f;

  const uint32_t xs_lane = smem_addr(xs) + ((lane & 15) * L.pa + (lane >> 4) * 4) * 4;
  const int shift = (tq * n_bins) & 3;  // of staged rows tq and tq + 4
  int q = 0, rr = 0;                    // the step's first sample: q * stride + rr
  for (int c = 0; c < KS; ++c) {
    cp_async_wait<NBUF - 2>();  // chunk c (and the audio) has arrived
    __syncthreads();  // ... for every thread; chunk c - 1's buffer is free
    if (c + NBUF - 1 < KS) issue_chunk(c + NBUF - 1);
    cp_async_commit();  // one group a chunk, maybe empty
    AFrag<float> af[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t ra[4];
      ldsm_x4(ra, xs_lane + ((mt * 16 + q) * L.pa + rr) * 4);
      af[mt] = AFrag<float>(ra);
    }
    const float* bs = stage + (c % NBUF) * chunk + tq * 2 * L.pb + shift + g;
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int tile = warp + TC_WARPS * i;
      if (tile >= NT) break;
      const float* bc = bs + tile * 8;
      const BFragTF32 bcos(__float_as_uint(bc[0]), __float_as_uint(bc[8 * L.pb]));
      const BFragTF32 bsin(__float_as_uint(bc[L.pb]), __float_as_uint(bc[9 * L.pb]));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        af[mt].mma(re[mt][i], re[mt][i], bcos);
        af[mt].mma(im[mt][i], im[mt][i], bsin);
      }
    }
    rr += KC;
    if (rr >= stride) {
      rr -= stride;
      ++q;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every read of the chunks is done before mag overwrites them

  // magnitudes: thread (g, tq) of tile (mt, i) holds rows g, g + 8 and bins
  // 2 tq, 2 tq + 1 of it, re and im alike
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int tile = warp + TC_WARPS * i;
    if (tile >= NT) break;
    const int col = tile * 8 + 2 * tq;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = re[mt][i][2 * h + e], y = im[mt][i][2 * h + e];
          const float p = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
          m[e] = col + e < n_bins ? sqrtf(fmaxf(p, 1e-20f)) : 0.f;
        }
        *reinterpret_cast<float2*>(mag + (mt * 16 + g + 8 * h) * L.pm + col) =
            make_float2(m[0], m[1]);
      }
  }
  __syncthreads();

  // mel: the (row tile, mel tile) pairs p = warp, warp + 8, ..., row tile
  // p % MT and mel tile p / MT
  const int NMT = (n_mels + 7) / 8;
  for (int p = warp; p < MT * NMT; p += TC_WARPS) {
    const int wm = p % MT, nt = p / MT;
    const uint32_t mg_lane =
        smem_addr(mag) + ((wm * 16 + (lane & 15)) * L.pm + (lane >> 4) * 4) * 4;
    const int n = nt * 8 + g;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int ks = 0; ks < L.np / 8; ++ks) {
      uint32_t ra[4];
      ldsm_x4(ra, mg_lane + ks * 32);
      const AFrag<float> am(ra);
      const int k = ks * 8 + tq;
      const float b0 = n < n_mels && k < n_bins ? __ldg(mel_fb + k * n_mels + n) : 0.f;
      const float b1 = n < n_mels && k + 4 < n_bins ? __ldg(mel_fb + (k + 4) * n_mels + n) : 0.f;
      am.mma(acc, acc, __float_as_uint(b0), __float_as_uint(b1));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm * 16 + g + 8 * h;
      if (t >= T) continue;  // ragged last tile
      float* orow = out + (static_cast<size_t>(b) * T + t) * n_mels;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * tq + e;
        if (col < n_mels) orow[col] = logf(fmaxf(acc[2 * h + e], mel_floor));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores
// ---------------------------------------------------------------------------
constexpr int TT = 32;         // frames per block
constexpr int LANES = 32;      // bin lanes (one warp across bins)
constexpr int TY = 8;          // frame groups: LANES * TY = 256 threads
constexpr int THREADS = LANES * TY;
constexpr int FPT = TT / TY;   // frames per thread
constexpr int BIN_SLOTS = 9;   // bins per thread: up to LANES * 9 = 288 bins
constexpr int JC = 8;          // cos/sin rows staged per step

__global__ void __launch_bounds__(THREADS)
mfsc_cc_kernel(const float* __restrict__ audio, const float* __restrict__ cos_mat,
               const float* __restrict__ sin_mat, const float* __restrict__ mel_fb,
               float* __restrict__ out, int S, int T, int frame, int stride,
               int n_bins, int n_mels, float mel_floor) {
  extern __shared__ float smem[];
  const int span = (TT - 1) * stride + frame;
  float* xs = smem;                  // [span] audio of this tile
  float* cs = smem + span;           // [JC][n_bins] staged cos rows
  float* ss = cs + JC * n_bins;      // [JC][n_bins] staged sin rows
  float* mag = smem;                 // [TT][n_bins], after the DFT

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x;
  const int lane = tid % LANES;
  const int ty = tid / LANES;

  const float* a = audio + static_cast<size_t>(b) * S;
  const long long s0 = static_cast<long long>(t0) * stride;
  for (int i = tid; i < span; i += THREADS) {
    const long long s = s0 + i;
    xs[i] = s < S ? a[s] : 0.f;
  }

  float re[FPT][BIN_SLOTS];
  float im[FPT][BIN_SLOTS];
#pragma unroll
  for (int f = 0; f < FPT; ++f) {
#pragma unroll
    for (int q = 0; q < BIN_SLOTS; ++q) {
      re[f][q] = 0.f;
      im[f][q] = 0.f;
    }
  }

  for (int j0 = 0; j0 < frame; j0 += JC) {
    const int jn = min(JC, frame - j0);
    __syncthreads();  // the previous chunk is consumed (and xs is loaded)
    for (int i = tid; i < jn * n_bins; i += THREADS) {
      cs[i] = cos_mat[static_cast<size_t>(j0) * n_bins + i];
      ss[i] = sin_mat[static_cast<size_t>(j0) * n_bins + i];
    }
    __syncthreads();
    for (int jj = 0; jj < jn; ++jj) {
      float xv[FPT];
#pragma unroll
      for (int f = 0; f < FPT; ++f) xv[f] = xs[(ty * FPT + f) * stride + j0 + jj];
#pragma unroll
      for (int q = 0; q < BIN_SLOTS; ++q) {
        const int k = lane + LANES * q;
        if (k < n_bins) {
          const float c = cs[jj * n_bins + k];
          const float s = ss[jj * n_bins + k];
#pragma unroll
          for (int f = 0; f < FPT; ++f) {
            re[f][q] = fmaf(xv[f], c, re[f][q]);
            im[f][q] = fmaf(xv[f], s, im[f][q]);
          }
        }
      }
    }
  }
  __syncthreads();  // every read of xs/cs/ss is done before mag overwrites them

#pragma unroll
  for (int f = 0; f < FPT; ++f) {
#pragma unroll
    for (int q = 0; q < BIN_SLOTS; ++q) {
      const int k = lane + LANES * q;
      if (k < n_bins) {
        const float p = re[f][q] * re[f][q] + im[f][q] * im[f][q];
        mag[(ty * FPT + f) * n_bins + k] = sqrtf(fmaxf(p, 1e-20f));
      }
    }
  }
  __syncthreads();

  for (int o = tid; o < TT * n_mels; o += THREADS) {
    const int tt = o / n_mels;
    const int m = o - tt * n_mels;
    const int t = t0 + tt;
    if (t >= T) continue;  // ragged last tile
    const float* mr = mag + tt * n_bins;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k) acc = fmaf(mr[k], mel_fb[k * n_mels + m], acc);
    out[(static_cast<size_t>(b) * T + t) * n_mels + m] = logf(fmaxf(acc, mel_floor));
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. audio (B, S) pre-emphasized; cos/sin (frame, n_bins); mel_fb
// (n_bins, n_mels); out (B, T, n_mels), T = 1 + (S - frame) / stride. All
// float32.
// ---------------------------------------------------------------------------
extern "C" int w2l_mfsc_cc_max_bins() { return LANES * BIN_SLOTS; }

// Shared memory of a tensor-core block of tt frames (kernels/mfsc.py::
// tc_smem_bytes).
extern "C" int w2l_mfsc_tc_smem_bytes(int tt, int frame, int stride, int n_bins) {
  return static_cast<int>(k1_layout(tt, frame, stride, n_bins).bytes);
}

// 1 where the tensor-core route takes the shape (kernels/mfsc.py::tc_takes).
extern "C" int w2l_mfsc_tc_takes(int frame, int stride, int n_bins, int n_mels, int max_smem) {
  return frame > 0 && stride > 0 && stride % 8 == 0 && n_bins > 0 &&
         n_bins <= TC_WARPS * 8 * NTW && n_mels > 0 &&
         k1_layout(48, frame, stride, n_bins).bytes <= static_cast<size_t>(max_smem);
}

// Frames a tensor-core block (kernels/mfsc.py::tile_frames): of 48, 32 and
// 16, the tile that gives the busiest of sms SMs the least work, its
// ceil(blocks / sms) blocks times (tile + TILE_FIXED_FRAMES); the larger on
// a tie.
constexpr int TILE_FIXED_FRAMES = 40;
extern "C" int w2l_mfsc_tile_frames(int B, int T, int sms) {
  int best = 48;
  long long best_load = -1;
  for (int tt = 48; tt >= 16; tt -= 16) {
    const long long blocks = static_cast<long long>(B) * ((T + tt - 1) / tt);
    const long long load = (blocks + sms - 1) / sms * (tt + TILE_FIXED_FRAMES);
    if (best_load < 0 || load < best_load) {
      best_load = load;
      best = tt;
    }
  }
  return best;
}

extern "C" int w2l_mfsc_tc(const void* audio, const void* cos_mat, const void* sin_mat,
                           const void* mel_fb, void* out, int B, int S, int T, int frame,
                           int stride, int n_bins, int n_mels, float mel_floor, int tt, int vec,
                           void* stream) {
  if (tt != 16 && tt != 32 && tt != 48) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = k1_layout(tt, frame, stride, n_bins).bytes;
  dim3 grid((T + tt - 1) / tt, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(audio);
  const float* c = static_cast<const float*>(cos_mat);
  const float* si = static_cast<const float*>(sin_mat);
  const float* m = static_cast<const float*>(mel_fb);
  float* o = static_cast<float*>(out);
  if (tt == 48) {
    w2l::allow_smem(mfsc_tc_kernel<3>, smem);
    mfsc_tc_kernel<3><<<grid, TC_THREADS, smem, s>>>(a, c, si, m, o, S, T, frame, stride,
                                                     n_bins, n_mels, mel_floor, vec);
  } else if (tt == 32) {
    w2l::allow_smem(mfsc_tc_kernel<2>, smem);
    mfsc_tc_kernel<2><<<grid, TC_THREADS, smem, s>>>(a, c, si, m, o, S, T, frame, stride,
                                                     n_bins, n_mels, mel_floor, vec);
  } else {
    w2l::allow_smem(mfsc_tc_kernel<1>, smem);
    mfsc_tc_kernel<1><<<grid, TC_THREADS, smem, s>>>(a, c, si, m, o, S, T, frame, stride,
                                                     n_bins, n_mels, mel_floor, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int w2l_mfsc_cc(const void* audio, const void* cos_mat, const void* sin_mat,
                           const void* mel_fb, void* out, int B, int S, int T, int frame,
                           int stride, int n_bins, int n_mels, float mel_floor, void* stream) {
  const int span = (TT - 1) * stride + frame;
  const size_t dft = static_cast<size_t>(span) + 2 * JC * n_bins;
  const size_t mel = static_cast<size_t>(TT) * n_bins;
  const size_t smem = (dft > mel ? dft : mel) * sizeof(float);
  w2l::allow_smem(mfsc_cc_kernel, smem);
  dim3 grid((T + TT - 1) / TT, B);
  mfsc_cc_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(cos_mat),
      static_cast<const float*>(sin_mat), static_cast<const float*>(mel_fb),
      static_cast<float*>(out), S, T, frame, stride, n_bins, n_mels, mel_floor);
  return static_cast<int>(cudaGetLastError());
}
