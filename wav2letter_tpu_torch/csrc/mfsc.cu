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
// 3.35 TB/s of HBM. This kernel does not reach that bound: like the TPU
// kernel it computes the DFT and the mel projection as dense products
// (~452 kFLOP per frame, ~35x what the function needs), so its own
// arithmetic limits it. The DFT runs in fp32 on the CUDA cores because the
// JAX reference computes it in fp32; TF32 tensor cores would lose about three
// digits. An FFT and a sparse filterbank are the way to the bytes bound.
//
// Design: one block per (batch row, tile of TT frames). The audio span of the
// tile, (TT-1)*stride + frame samples, is loaded once into shared memory; the
// cos/sin rows stream through shared memory JC rows at a time. Each thread
// keeps a register tile of FPT frames x BIN_SLOTS bins, so each staged cos/sin
// value feeds FPT FMAs per thread and TY threads per block, and each audio
// value read is a warp-wide broadcast. The magnitudes then go to shared memory
// (reusing the same space) for the 257 -> 80 mel product and the log.
#include "common.cuh"

namespace {

constexpr int TT = 32;         // frames per block
constexpr int LANES = 32;      // bin lanes (one warp across bins)
constexpr int TY = 8;          // frame groups: LANES * TY = 256 threads
constexpr int THREADS = LANES * TY;
constexpr int FPT = TT / TY;   // frames per thread
constexpr int BIN_SLOTS = 9;   // bins per thread: up to LANES * 9 = 288 bins
constexpr int JC = 8;          // cos/sin rows staged per step

__global__ void __launch_bounds__(THREADS)
mfsc_kernel(const float* __restrict__ audio, const float* __restrict__ cos_mat,
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

extern "C" int w2l_mfsc_max_bins() { return LANES * BIN_SLOTS; }

// audio (B, S) pre-emphasized; cos/sin (frame, n_bins); mel_fb (n_bins,
// n_mels); out (B, T, n_mels), T = 1 + (S - frame) / stride. All float32.
extern "C" int w2l_mfsc(const void* audio, const void* cos_mat, const void* sin_mat,
                        const void* mel_fb, void* out, int B, int S, int T, int frame,
                        int stride, int n_bins, int n_mels, float mel_floor,
                        void* stream) {
  const int span = (TT - 1) * stride + frame;
  const size_t dft = static_cast<size_t>(span) + 2 * JC * n_bins;
  const size_t mel = static_cast<size_t>(TT) * n_bins;
  const size_t smem = (dft > mel ? dft : mel) * sizeof(float);
  w2l::allow_smem(mfsc_kernel, smem);
  dim3 grid((T + TT - 1) / TT, B);
  mfsc_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(cos_mat),
      static_cast<const float*>(sin_mat), static_cast<const float*>(mel_fb),
      static_cast<float*>(out), S, T, frame, stride, n_bins, n_mels, mel_floor);
  return static_cast<int>(cudaGetLastError());
}
