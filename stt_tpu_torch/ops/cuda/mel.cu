// Fused log-mel front end for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel stt_tpu/ops/pallas/mel.py
// (log_mel_spectrogram_pallas, body _mel_kernel). Computes, for each row of
// audio on the engine's wire (uint8 mu-law, int16 PCM or float32):
//
//   expand the wire to float32 -> reflect-pad by n_fft/2 -> frames of 400
//   samples at hop 160 (last centred frame dropped) -> Hann-windowed real DFT
//   as a product with the (400, 402) basis -> power -> Slaney mel projection
//   -> log10(max(x, 1e-10)), written as (B, n_mels, F).
//
// The per-row max-8 clamp and (x+4)/4 epilogue needs the whole row's max and
// stays plain PyTorch, as it stays XLA in the JAX package.
//
// What bounds it on the H100: this design computes the DFT as a dense
// product, 400*402*2 flops per frame plus 201*n_mels*2 of mel projection
// (~354 kflop at 80 mels), so it is limited by float32 FMAs on the CUDA
// cores. The function itself needs far less: a 400-point real FFT (~9 kflop)
// and the filterbank's non-zeros (each bin falls in at most two filters),
// against 1-4 bytes of input per sample (160 new samples per frame) and
// n_mels*4 bytes of output, which puts its floor at the memory roofline.
// The design keeps every intermediate on chip:
//   - grid (frame tile of TILE_F frames, row); the block loads its tile's
//     window of (TILE_F-1)*hop + n_fft samples into shared memory once, with
//     the reflect padding done by index arithmetic and the wire expansion
//     fused into the load, so each sample is read from memory about once;
//   - each of the first 201 threads owns one DFT bin (its cos and -sin basis
//     columns stream from L2, one coalesced row of the basis per sample
//     offset) and accumulates that bin for all TILE_F frames in registers;
//     the window sample it multiplies is the same for the whole warp, so the
//     shared-memory read is a broadcast;
//   - the power spectrum goes to shared memory, and all 256 threads then
//     project it onto the mel filters (one frame per lane, so the output
//     stores are coalesced along frames).
// No tensor cores and no TF32: all products are float32 FMAs, so the kernel
// agrees with the float32 reference to rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kBins = kNFFT / 2 + 1;           // 201
constexpr int kPad = kNFFT / 2;                // 200
constexpr int kTileF = 32;                     // frames per block
constexpr int kWin = (kTileF - 1) * kHop + kNFFT;  // 5360 samples
constexpr int kThreads = 256;
constexpr int kMelGroups = kThreads / kTileF;  // 8 mel rows in flight

static_assert(kThreads >= kBins, "one thread per DFT bin");

template <typename T>
__device__ __forceinline__ float expand_sample(T v);

template <>
__device__ __forceinline__ float expand_sample<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float expand_sample<int16_t>(int16_t v) {
  return static_cast<float>(v) * (1.0f / 32768.0f);
}

// mu-law: y = v/127.5 - 1; x = sign(y) * (2^(8|y|) - 1) / 255
template <>
__device__ __forceinline__ float expand_sample<uint8_t>(uint8_t v) {
  const float y = static_cast<float>(v) * (1.0f / 127.5f) - 1.0f;
  const float s = (y > 0.0f) ? 1.0f : ((y < 0.0f) ? -1.0f : 0.0f);
  return s * (exp2f(8.0f * fabsf(y)) - 1.0f) * (1.0f / 255.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mel_logspec_kernel(const T* __restrict__ audio,
                   const float* __restrict__ basis,   // (400, 402)
                   const float* __restrict__ mel_t,   // (201, n_mels)
                   float* __restrict__ out,           // (B, n_mels, F)
                   int n_samples, int n_frames, int n_mels) {
  __shared__ float win[kWin];
  __shared__ float power[kTileF][kBins];  // odd row stride: no bank conflicts

  const int row = blockIdx.y;
  const int f0 = blockIdx.x * kTileF;
  const T* x = audio + static_cast<size_t>(row) * n_samples;

  // window covers padded positions [f0*hop, f0*hop + kWin); padded position
  // p holds sample p - pad, reflected at both ends (numpy "reflect")
  for (int j = threadIdx.x; j < kWin; j += kThreads) {
    int i = f0 * kHop + j - kPad;
    if (i < 0) i = -i;
    if (i >= n_samples) i = 2 * (n_samples - 1) - i;
    // frames past n_frames in the last tile may index past the reflected
    // tail; they are computed and never stored
    win[j] = (i >= 0 && i < n_samples) ? expand_sample<T>(x[i]) : 0.0f;
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k < kBins) {
    float re[kTileF], im[kTileF];
#pragma unroll
    for (int f = 0; f < kTileF; ++f) {
      re[f] = 0.0f;
      im[f] = 0.0f;
    }
    const float* bcol = basis + k;
#pragma unroll 2
    for (int n = 0; n < kNFFT; ++n) {
      const float c = __ldg(bcol + n * (2 * kBins));
      const float s = __ldg(bcol + n * (2 * kBins) + kBins);
#pragma unroll
      for (int f = 0; f < kTileF; ++f) {
        const float a = win[f * kHop + n];
        re[f] = fmaf(a, c, re[f]);
        im[f] = fmaf(a, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kTileF; ++f) {
      power[f][k] = re[f] * re[f] + im[f] * im[f];
    }
  }
  __syncthreads();

  const int f = threadIdx.x % kTileF;
  const int frame = f0 + f;
  for (int m = threadIdx.x / kTileF; m < n_mels; m += kMelGroups) {
    float acc = 0.0f;
    for (int b = 0; b < kBins; ++b) {
      acc = fmaf(power[f][b], __ldg(mel_t + b * n_mels + m), acc);
    }
    if (frame < n_frames) {
      out[(static_cast<size_t>(row) * n_mels + m) * n_frames + frame] =
          log10f(fmaxf(acc, 1e-10f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* audio, const float* basis, const float* mel_t,
                   float* out, int batch, int n_samples, int n_mels,
                   cudaStream_t stream) {
  const int n_frames = n_samples / kHop;
  dim3 grid((n_frames + kTileF - 1) / kTileF, batch);
  mel_logspec_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(audio), basis, mel_t, out, n_samples, n_frames,
      n_mels);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 float32, 1 int16,
// 2 uint8 mu-law. Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 on success). The caller checks shapes: n_samples a
// multiple of 160 and greater than 200, out sized (batch, n_mels,
// n_samples/160).
extern "C" int mel_logspec_launch(const void* audio, int dtype,
                                  const float* basis, const float* mel_t,
                                  float* out, int batch, int n_samples,
                                  int n_mels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(audio, basis, mel_t, out, batch, n_samples, n_mels, s);
    case 1:
      return launch<int16_t>(audio, basis, mel_t, out, batch, n_samples, n_mels, s);
    case 2:
      return launch<uint8_t>(audio, basis, mel_t, out, batch, n_samples, n_mels, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
