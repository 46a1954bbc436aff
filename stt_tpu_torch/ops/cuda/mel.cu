// Fused log-mel front end for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel stt_tpu/ops/pallas/mel.py
// (log_mel_spectrogram_pallas, body _mel_kernel). Computes, for each row of
// audio on the engine's wire (uint8 mu-law, int16 PCM or float32):
//
//   expand the wire to float32 -> reflect-pad by n_fft/2 -> frames of 400
//   samples at hop 160 (last centred frame dropped) -> periodic Hann window
//   -> 400-point real DFT -> power -> Slaney mel projection ->
//   log10(max(x, 1e-10)), written as (B, n_mels, F).
//
// The per-row max-8 clamp and (x+4)/4 epilogue needs the whole row's max and
// stays plain PyTorch, as it stays XLA in the JAX package.
//
// What bounds it on the H100: the function's own work is ~10.5 kflop a frame
// (a 400-point real FFT, the window, the power, the filterbank's ~391
// non-zeros at 80 mels, the log) against 160 new input samples (1-4 bytes
// each) and n_mels*4 bytes out. At 16 x 10 s on the mu-law wire that is
// 2.51 us of float32 operations against 2.29 us of bytes: both bounds
// about equally. The TPU kernel computed the DFT as a dense product on its
// matrix unit, ~34x that work; on the CUDA cores that design is floored at
// ~0.085 ms. This one does only the function's own work, on chip:
//   - grid (tile of 16 frames, row), one warp per frame. The block loads its
//     tile's window of 15*160 + 400 samples into shared memory once, with the
//     reflect padding done by index arithmetic and the wire expansion fused
//     into the load; frames past n_frames read zeros and are never stored.
//     The tables (window, twiddles, filterbank) are staged in shared memory
//     in the same pass, with every thread's loads in flight together: at the
//     served sizes a call is one wave of blocks, so a block's latency, not
//     its throughput, sets the time. At 40 registers three blocks (48 warps)
//     fit on an SM, which hides the latency of the shared-memory traffic
//     that bounds the larger calls (~260 wavefronts a frame).
//   - FFT: the 400 windowed real samples pack into 200 complex values
//     z[n] = y[2n] + i y[2n+1], whose 200-point DFT (200 = 8*5*5) runs as an
//     in-place decimation-in-time FFT in the warp's slice of shared memory:
//     a radix-8 stage that reads z straight from the window in digit-reversed
//     order, then two radix-5 stages with twiddles, each butterfly done in
//     registers by one lane, a __syncwarp between stages. The split step
//     X[k] = E[k] + W400^k O[k] (E, O from Z[k] and conj Z[200-k]) gives
//     bins 0..200 in pairs (k, 200-k), and their power overwrites the warp's
//     slice. Slots are padded by one every 8 so the stages' strided accesses
//     stay clear of bank conflicts.
//   - mel: every Slaney filter is one contiguous run of bins, so each output
//     sums its run (1-14 bins at 80 mels, 1-9 at 128) instead of a dense
//     201-term dot; 16 lanes take the 16 frames of one mel, so the stores of
//     (B, n_mels, F) are coalesced along frames.
// The window, the twiddles and the sparse filterbank are tables computed on
// the host in float64 and rounded once to float32; the kernel calls no sine
// or cosine. No tensor cores, no TF32: every operation is float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kPad = kNFFT / 2;                    // reflect padding, 200
constexpr int kN = kNFFT / 2;                      // complex FFT length, 200
constexpr int kTileF = 16;                         // frames per block
constexpr int kThreads = 32 * kTileF;              // one warp per frame
constexpr int kWin = (kTileF - 1) * kHop + kNFFT;  // 2800 samples
// float2 slots per frame: 200 values padded one in 8 (224), +1 so that the
// power rows (450 floats apart) start in different banks
constexpr int kSlots = 225;

// twiddle table layout (float2 (cos, -sin) of each angle)
constexpr int kTwStage2 = 0;    // W40^(j k1), j 1..4, k1 0..7:   [(j-1)*8 + k1]
constexpr int kTwStage3 = 32;   // W200^(j k1), j 1..4, k1 0..39: [(j-1)*40 + k1]
constexpr int kTwSplit = 192;   // W400^k, k 0..100
constexpr int kTwRadix = 293;   // W5^1, W5^2, W8^1
constexpr int kTwCount = 296;
constexpr int kMaxMels = 128;     // the filterbank tables a block stages in
constexpr int kMaxWeights = 512;  // shared memory: no bin is in more than two
                                  // Slaney filters, so at most 402 non-zeros
constexpr int kLoads = (kWin + kThreads - 1) / kThreads;  // samples per thread

__device__ __forceinline__ int slot(int p) { return p + (p >> 3); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// 4-point DFT in place: (b0, b1, b2, b3) -> (Y0, Y1, Y2, Y3)
__device__ __forceinline__ void dft4(float2& b0, float2& b1, float2& b2, float2& b3) {
  const float2 s0 = cadd(b0, b2), d0 = csub(b0, b2);
  const float2 s1 = cadd(b1, b3), d1 = csub(b1, b3);
  b0 = cadd(s0, s1);
  b2 = csub(s0, s1);
  b1 = make_float2(d0.x + d1.y, d0.y - d1.x);  // d0 - i d1
  b3 = make_float2(d0.x - d1.y, d0.y + d1.x);  // d0 + i d1
}

// 8-point DFT in place, as two 4-point DFTs of the even and odd inputs;
// r = cos(pi/4)
__device__ __forceinline__ void dft8(float2 (&a)[8], float r) {
  dft4(a[0], a[2], a[4], a[6]);
  dft4(a[1], a[3], a[5], a[7]);
  const float2 e[4] = {a[0], a[2], a[4], a[6]};
  const float2 o[4] = {
      a[1],
      make_float2(r * (a[3].x + a[3].y), r * (a[3].y - a[3].x)),  // W8^1 o1
      make_float2(a[5].y, -a[5].x),                               // W8^2 o2
      make_float2(r * (a[7].y - a[7].x), -r * (a[7].x + a[7].y)), // W8^3 o3
  };
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = cadd(e[k], o[k]);
    a[k + 4] = csub(e[k], o[k]);
  }
}

// 5-point DFT in place; c1, s1 = cos, sin(2 pi/5), c2, s2 = cos, sin(4 pi/5)
__device__ __forceinline__ void dft5(float2 (&a)[5], float c1, float s1, float c2,
                                     float s2) {
  const float2 t1 = cadd(a[1], a[4]), t2 = cadd(a[2], a[3]);
  const float2 t3 = csub(a[1], a[4]), t4 = csub(a[2], a[3]);
  const float2 b1 = make_float2(fmaf(c2, t2.x, fmaf(c1, t1.x, a[0].x)),
                                fmaf(c2, t2.y, fmaf(c1, t1.y, a[0].y)));
  const float2 b2 = make_float2(fmaf(c1, t2.x, fmaf(c2, t1.x, a[0].x)),
                                fmaf(c1, t2.y, fmaf(c2, t1.y, a[0].y)));
  const float2 u1 = make_float2(fmaf(s2, t4.x, s1 * t3.x), fmaf(s2, t4.y, s1 * t3.y));
  const float2 u2 = make_float2(fmaf(-s1, t4.x, s2 * t3.x), fmaf(-s1, t4.y, s2 * t3.y));
  a[0] = cadd(a[0], cadd(t1, t2));
  a[1] = make_float2(b1.x + u1.y, b1.y - u1.x);  // b1 - i u1
  a[4] = make_float2(b1.x - u1.y, b1.y + u1.x);  // b1 + i u1
  a[2] = make_float2(b2.x + u2.y, b2.y - u2.x);  // b2 - i u2
  a[3] = make_float2(b2.x - u2.y, b2.y + u2.x);  // b2 + i u2
}

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
__global__ void __launch_bounds__(kThreads, 3)
mel_fft_kernel(const T* __restrict__ audio,
               const float2* __restrict__ window,   // (200,): (w[2n], w[2n+1])
               const float2* __restrict__ tw,       // twiddle table, layout above
               const int* __restrict__ filters,     // (n_mels, 3): first bin, length, offset
               const float* __restrict__ weights,   // packed non-zeros of the filterbank
               float* __restrict__ out,             // (B, n_mels, F)
               int n_samples, int n_frames, int n_mels, int n_weights) {
  __shared__ __align__(16) float win[kWin];
  __shared__ __align__(16) float2 spec[kTileF * kSlots];
  __shared__ float2 hann[kN];
  __shared__ float2 tws[kTwCount];
  __shared__ int filt[3 * kMaxMels];
  __shared__ float wts[kMaxWeights];

  const int row = blockIdx.y;
  const int f0 = blockIdx.x * kTileF;
  const T* x = audio + static_cast<size_t>(row) * n_samples;

  // the window covers padded positions [f0*hop, f0*hop + kWin); padded
  // position p holds sample p - pad, reflected at both ends (numpy "reflect").
  // Frames past n_frames in the last tile may index past the reflected tail;
  // they read zeros, are computed and never stored.
  T raw[kLoads];
  bool real[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int j = threadIdx.x + u * kThreads;
    int i = f0 * kHop + j - kPad;
    if (i < 0) i = -i;
    if (i >= n_samples) i = 2 * (n_samples - 1) - i;
    real[u] = j < kWin && i >= 0 && i < n_samples;
    raw[u] = real[u] ? x[i] : T(0);
  }
  for (int i = threadIdx.x; i < kN; i += kThreads) hann[i] = __ldg(window + i);
  for (int i = threadIdx.x; i < kTwCount; i += kThreads) tws[i] = __ldg(tw + i);
  for (int i = threadIdx.x; i < 3 * n_mels; i += kThreads) filt[i] = __ldg(filters + i);
  for (int i = threadIdx.x; i < n_weights; i += kThreads) wts[i] = __ldg(weights + i);
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int j = threadIdx.x + u * kThreads;
    if (j < kWin) win[j] = real[u] ? expand_sample<T>(raw[u]) : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float2* z = spec + warp * kSlots;
  const float2* y = reinterpret_cast<const float2*>(win + warp * kHop);
  const float2 w51 = tws[kTwRadix], w52 = tws[kTwRadix + 1];
  const float c1 = w51.x, s1 = -w51.y, c2 = w52.x, s2 = -w52.y;

  // stage 1, radix 8 (lengths 1 -> 8, no twiddles): block b of 8 takes
  // z[b/5 + 5*(b%5) + 25m], m = 0..7, the digit-reversed order
  if (lane < kN / 8) {
    const int n0 = lane / 5 + 5 * (lane % 5);
    float2 a[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int n = n0 + 25 * m;
      const float2 s = y[n];
      const float2 w = hann[n];
      a[m] = make_float2(s.x * w.x, s.y * w.y);
    }
    dft8(a, tws[kTwRadix + 2].x);
#pragma unroll
    for (int k = 0; k < 8; ++k) z[slot(8 * lane + k)] = a[k];
  }
  __syncwarp();

  // stage 2, radix 5 (lengths 8 -> 40): butterfly (c, k1) reads
  // 40c + 8j + k1, j = 0..4, twiddled by W40^(j k1)
  for (int i = lane; i < kN / 5; i += 32) {
    const int c = i / 8, k1 = i % 8;
    float2 a[5];
    a[0] = z[slot(40 * c + k1)];
#pragma unroll
    for (int j = 1; j < 5; ++j) {
      a[j] = cmul(z[slot(40 * c + 8 * j + k1)], tws[kTwStage2 + (j - 1) * 8 + k1]);
    }
    dft5(a, c1, s1, c2, s2);
#pragma unroll
    for (int k = 0; k < 5; ++k) z[slot(40 * c + 8 * k + k1)] = a[k];
  }
  __syncwarp();

  // stage 3, radix 5 (lengths 40 -> 200): butterfly k1 reads 40j + k1,
  // twiddled by W200^(j k1); the result is Z[k] in natural order
  for (int k1 = lane; k1 < kN / 5; k1 += 32) {
    float2 a[5];
    a[0] = z[slot(k1)];
#pragma unroll
    for (int j = 1; j < 5; ++j) {
      a[j] = cmul(z[slot(40 * j + k1)], tws[kTwStage3 + (j - 1) * 40 + k1]);
    }
    dft5(a, c1, s1, c2, s2);
#pragma unroll
    for (int k = 0; k < 5; ++k) z[slot(40 * k + k1)] = a[k];
  }
  __syncwarp();

  // split, bins k and 200-k for k = 0..100: E = (Z[k] + conj Z[200-k]) / 2,
  // O = -i (Z[k] - conj Z[200-k]) / 2 (Z[200] = Z[0]), X[k] = E + W400^k O,
  // X[200-k] = conj(E - W400^k O). All reads land in registers before the
  // power overwrites the slice.
  float pk[4], pc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int k = lane + 32 * u;
    if (k <= kN / 2) {
      const float2 zk = z[slot(k)];
      const float2 zc = z[slot(k == 0 ? 0 : kN - k)];
      const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
      const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
      const float2 wo = cmul(o, tws[kTwSplit + k]);
      const float ar = e.x + wo.x, ai = e.y + wo.y;
      const float br = e.x - wo.x, bi = e.y - wo.y;
      pk[u] = fmaf(ar, ar, ai * ai);
      pc[u] = fmaf(br, br, bi * bi);
    }
  }
  __syncwarp();
  float* power = reinterpret_cast<float*>(z);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int k = lane + 32 * u;
    if (k <= kN / 2) {
      power[k] = pk[u];
      if (k < kN / 2) power[kN - k] = pc[u];
    }
  }
  __syncthreads();

  // mel: 16 lanes per mel, one frame each; each sums its filter's run
  const int f = threadIdx.x % kTileF;
  const int frame = f0 + f;
  const float* pw = reinterpret_cast<const float*>(spec + f * kSlots);
  for (int m = threadIdx.x / kTileF; m < n_mels; m += kThreads / kTileF) {
    const int first = filt[3 * m], len = filt[3 * m + 1];
    const float* wm = wts + filt[3 * m + 2];
    float acc = 0.0f;
#pragma unroll 4
    for (int i = 0; i < len; ++i) acc = fmaf(pw[first + i], wm[i], acc);
    if (frame < n_frames) {
      out[(static_cast<size_t>(row) * n_mels + m) * n_frames + frame] =
          log10f(fmaxf(acc, 1e-10f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* audio, const float* window, const float* twiddles,
                   const int* filters, const float* weights, float* out, int batch,
                   int n_samples, int n_mels, int n_weights, cudaStream_t stream) {
  if (n_mels > kMaxMels || n_weights > kMaxWeights) return cudaErrorInvalidValue;
  const int n_frames = n_samples / kHop;
  dim3 grid((n_frames + kTileF - 1) / kTileF, batch);
  mel_fft_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(audio), reinterpret_cast<const float2*>(window),
      reinterpret_cast<const float2*>(twiddles), filters, weights, out, n_samples,
      n_frames, n_mels, n_weights);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 float32, 1 int16,
// 2 uint8 mu-law. window: 400 float32 (the periodic Hann window); twiddles:
// 296 (cos, -sin) float32 pairs in the layout above; filters: (n_mels, 3)
// int32 (first bin, length, offset into weights); weights: the filterbank's
// packed non-zeros (n_weights of them). Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue for more than 128 mels or 512 weights). The caller
// checks shapes: n_samples a multiple of 160 and greater than 200, out sized
// (batch, n_mels, n_samples/160), every pointer 8-byte aligned.
extern "C" int mel_logspec_launch(const void* audio, int dtype, const float* window,
                                  const float* twiddles, const int* filters,
                                  const float* weights, float* out, int batch,
                                  int n_samples, int n_mels, int n_weights,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(audio, window, twiddles, filters, weights, out, batch,
                           n_samples, n_mels, n_weights, s);
    case 1:
      return launch<int16_t>(audio, window, twiddles, filters, weights, out, batch,
                             n_samples, n_mels, n_weights, s);
    case 2:
      return launch<uint8_t>(audio, window, twiddles, filters, weights, out, batch,
                             n_samples, n_mels, n_weights, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
