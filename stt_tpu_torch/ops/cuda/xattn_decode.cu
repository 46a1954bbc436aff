// Single-position cross-attention decode for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel stt_tpu/ops/pallas/xattn_decode.py
// (xattn_decode; bodies _xattn_kernel, _xattn_kernel_vpu, _xattn_kernel_mm,
// _xattn_kernel_mmd, which are four TPU tilings of one function). For each
// (row b, head h) of one decode position:
//
//   s[t]     = sum_d q[b,h,d] * K[b,h,t,d]              float32
//   w[t]     = bf16( exp(s[t] - max s) / sum_t exp(.) )  float32 softmax,
//                                                         rounded after it
//   out[b,h] = sum_t w[t] * V[b,h,t,:]                   float32
//
// which is the "mm" body's (and _attn_cached's) rounding. q arrives
// pre-scaled by d_head**-0.25 and K pre-scaled; both q and the stored K/V are
// rounded to bf16 on load, as the mm body's astype(bfloat16) does. K/V may be
// stored as bf16, fp8 e4m3, int8 (the caller folds the per-(row, head) scales
// into q and the output) or float32; the conversion is fused into the load,
// so a widened copy of the cache never exists in device memory.
//
// What bounds it on the H100: the function reads the whole K and V once and
// does 4 flops per element pair, far under the ~295 flops a byte where the
// tensor cores would bind, so it is bound by device-memory bytes. The design
// keeps the scores and weights on chip and reads each K/V byte once:
//   - one block per (b, h); its Ta scores live in dynamic shared memory;
//   - threads split into NDG = Dh / VEC dim groups (VEC elements = one
//     16-byte load) by NTG = 256 / NDG row groups, so a warp loads whole
//     contiguous K/V rows with 16-byte loads; the dim groups of one key sum
//     their partial dots with warp shuffles;
//   - a block max and a block sum give the softmax; the weights are
//     normalised and rounded to bf16 in shared memory;
//   - the mix runs in the same (row group, dim group) layout, each thread
//     accumulating VEC outputs over its rows in float32, and a final pass
//     sums the row groups' partials from shared memory.
// One block per (b, h) fills the card only at large B*H (12 blocks at B 1);
// split-Ta flash-decoding is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One 16-byte load of storage elements -> float32, rounded to bf16.
template <typename T>
struct Unpack;

template <>
struct Unpack<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void run(const uint4& raw, float* out) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Unpack<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void run(const uint4& raw, float* out) {
    out[0] = round_bf16(__uint_as_float(raw.x));
    out[1] = round_bf16(__uint_as_float(raw.y));
    out[2] = round_bf16(__uint_as_float(raw.z));
    out[3] = round_bf16(__uint_as_float(raw.w));
  }
};

template <>
struct Unpack<__nv_fp8_e4m3> {
  static constexpr int kVec = 16;
  __device__ __forceinline__ static void run(const uint4& raw, float* out) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      __nv_fp8_e4m3 x;
      x.__x = p[i];
      out[i] = static_cast<float>(x);  // exact: e4m3 fits in bf16
    }
  }
};

template <>
struct Unpack<int8_t> {
  static constexpr int kVec = 16;
  __device__ __forceinline__ static void run(const uint4& raw, float* out) {
    const int8_t* p = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(p[i]);
  }
};

template <typename Q>
__device__ __forceinline__ float q_to_float(Q x);

template <>
__device__ __forceinline__ float q_to_float<float>(float x) {
  return round_bf16(x);
}

template <>
__device__ __forceinline__ float q_to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Max (kMax) or sum over the block; every thread gets the same value.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red[] is free from any earlier reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) x = kMax ? fmaxf(x, red[i]) : x + red[i];
  return x;
}

template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads)
xattn_decode_kernel(const Q* __restrict__ q,   // (B*H, Dh)
                    const T* __restrict__ k,   // (B*H, Ta, Dh)
                    const T* __restrict__ v,   // (B*H, Ta, Dh)
                    float* __restrict__ out,   // (B*H, Dh)
                    int ta, int dh) {
  constexpr int kVec = Unpack<T>::kVec;
  extern __shared__ float smem[];
  float* qs = smem;                   // dh
  float* w = qs + dh;                 // ta: scores, then bf16 weights
  float* part = w + ta;               // kThreads * kVec mix partials
  __shared__ float red[kWarps];

  const int bh = blockIdx.x;
  const size_t base = static_cast<size_t>(bh) * ta * dh;
  const T* kb = k + base;
  const T* vb = v + base;
  const int ndg = dh / kVec;          // a power of two <= 32 (wrapper checks)
  const int ntg = kThreads / ndg;
  const int dg = threadIdx.x % ndg;
  const int tg = threadIdx.x / ndg;

  for (int d = threadIdx.x; d < dh; d += kThreads) {
    qs[d] = q_to_float<Q>(q[static_cast<size_t>(bh) * dh + d]);
  }
  __syncthreads();
  float qr[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) qr[i] = qs[dg * kVec + i];

  // scores; the loop bound is block-uniform so every lane reaches the shuffles
  for (int t0 = 0; t0 < ta; t0 += ntg) {
    const int t = t0 + tg;
    float s = 0.0f;
    if (t < ta) {
      float kv[kVec];
      Unpack<T>::run(
          *reinterpret_cast<const uint4*>(kb + static_cast<size_t>(t) * dh + dg * kVec), kv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) s = fmaf(qr[i], kv[i], s);
    }
    for (int off = ndg >> 1; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    if (t < ta && dg == 0) w[t] = s;
  }
  __syncthreads();

  // softmax in float32; each thread revisits only its own entries until the
  // weights are complete
  float m = -INFINITY;
  for (int t = threadIdx.x; t < ta; t += kThreads) m = fmaxf(m, w[t]);
  m = block_reduce<true>(m, red);
  float l = 0.0f;
  for (int t = threadIdx.x; t < ta; t += kThreads) {
    const float p = expf(w[t] - m);
    w[t] = p;
    l += p;
  }
  l = block_reduce<false>(l, red);
  for (int t = threadIdx.x; t < ta; t += kThreads) w[t] = round_bf16(w[t] / l);
  __syncthreads();

  // mix
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
  for (int t = tg; t < ta; t += ntg) {
    const float wt = w[t];
    float vv[kVec];
    Unpack<T>::run(
        *reinterpret_cast<const uint4*>(vb + static_cast<size_t>(t) * dh + dg * kVec), vv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = fmaf(wt, vv[i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) part[tg * dh + dg * kVec + i] = acc[i];
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float o = 0.0f;
    for (int g = 0; g < ntg; ++g) o += part[g * dh + d];
    out[static_cast<size_t>(bh) * dh + d] = o;
  }
}

template <typename T, typename Q>
cudaError_t launch(const void* q, const void* k, const void* v, float* out,
                   int bh, int ta, int dh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(dh) + ta +
                                       static_cast<size_t>(kThreads) * Unpack<T>::kVec);
  xattn_decode_kernel<T, Q><<<bh, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, ta, dh);
  return cudaGetLastError();
}

template <typename Q>
cudaError_t launch_kv(const void* q, const void* k, const void* v, int kv_dtype,
                      float* out, int bh, int ta, int dh, cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return launch<float, Q>(q, k, v, out, bh, ta, dh, s);
    case 1: return launch<__nv_bfloat16, Q>(q, k, v, out, bh, ta, dh, s);
    case 2: return launch<__nv_fp8_e4m3, Q>(q, k, v, out, bh, ta, dh, s);
    case 3: return launch<int8_t, Q>(q, k, v, out, bh, ta, dh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. q_dtype: 0 float32, 1 bf16.
// kv_dtype: 0 float32, 1 bf16, 2 fp8 e4m3, 3 int8. Launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on success).
// The caller checks shapes and alignment: q (bh, dh), k/v (bh, ta, dh),
// contiguous, 16-byte aligned; dh / (16 / itemsize) a power of two <= 32;
// dynamic shared memory (dh + ta + 256 * 16 / itemsize) * 4 bytes <= 48 KB.
extern "C" int xattn_decode_launch(const void* q, int q_dtype, const void* k,
                                   const void* v, int kv_dtype, float* out,
                                   int bh, int ta, int dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return launch_kv<float>(q, k, v, kv_dtype, out, bh, ta, dh, s);
    case 1: return launch_kv<__nv_bfloat16>(q, k, v, kv_dtype, out, bh, ta, dh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
