// Encoder flash self-attention backward for Hopper (sm_90a), written by hand.
//
// Replaces the two Pallas TPU backward kernels of the library flash
// attention that stt_tpu/models/whisper.py::_flash_self_attention reaches
// under grad (jax.experimental.pallas.ops.tpu.flash_attention,
// _flash_attention_bwd_dkv with body _flash_attention_dkv_kernel, and
// _flash_attention_bwd_dq with body _flash_attention_dq_kernel; non-causal,
// sm_scale 1). For each (b, h), over the T real rows and keys, with the
// forward's per-row log-sum-exp lse (flash_attention.cu writes it) and
// di[r] = sum_e o[r,e] dO[r,e] (computed outside, as the library does):
//
//   P[r,c]  = exp(q[r].k[c] - lse[r])
//   dV[c]   = sum_r P[r,c] dO[r]            dP[r,c] = dO[r].v[c]
//   dS[r,c] = P[r,c] (dP[r,c] - di[r])
//   dK[c]   = sum_r dS[r,c] q[r]            dQ[r]   = sum_c dS[r,c] k[c]
//
// Two kernels, as on the TPU, so that no sum crosses blocks and nothing is
// atomic (repeated calls are bit-identical):
//   - flash_bwd_dkv_kernel: a block owns 64 keys, holds their K and V tiles
//     and the dK, dV sums, and walks every 64-row query tile (Q, dO, lse,
//     di), recomputing P and dS for the tile;
//   - flash_bwd_dq_kernel: a block owns 64 query rows, holds Q, dO and the
//     dQ sums, and walks every 64-key K/V tile.
// Inputs are bf16 or float32 (the type the trainer trains in), widened to
// float32 as they are copied into shared memory; every product and sum is
// float32 (no TF32), and the gradients round once to the input type.
//
// What bounds it on the H100: dK/dV does 8*T^2*Dh flops per (b, h) (S, dP,
// dV and dK, one FMA a pair and dim each), dQ 6*T^2*Dh (S, dP, dQ), against
// ~10*T*Dh values moved, so both are bound by arithmetic: at 4 x 12 x 1500
// x 64, 0.83 ms and 0.62 ms at the 67 TFLOP/s float32 peak, or 0.056 ms and
// 0.042 ms of bf16 tensor-core time. This first version is the simple one:
// CUDA-core FMAs on float32 tiles in shared memory (rows padded to Dh + 1
// floats, so 16 consecutive rows read at one column hit 16 banks), 256
// threads as a 16 x 16 grid, each thread a 4 x 4 micro-tile of the 64 x 64
// score tile (its rows/keys 16 apart) and 4 x Dh/16 of each gradient tile.
// Its bf16 path does the same float32 work as its float32 path; wgmma, TMA
// and a ring of tiles are later work. The ragged last tile is masked: rows
// past T get lse = +inf (so P = 0), keys past T are zero-filled and never
// stored, and dQ zeroes their P; nothing is padded in device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows (or keys) a block owns, and a tile brings
constexpr int kThreads = 256;   // thread (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16)
constexpr int kPStride = kTile + 1;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [r0, r0 + kTile) of one head's (t, kDh) matrix as a float32 tile of
// row stride kDh + 1, zero past t; neighbouring threads read neighbouring
// elements of a row.
template <typename T, int kDh>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int t) {
  for (int i = threadIdx.x; i < kTile * kDh; i += kThreads) {
    const int r = i / kDh, c = i % kDh;
    dst[r * (kDh + 1) + c] =
        r0 + r < t ? widen(src[static_cast<size_t>(r0 + r) * kDh + c]) : 0.0f;
  }
}

template <int kDh>
struct BwdLayout {
  static constexpr int kStride = kDh + 1;
  static constexpr int kMat = kTile * kStride;   // one (64, Dh) tile
  static constexpr int kE = kDh / 16;            // gradient dims per thread
};

// Grid (ceil(t / 64), B*H). Thread (ty, tx) owns keys k0 + ty + 16a (a < 4)
// of dK and dV at dims tx + 16e (e < Dh/16), and in each query tile the
// scores of those keys against rows tx + 16b (b < 4).
template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     T* __restrict__ dk, T* __restrict__ dv, int t) {
  using L = BwdLayout<kDh>;
  constexpr int S = L::kStride;
  constexpr int kE = L::kE;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + L::kMat;
  float* q_s = v_s + L::kMat;
  float* do_s = q_s + L::kMat;
  float* p_s = do_s + L::kMat;            // [key][row] P of the tile
  float* ds_s = p_s + kTile * kPStride;   // [key][row] dS of the tile
  float* lse_s = ds_s + kTile * kPStride;
  float* di_s = lse_s + kTile;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * t * kDh;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * t;
  load_tile<T, kDh>(k_s, k + base, k0, t);
  load_tile<T, kDh>(v_s, v + base, k0, t);

  float acc_k[4][kE], acc_v[4][kE];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int e = 0; e < kE; ++e) acc_k[a][e] = acc_v[a][e] = 0.0f;
  }

  const int n_tiles = (t + kTile - 1) / kTile;
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = i * kTile;
    __syncthreads();  // every thread is done with the previous tile
    load_tile<T, kDh>(q_s, q + base, q0, t);
    load_tile<T, kDh>(do_s, dout + base, q0, t);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const bool real = q0 + j < t;
      lse_s[j] = real ? lse[rbase + q0 + j] : INFINITY;  // P = 0 past t
      di_s[j] = real ? di[rbase + q0 + j] : 0.0f;
    }
    __syncthreads();

    // S^T and dP^T: keys ty + 16a x rows tx + 16b, summed over d in order
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < kDh; ++d) {
      float kk[4], vv[4], qq[4], gg[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        kk[a] = k_s[(ty + 16 * a) * S + d];
        vv[a] = v_s[(ty + 16 * a) * S + d];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        qq[b] = q_s[(tx + 16 * b) * S + d];
        gg[b] = do_s[(tx + 16 * b) * S + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(kk[a], qq[b], s[a][b]);
          dp[a][b] = fmaf(vv[a], gg[b], dp[a][b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = tx + 16 * b;
        const float p = expf(s[a][b] - lse_s[r]);
        p_s[(ty + 16 * a) * kPStride + r] = p;
        ds_s[(ty + 16 * a) * kPStride + r] = p * (dp[a][b] - di_s[r]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the tile's rows in order
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pp[4], dd[4], gg[kE], qq[kE];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pp[a] = p_s[(ty + 16 * a) * kPStride + r];
        dd[a] = ds_s[(ty + 16 * a) * kPStride + r];
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        gg[e] = do_s[r * S + tx + 16 * e];
        qq[e] = q_s[r * S + tx + 16 * e];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          acc_v[a][e] = fmaf(pp[a], gg[e], acc_v[a][e]);
          acc_k[a][e] = fmaf(dd[a], qq[e], acc_k[a][e]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = k0 + ty + 16 * a;
    if (c >= t) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      dk[base + static_cast<size_t>(c) * kDh + tx + 16 * e] = narrow<T>(acc_k[a][e]);
      dv[base + static_cast<size_t>(c) * kDh + tx + 16 * e] = narrow<T>(acc_v[a][e]);
    }
  }
}

// Grid (ceil(t / 64), B*H). Thread (ty, tx) owns rows q0 + ty + 16a (a < 4)
// of dQ at dims tx + 16e, and in each key tile the scores of those rows
// against keys tx + 16b (b < 4).
template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    T* __restrict__ dq, int t) {
  using L = BwdLayout<kDh>;
  constexpr int S = L::kStride;
  constexpr int kE = L::kE;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + L::kMat;
  float* k_s = do_s + L::kMat;
  float* v_s = k_s + L::kMat;
  float* ds_s = v_s + L::kMat;   // [row][key] dS of the tile

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * t * kDh;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * t;
  load_tile<T, kDh>(q_s, q + base, q0, t);
  load_tile<T, kDh>(do_s, dout + base, q0, t);

  float lse_r[4], di_r[4], acc[4][kE];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty + 16 * a;
    lse_r[a] = r < t ? lse[rbase + r] : INFINITY;
    di_r[a] = r < t ? di[rbase + r] : 0.0f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[a][e] = 0.0f;
  }

  const int n_tiles = (t + kTile - 1) / kTile;
  for (int j = 0; j < n_tiles; ++j) {
    const int c0 = j * kTile;
    __syncthreads();  // every thread is done with the previous K/V and dS
    load_tile<T, kDh>(k_s, k + base, c0, t);
    load_tile<T, kDh>(v_s, v + base, c0, t);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < kDh; ++d) {
      float qq[4], gg[4], kk[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qq[a] = q_s[(ty + 16 * a) * S + d];
        gg[a] = do_s[(ty + 16 * a) * S + d];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        kk[b] = k_s[(tx + 16 * b) * S + d];
        vv[b] = v_s[(tx + 16 * b) * S + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(qq[a], kk[b], s[a][b]);
          dp[a][b] = fmaf(gg[a], vv[b], dp[a][b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = tx + 16 * b;
        const float p = c0 + c < t ? expf(s[a][b] - lse_r[a]) : 0.0f;
        ds_s[(ty + 16 * a) * kPStride + c] = p * (dp[a][b] - di_r[a]);
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's keys in order
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dd[4], kk[kE];
#pragma unroll
      for (int a = 0; a < 4; ++a) dd[a] = ds_s[(ty + 16 * a) * kPStride + c];
#pragma unroll
      for (int e = 0; e < kE; ++e) kk[e] = k_s[c * S + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[a][e] = fmaf(dd[a], kk[e], acc[a][e]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= t) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      dq[base + static_cast<size_t>(r) * kDh + tx + 16 * e] = narrow<T>(acc[a][e]);
    }
  }
}

template <int kDh>
constexpr int dkv_smem() {
  return (4 * BwdLayout<kDh>::kMat + 2 * kTile * kPStride + 2 * kTile) *
         static_cast<int>(sizeof(float));
}

template <int kDh>
constexpr int dq_smem() {
  return (4 * BwdLayout<kDh>::kMat + kTile * kPStride) * static_cast<int>(sizeof(float));
}

template <typename T, int kDh>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* di, void* dk, void* dv, int bh, int t,
               cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, kDh>;
  constexpr int smem = dkv_smem<kDh>();
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((t + kTile - 1) / kTile, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dk), static_cast<T*>(dv), t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kDh>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* di, void* dq, int bh, int t,
              cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, kDh>;
  constexpr int smem = dq_smem<kDh>();
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((t + kTile - 1) / kTile, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dq), t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* di, void* dk, void* dv, int bh, int t,
                 int dh, cudaStream_t s) {
  switch (dh) {
    case 16: return launch_dkv<T, 16>(q, k, v, dout, lse, di, dk, dv, bh, t, s);
    case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, di, dk, dv, bh, t, s);
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, di, dk, dv, bh, t, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* di, void* dq, int bh, int t, int dh,
                cudaStream_t s) {
  switch (dh) {
    case 16: return launch_dq<T, 16>(q, k, v, dout, lse, di, dq, bh, t, s);
    case 32: return launch_dq<T, 32>(q, k, v, dout, lse, di, dq, bh, t, s);
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, di, dq, bh, t, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. q, k, v, dout and the outputs
// are contiguous (bh, t, dh) of one type, `bf16` 1 for bfloat16 and 0 for
// float32; lse and di are contiguous (bh, t) float32; dh 16, 32 or 64;
// 1 <= bh <= 65535. Each launches on `stream` without synchronising and
// returns 0 on success or the launch's cudaError_t.
extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* di, void* dk, void* dv, int bh,
                                              int t, int dh, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  return bf16 ? dispatch_dkv<__nv_bfloat16>(q, k, v, dout, l, d, dk, dv, bh, t, dh, s)
              : dispatch_dkv<float>(q, k, v, dout, l, d, dk, dv, bh, t, dh, s);
}

extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* di, void* dq, int bh, int t, int dh,
                                             int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  return bf16 ? dispatch_dq<__nv_bfloat16>(q, k, v, dout, l, d, dq, bh, t, dh, s)
              : dispatch_dq<float>(q, k, v, dout, l, d, dq, bh, t, dh, s);
}
