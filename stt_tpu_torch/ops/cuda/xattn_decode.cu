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
// tensor cores would bind, so it is bound by device-memory bytes. At the
// served 4 rows x 12 heads there are only 48 (b, h) pairs for 132 SMs, so
// the design splits each pair's Ta keys across a thread-block cluster to put
// enough bytes in flight:
//   - a cluster of C blocks per (b, h) (grid (C, B*H), cluster (C, 1, 1));
//     block r takes keys [r*chunk, min((r+1)*chunk, Ta)). C and chunk come
//     from the planner in ops/kernels/xattn_decode.py;
//   - threads split into NDG = Dh / VEC dim groups (VEC elements = one
//     16-byte load) by NTG = 256 / NDG row groups, so a warp loads whole
//     contiguous K/V rows; each thread has kAhead loads in flight before it
//     uses the first, and the V rows of its first kAhead passes are loaded
//     before the cluster exchange, so they arrive while the softmax waits on
//     the other blocks;
//   - each block keeps its chunk's scores in shared memory and takes its
//     local max; the maxima meet through distributed shared memory (DSMEM):
//     each block stores its max into every block's slot for it, then one
//     cluster barrier, giving the global max M; the local sums of exp(s - M)
//     meet the same way, giving L. Every block folds the C values in rank
//     order, so all hold the same M and L bit for bit. Blocks only store to
//     remote shared memory, never load from it, so no exchange waits on a
//     DSMEM round trip;
//   - each block then forms w = bf16(exp(s - M) / L) -- exactly the mm
//     body's rounding, since the weights are normalised globally before they
//     are rounded -- and mixes its V chunk into a float32 partial, which it
//     stores into rank 0's shared memory;
//   - after a last cluster barrier rank 0 sums the C partials in rank order
//     and writes the output: deterministic, no atomics and no rescaling
//     combine.
// One launch per call, whatever C is.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 4;          // 16-byte loads in flight per thread
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;

// Split cluster barrier: arrive (no ordering of earlier memory operations)
// and wait, so the wait costs nothing once every block has arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

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
    const __nv_fp8x2_storage_t* p = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // exact: every e4m3 value is a half (and a bf16)
      const __half2 h(__nv_cvt_fp8x2_to_halfraw2(p[i], __NV_E4M3));
      const float2 f = __half22float2(h);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
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

__device__ __forceinline__ uint4 load_row(const void* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
}

// At most 64 registers, so four blocks fit an SM: at the served 4 x 12 x
// 1500 the grid is 48 clusters of 8, and with 73 registers (three blocks an
// SM) cudaOccupancyMaxActiveClusters found room for fewer than 48 at once,
// so the last clusters ran as a second wave.
template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads, 4)
xattn_decode_kernel(const Q* __restrict__ q,   // (B*H, Dh)
                    const T* __restrict__ k,   // (B*H, Ta, Dh)
                    const T* __restrict__ v,   // (B*H, Ta, Dh)
                    float* __restrict__ out,   // (B*H, Dh)
                    int ta, int dh, int chunk) {
  constexpr int kVec = Unpack<T>::kVec;
  extern __shared__ float smem[];
  float* w = smem;                     // chunk: scores, then exp, then bf16 weights
  float* wpart = w + chunk;            // kWarps * dh: each warp's mix partial
  float* gather = wpart + kWarps * dh; // nrank * dh: every block's partial (rank 0's is read)
  __shared__ float red[kWarps];
  __shared__ float maxima[kMaxCluster];  // every block's max, pushed here by its owner
  __shared__ float sums[kMaxCluster];    // every block's sum of exp

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nrank = static_cast<int>(cluster.num_blocks());
  // a block may write another's shared memory only once that block runs:
  // arrive now, wait just before the first remote store
  cluster_arrive_relaxed();
  const int bh = blockIdx.y;
  const int c0 = rank * chunk;
  const int n = max(0, min(chunk, ta - c0));  // the last blocks may hold fewer keys, or none
  const size_t base = (static_cast<size_t>(bh) * ta + c0) * dh;
  const T* kb = k + base;
  const T* vb = v + base;
  const int ndg = dh / kVec;          // a power of two <= 32 (the wrapper checks)
  const int ntg = kThreads / ndg;
  const int dg = threadIdx.x % ndg;
  const int tg = threadIdx.x / ndg;
  const int passes = (n + ntg - 1) / ntg;

  // V rows of the first kAhead passes, used only after the exchange
  uint4 vpre[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const int row = tg + u * ntg;
    vpre[u] = load_row(vb + static_cast<size_t>(row) * dh + dg * kVec, row < n);
  }
  float qr[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) qr[i] = q_to_float<Q>(q[static_cast<size_t>(bh) * dh + dg * kVec + i]);

  // scores; pass bounds are block-uniform so every lane reaches the shuffles
  float mloc = -INFINITY;
  for (int p0 = 0; p0 < passes; p0 += kAhead) {
    uint4 kr[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int row = tg + (p0 + u) * ntg;
      kr[u] = load_row(kb + static_cast<size_t>(row) * dh + dg * kVec, row < n);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (p0 + u < passes) {
        float kv[kVec];
        Unpack<T>::run(kr[u], kv);
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) s = fmaf(qr[i], kv[i], s);
        for (int off = ndg >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        const int row = tg + (p0 + u) * ntg;
        if (row < n) {
          if (dg == 0) w[row] = s;
          mloc = fmaxf(mloc, s);
        }
      }
    }
  }
  mloc = block_reduce<true>(mloc, red);  // its barriers also publish w[]
  cluster_wait();
  // each exchange: thread r stores this block's value into block r's slot
  // [rank] (remote stores, no round trip), then one cluster barrier; every
  // block then folds the same nrank values in rank order
  if (threadIdx.x < nrank) *cluster.map_shared_rank(&maxima[rank], threadIdx.x) = mloc;
  cluster.sync();
  float gmax = -INFINITY;
  for (int r = 0; r < nrank; ++r) gmax = fmaxf(gmax, maxima[r]);

  float lloc = 0.0f;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const float p = expf(w[t] - gmax);
    w[t] = p;
    lloc += p;
  }
  lloc = block_reduce<false>(lloc, red);
  if (threadIdx.x < nrank) *cluster.map_shared_rank(&sums[rank], threadIdx.x) = lloc;
  cluster.sync();
  float gsum = 0.0f;
  for (int r = 0; r < nrank; ++r) gsum += sums[r];
  for (int t = threadIdx.x; t < n; t += kThreads) w[t] = round_bf16(w[t] / gsum);
  __syncthreads();

  // mix this block's chunk in float32
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
  for (int p0 = 0; p0 < passes; p0 += kAhead) {
    uint4 vr[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int row = tg + (p0 + u) * ntg;
      vr[u] = p0 == 0 ? vpre[u]
                      : load_row(vb + static_cast<size_t>(row) * dh + dg * kVec, row < n);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int row = tg + (p0 + u) * ntg;
      if (row < n) {
        const float wt = w[row];
        float vv[kVec];
        Unpack<T>::run(vr[u], vv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = fmaf(wt, vv[i], acc[i]);
      }
    }
  }
  // the row groups of one warp share each dim group's lanes: lane = r * ndg + dg
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    for (int off = ndg; off < 32; off <<= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) < ndg) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) wpart[warp * dh + dg * kVec + i] = acc[i];
  }
  __syncthreads();
  float* gather0 = cluster.map_shared_rank(gather, 0);
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float o = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) o += wpart[i * dh + d];
    gather0[rank * dh + d] = o;  // into rank 0's shared memory
  }
  cluster.sync();
  if (rank == 0) {
    for (int d = threadIdx.x; d < dh; d += kThreads) {
      float o = 0.0f;
      for (int r = 0; r < nrank; ++r) o += gather[r * dh + d];
      out[static_cast<size_t>(bh) * dh + d] = o;
    }
  }
}

template <typename T, typename Q>
cudaError_t launch(const void* q, const void* k, const void* v, float* out, int bh, int ta,
                   int dh, int clusters, int chunk, cudaStream_t stream) {
  auto kernel = xattn_decode_kernel<T, Q>;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(chunk) + static_cast<size_t>(kWarps + clusters) * dh);
  // attributes are set once per instantiation, when a launch first needs them
  static size_t smem_allowed = 48 * 1024;
  static bool non_portable = false;
  cudaError_t err = cudaSuccess;
  if (smem > smem_allowed) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  if (clusters > kPortableCluster && !non_portable) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable = true;
  }
  if (clusters == 1) {
    // every launch is an implicit one-block cluster; without the attribute
    // the launch costs ~1-3 us less (64 x 12 pairs x Ta 500 takes this path)
    kernel<<<dim3(1, bh, 1), kThreads, smem, stream>>>(
        static_cast<const Q*>(q), static_cast<const T*>(k), static_cast<const T*>(v), out, ta,
        dh, chunk);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, bh, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const Q*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), out, ta, dh, chunk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename Q>
cudaError_t launch_kv(const void* q, const void* k, const void* v, int kv_dtype, float* out,
                      int bh, int ta, int dh, int clusters, int chunk, cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return launch<float, Q>(q, k, v, out, bh, ta, dh, clusters, chunk, s);
    case 1: return launch<__nv_bfloat16, Q>(q, k, v, out, bh, ta, dh, clusters, chunk, s);
    case 2: return launch<__nv_fp8_e4m3, Q>(q, k, v, out, bh, ta, dh, clusters, chunk, s);
    case 3: return launch<int8_t, Q>(q, k, v, out, bh, ta, dh, clusters, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. q_dtype: 0 float32, 1 bf16.
// kv_dtype: 0 float32, 1 bf16, 2 fp8 e4m3, 3 int8. Launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on success).
// The caller checks shapes and alignment and plans the split: q (bh, dh),
// k/v (bh, ta, dh), contiguous, 16-byte aligned; dh / (16 / itemsize) a power
// of two <= 32; bh <= 65535; a cluster of 1-16 blocks (a power of two) of
// `chunk` keys each, clusters * chunk >= ta >= 1.
extern "C" int xattn_decode_launch(const void* q, int q_dtype, const void* k, const void* v,
                                   int kv_dtype, float* out, int bh, int ta, int dh,
                                   int clusters, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clusters < 1 || clusters > 16 || (clusters & (clusters - 1)) || chunk < 1 || ta < 1 ||
      static_cast<long long>(clusters) * chunk < ta) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (q_dtype) {
    case 0: return launch_kv<float>(q, k, v, kv_dtype, out, bh, ta, dh, clusters, chunk, s);
    case 1: return launch_kv<__nv_bfloat16>(q, k, v, kv_dtype, out, bh, ta, dh, clusters, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
