// Cross-attention products over int8 K/V codes at one decode position, for
// Hopper (sm_90a), written by hand.
//
// Replaces no TPU kernel. With the cross-attention kernel off, the JAX
// package's cross-attention (stt_tpu/models/whisper.py) is an einsum over the
// stored K/V, and XLA fuses the int8 -> bf16 convert into the dot's operand
// load. The port's _attn_cached instead widens the layer's whole stored K/V to
// a bf16 copy before each cuBLAS product: per element of K/V one byte read,
// two written, two read again. These two launches are the einsum's two
// products with the convert in the load, so each element costs one byte:
//
//   logits[b,h,t] = sum_d q[b,h,d] * K[b,h,t,d]        cross_logits_kernel
//   out[b,h,d]    = sum_t bf16(w[b,h,t]) * V[b,h,t,d]  cross_mix_kernel
//
// q is bf16 with the per-(row, head) int8 scale of K already folded in, K and
// V are the int8 codes, w is the float32 softmax of the logits (torch computes
// it between the launches) and is rounded to bf16 on load, which is what the
// einsum route's .to(bfloat16) did; the caller multiplies the output by V's
// scale. Each product of a bf16 value and an int8 code is exact in float32
// and every sum is float32, so the launches round where cuBLAS's bf16
// products with float32 output do; only the order of the float32 sums
// differs.
//
// What bounds it on the H100: each launch reads its K or V once and does two
// flops a byte, far under the ~295 a byte where the tensor cores would bind,
// so both are bound by device-memory bytes. The design:
//   - threads split into NDG = Dh / 16 dim groups (one 16-byte load holds 16
//     codes) by NTG = 256 / NDG row groups, so a warp loads whole contiguous
//     K/V rows; each thread has kAhead loads in flight before it uses the
//     first (the mix loads the next kAhead rows while it sums these), and
//     each load asks the L2 for the 256 bytes around it and skips L1 (on an
//     H100 at 64 x 12 x 1500: logits 39.0 -> 34.8 us, the mix 44.8 -> 38.4
//     with the prefetch);
//   - codes widen in registers without the conversion unit: one xor adds 128
//     to the four codes of a 32-bit word, a byte permute sets each into the
//     mantissa of 2^23, and one subtraction of 2^23 + 128 leaves the code,
//     exactly;
//   - logits: grid (tiles, B*H); block r takes keys [r*chunk, min((r+1)*chunk,
//     Ta)) of its (b, h) with q's 16 values of its dim group in registers,
//     and the NDG lanes of a row meet by shuffles. Nothing meets across
//     blocks, so a small B*H is cut into more tiles (plan_logits in
//     ops/kernels/cross_mm.py) until the grid holds two blocks an SM;
//   - mix: a cluster of C blocks per (b, h) splits its keys the same way
//     while the grid holds fewer blocks than SMs (plan_mix); each block sums its rows into float32 registers, the row
//     groups of a warp meet by shuffles, the warps in shared memory in warp
//     order, and the C block sums in rank 0's shared memory through
//     distributed shared memory, added in rank order: deterministic, no
//     atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;      // int8 codes in one 16-byte load
constexpr int kAhead = 4;     // 16-byte loads in flight per thread
constexpr int kMaxCluster = 8;

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 16 int8 codes -> float32, exactly: bytes (code + 128, 0, 0, 0x4B) are the
// float 2^23 + code + 128
__device__ __forceinline__ void widen(const uint4& raw, float* out) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t biased = words[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[4 * i + j] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | j))
                       - 8388736.0f;
    }
  }
}

// 16 bytes of a K/V row, read once: not kept in L1, and the L2 asked for the
// 256-byte sector group around it, which a warp's next rows share
__device__ __forceinline__ uint4 load_row(const int8_t* p, bool ok) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (ok) {
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  }
  return r;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__global__ void __launch_bounds__(kThreads, 4)
cross_logits_kernel(const __nv_bfloat16* __restrict__ q,  // (B*H, Dh)
                    const int8_t* __restrict__ k,         // (B*H, Ta, Dh)
                    float* __restrict__ out,              // (B*H, Ta)
                    int ta, int dh, int chunk) {
  const int bh = blockIdx.y;
  const int t0 = blockIdx.x * chunk;
  const int n = min(chunk, ta - t0);  // the last tile may hold fewer keys
  const int ndg = dh / kVec;          // a power of two <= 32 (the wrapper checks)
  const int ntg = kThreads / ndg;
  const int dg = threadIdx.x % ndg;
  const int tg = threadIdx.x / ndg;
  const int8_t* kb = k + (static_cast<size_t>(bh) * ta + t0) * dh + dg * kVec;
  float* ob = out + static_cast<size_t>(bh) * ta + t0;

  float qr[kVec];
  const uint4* qp = reinterpret_cast<const uint4*>(q + static_cast<size_t>(bh) * dh + dg * kVec);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint4 raw = __ldg(qp + half);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      qr[8 * half + 2 * i] = f.x;
      qr[8 * half + 2 * i + 1] = f.y;
    }
  }

  // pass bounds are block-uniform, so every lane reaches the shuffles
  const int passes = (n + ntg - 1) / ntg;
  for (int p0 = 0; p0 < passes; p0 += kAhead) {
    uint4 kr[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int row = tg + (p0 + u) * ntg;
      kr[u] = load_row(kb + static_cast<size_t>(row) * dh, row < n);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (p0 + u < passes) {
        float kv[kVec];
        widen(kr[u], kv);
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) s = fmaf(qr[i], kv[i], s);
        for (int off = ndg >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        const int row = tg + (p0 + u) * ntg;
        if (row < n && dg == 0) ob[row] = s;
      }
    }
  }
}

// three blocks an SM: the rows of the next kAhead passes are loaded while
// this one's are summed, which takes more registers than four blocks allow
__global__ void __launch_bounds__(kThreads, 3)
cross_mix_kernel(const float* __restrict__ w,   // (B*H, Ta)
                 const int8_t* __restrict__ v,  // (B*H, Ta, Dh)
                 float* __restrict__ out,       // (B*H, Dh)
                 int ta, int dh, int chunk) {
  extern __shared__ float smem[];
  float* wpart = smem;                  // kWarps * dh: each warp's sum
  float* gather = wpart + kWarps * dh;  // nrank * dh: every block's sum (rank 0's is read)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nrank = static_cast<int>(cluster.num_blocks());
  // a block may write another's shared memory only once that block runs:
  // arrive now, wait just before the remote stores
  if (nrank > 1) cluster_arrive_relaxed();
  const int bh = blockIdx.y;
  const int c0 = rank * chunk;
  const int n = max(0, min(chunk, ta - c0));  // the last blocks may hold fewer keys, or none
  const int ndg = dh / kVec;
  const int ntg = kThreads / ndg;
  const int dg = threadIdx.x % ndg;
  const int tg = threadIdx.x / ndg;
  const int8_t* vb = v + (static_cast<size_t>(bh) * ta + c0) * dh + dg * kVec;
  const float* wb = w + static_cast<size_t>(bh) * ta + c0;

  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
  uint4 vr[kAhead];
  float wr[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const int row = tg + u * ntg;
    vr[u] = load_row(vb + static_cast<size_t>(row) * dh, row < n);
    wr[u] = row < n ? __ldg(wb + row) : 0.0f;
  }
  const int passes = (n + ntg - 1) / ntg;
  for (int p0 = 0; p0 < passes; p0 += kAhead) {
    uint4 vnext[kAhead];
    float wnext[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int row = tg + (p0 + kAhead + u) * ntg;
      vnext[u] = load_row(vb + static_cast<size_t>(row) * dh, row < n);
      wnext[u] = row < n ? __ldg(wb + row) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (tg + (p0 + u) * ntg < n) {
        const float wt = round_bf16(wr[u]);
        float vv[kVec];
        widen(vr[u], vv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = fmaf(wt, vv[i], acc[i]);
      }
      vr[u] = vnext[u];
      wr[u] = wnext[u];
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
  if (nrank == 1) {
    for (int d = threadIdx.x; d < dh; d += kThreads) {
      float o = 0.0f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) o += wpart[i * dh + d];
      out[static_cast<size_t>(bh) * dh + d] = o;
    }
    return;
  }
  cluster_wait();
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

bool dims_ok(int bh, int ta, int dh, int chunk) {
  const int ndg = dh / kVec;
  return bh >= 1 && bh <= 65535 && ta >= 1 && chunk >= 1 && dh % kVec == 0 && ndg >= 1 &&
         ndg <= 32 && (ndg & (ndg - 1)) == 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success). The
// caller checks shapes, types and alignment and plans the split: contiguous
// tensors, q and the K/V 16-byte aligned; Dh / 16 a power of two <= 32;
// 1 <= B*H <= 65535.

// q (bh, dh) bf16, k (bh, ta, dh) int8 -> out (bh, ta) float32, in tiles of
// `chunk` keys.
extern "C" int cross_logits_launch(const void* q, const void* k, float* out, int bh, int ta,
                                   int dh, int chunk, void* stream) {
  if (!dims_ok(bh, ta, dh, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (ta + chunk - 1) / chunk;
  cross_logits_kernel<<<dim3(tiles, bh, 1), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k), out, ta, dh, chunk);
  return static_cast<int>(cudaGetLastError());
}

// w (bh, ta) float32, v (bh, ta, dh) int8 -> out (bh, dh) float32, over a
// cluster of `clusters` blocks (a power of two <= 8) of `chunk` keys each,
// clusters * chunk >= ta.
extern "C" int cross_mix_launch(const void* w, const void* v, float* out, int bh, int ta,
                                int dh, int clusters, int chunk, void* stream) {
  if (!dims_ok(bh, ta, dh, chunk) || clusters < 1 || clusters > kMaxCluster ||
      (clusters & (clusters - 1)) || static_cast<long long>(clusters) * chunk < ta) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * static_cast<size_t>(kWarps + clusters) * dh;
  const float* wp = static_cast<const float*>(w);
  const int8_t* vp = static_cast<const int8_t*>(v);
  if (clusters == 1) {
    // every launch is an implicit one-block cluster; without the attribute
    // the launch costs less
    cross_mix_kernel<<<dim3(1, bh, 1), kThreads, smem, s>>>(wp, vp, out, ta, dh, chunk);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, bh, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cross_mix_kernel, wp, vp, out, ta, dh, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
