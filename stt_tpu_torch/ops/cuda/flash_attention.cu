// Encoder flash self-attention for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU flash-attention kernel that
// stt_tpu/models/whisper.py::_flash_self_attention reaches
// (jax.experimental.pallas.ops.tpu.flash_attention, non-causal, sm_scale 1,
// the sequence padded to 128 with the padding in its own segment). Computes,
// for each (b, h) and query row r < T, over the T real keys only:
//
//   out[r] = sum_c bf16(exp(s[r,c] - m[r])) * V[c]  /  sum_c exp(s[r,c] - m[r])
//   s[r,c] = q[r] . k[c]   (q and k pre-scaled by d_head**-0.25)
//
// with float32 scores, a float32 online softmax, the unnormalised p rounded
// to bf16 before the P.V product (the TPU kernel's p.astype(v.dtype)), and
// one division by l at the end. Inputs and output are bf16, the serving
// path's type; the kernel takes no float32.
//
// What bounds it on the H100: 4*T^2*Dh flops per (b, h) against ~8*T*Dh bytes
// moved, ~375 flops a byte at T 1500, so the work is bound by arithmetic on
// the tensor cores (989 TFLOP/s bf16). The kernel runs on them through
// mma.sync m16n8k16 (bf16 in, float32 accumulate), so the products are exact
// and the sums float32, as on the TPU's MXU.
//   - one block of four warps per (b, h, 64-query tile); each warp owns 16
//     query rows, whose q fragments stay in registers for the whole pass;
//   - 64-key tiles of K (row-major) and V (transposed, so both are the
//     mma's column-major B operand) go through shared memory with rows
//     padded by 8 elements, so the fragment loads have no bank conflicts;
//   - S = q K^T lands in the mma's accumulator layout; each row's max and
//     sum need only two shuffles among the four lanes that hold the row;
//     p is rounded to bf16 and repacked in registers as the A operand of
//     P.V, so the 64 x 64 weight tile never touches shared memory;
//   - keys >= T in the last tile are masked to -inf (1500 = 23*64 + 28) and
//     their V rows zero-filled; query rows >= T compute but never store.
//   There is no copy pipeline (cp.async/TMA) and no wgmma yet: later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kPad = 8;       // bf16 elements of padding per shared row
constexpr int kWarps = kBlockQ / 16;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int kDh>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_mma_kernel(const uint32_t* __restrict__ q,   // (B*H, T, Dh) bf16 pairs
                           const uint32_t* __restrict__ k,
                           const uint32_t* __restrict__ v,
                           uint32_t* __restrict__ o,
                           int t) {
  constexpr int kW = kDh / 2;              // 32-bit words per row
  constexpr int kKc = kDh / 16;            // k-chunks of the q.k product
  constexpr int kDn = kDh / 8;             // n-tiles of the output
  constexpr int kKs = (kDh + kPad) / 2;    // words per K row in shared memory
  constexpr int kVs = (kBlockK + kPad) / 2;  // words per V^T row
  __shared__ __align__(16) uint32_t ks[kBlockK * kKs];
  __shared__ __align__(16) uint32_t vt[kDh * kVs];
  __nv_bfloat16* vt16 = reinterpret_cast<__nv_bfloat16*>(vt);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // row within the 8-row half of the fragment
  const int tq = lane % 4;  // column pair within the fragment
  const size_t base = static_cast<size_t>(blockIdx.y) * t * kW;
  const int row0 = blockIdx.x * kBlockQ + warp * 16 + g;
  const int row1 = row0 + 8;

  uint32_t qa[kKc][4];
#pragma unroll
  for (int kc = 0; kc < kKc; ++kc) {
    const int w = kc * 8 + tq;
    qa[kc][0] = row0 < t ? q[base + static_cast<size_t>(row0) * kW + w] : 0u;
    qa[kc][1] = row1 < t ? q[base + static_cast<size_t>(row1) * kW + w] : 0u;
    qa[kc][2] = row0 < t ? q[base + static_cast<size_t>(row0) * kW + w + 4] : 0u;
    qa[kc][3] = row1 < t ? q[base + static_cast<size_t>(row1) * kW + w + 4] : 0u;
  }
  float acc[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows row0, row1
  float l0 = 0.0f, l1 = 0.0f;            // this lane's share of the running sums

  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    const int nk = min(kBlockK, t - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBlockK * kW; i += kWarps * 32) {
      const int c = i / kW;
      const int w = i % kW;
      uint32_t kv = 0u, vv = 0u;
      if (c < nk) {
        const size_t idx = base + static_cast<size_t>(k0 + c) * kW + w;
        kv = k[idx];
        vv = v[idx];
      }
      ks[c * kKs + w] = kv;
      const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&vv);
      vt16[(2 * w) * (2 * kVs) + c] = pair.x;
      vt16[(2 * w + 1) * (2 * kVs) + c] = pair.y;
    }
    __syncthreads();

    // S = q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const uint32_t* kr = ks + (nt * 8 + g) * kKs + tq;
#pragma unroll
      for (int kc = 0; kc < kKc; ++kc) mma_bf16(s[nt], qa[kc], kr[kc * 8], kr[kc * 8 + 4]);
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      const int c = nt * 8 + 2 * tq;
      if (c >= nk) s[nt][0] = s[nt][2] = -INFINITY;
      if (c + 1 >= nk) s[nt][1] = s[nt][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key 0 of every tile is real, so the new max is finite; exp(-inf) = 0
    // clears the empty start state
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn) {
      acc[dn][0] *= a0;
      acc[dn][1] *= a0;
      acc[dn][2] *= a1;
      acc[dn][3] *= a1;
    }
    // p = exp(s - m), summed unrounded, rounded to bf16 into A fragments
    uint32_t pa[kBlockK / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      const float p0 = expf(s[nt][0] - m0), p1 = expf(s[nt][1] - m0);
      const float p2 = expf(s[nt][2] - m1), p3 = expf(s[nt][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    // acc += P V
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn) {
      const uint32_t* vr = vt + (dn * 8 + g) * kVs + tq;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        mma_bf16(acc[dn], pa[kk], vr[kk * 8], vr[kk * 8 + 4]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn) {
    const int w = dn * 4 + tq;
    if (row0 < t) o[base + static_cast<size_t>(row0) * kW + w] =
        pack_bf16(acc[dn][0] * inv0, acc[dn][1] * inv0);
    if (row1 < t) o[base + static_cast<size_t>(row1) * kW + w] =
        pack_bf16(acc[dn][2] * inv1, acc[dn][3] * inv1);
  }
}

template <int kDh>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int t,
                   cudaStream_t stream) {
  dim3 grid((t + kBlockQ - 1) / kBlockQ, bh);
  flash_attention_mma_kernel<kDh><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<const uint32_t*>(v), static_cast<uint32_t*>(o), t);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. q, k, v, o are contiguous
// (bh, t, dh) bf16; dh 16, 32 or 64. Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int bh, int t, int dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(q, k, v, o, bh, t, s);
    case 32: return launch<32>(q, k, v, o, bh, t, s);
    case 64: return launch<64>(q, k, v, o, bh, t, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
