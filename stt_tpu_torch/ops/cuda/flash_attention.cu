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
// path's type. Head dims 16, 32 and 64.
//
// A second body, flash_attention_f32_kernel, serves float32 encoders: the
// same softmax(q.k^T).v with nothing rounded below float32, in FMAs on the
// CUDA cores (no TF32: it keeps ~3 decimal digits, and the float32 path is
// held to float32), full-precision expf and one division by the running sum
// at the end. What bounds it: 4*T^2*Dh flops per (b, h) at the 67 TFLOP/s
// float32 peak (~0.41 ms at 4 x 12 x 1500 x 64), and as much the path from
// shared memory to registers: 128 bytes a clock a SM, so one LDS.128 (16
// bytes to each of 32 lanes, broadcast or not) holds it 4 clocks while the
// SM's four schedulers issue 16 warp FMAs. A thread that loads r + c floats
// for an r x c block of FMAs keeps both pipes level only at r*c/(r+c) >= 4:
// an 8 x 8 micro-tile, the register-blocked SGEMM's, applied twice:
//   - a block is 128 query rows in 128 threads, a 16 x 8 grid; thread
//     (ty, tx) owns rows ty + 16r (r < 8), so a warp's 4 row groups read 4
//     consecutive rows at once and a row's 8 lanes sit in one warp. The Q
//     tile is staged once; K and V come in 64-key tiles into one K and one
//     V buffer by 16-byte cp.async.cg (zero-filled past T), alternately:
//     V_i is copied while S_i is computed, K_{i+1} while P_i V_i is. Rows
//     are padded to Dh + 4 floats, so 8 consecutive rows read at one column
//     hit 8 distinct bank groups;
//   - S = Q K^T: each thread sums an 8 x 8 micro-tile (its 8 rows x keys
//     tx + 8j) over d in steps of 4: 8 float4 of q and 8 of k for 256 FMAs;
//   - the online softmax stays in registers: the row max over the 8 tx
//     lanes takes 3 xor shuffles, alpha = expf(m_old - m_new) rescales the
//     thread's own O rows (the rows of S and of O are the same rows), keys
//     >= T score -inf, and each lane keeps its share of the row sum until one
//     shuffle reduction at the end;
//   - O += P V: p goes to a shared [key][row slot] tile (slot 8ty + r holds
//     row ty + 16r, padded to 132 floats), so a thread reads its 8 rows' p at
//     key c as 2 float4s and its Dh/8 dims of V (float4s at 32c + 4tx) as 2:
//     64 FMAs per 4 loads at Dh 64;
//   - 255 registers and no spills at Dh 64, 103,424 bytes of shared memory:
//     2 blocks (8 warps) a SM;
//   - a grid that loads the SMs unevenly (1 x 12 x 1500 is 144 blocks on
//     132 SMs) may split the keys over a cluster of up to 8 blocks (the
//     planner in ops/kernels/flash_attention.py picks how many): each block
//     runs a contiguous range of tiles, publishes (m, l, O) in its shared
//     memory, and after one cluster barrier each block combines a slice of
//     the rows from every block's shared memory (DSMEM) in rank order. Sums
//     run in a fixed order and nothing is atomic, so repeated calls are
//     bit-identical.
//
// What bounds the bf16 body on the H100: 4*T^2*Dh flops per (b, h) against ~8*T*Dh bytes
// moved, ~375 flops a byte at T 1500, so the work is bound by arithmetic on
// the tensor cores (989 TFLOP/s bf16). The design is Hopper's:
//   - warp specialisation: each block has three consumer warpgroups of 64
//     query rows (192 rows a block, so each K/V tile serves 192 queries, and
//     while one warpgroup runs its softmax the others keep the tensor cores
//     busy) and one producer warp; at 4 x 12 x 1500 that is 384 blocks, 2.9
//     waves of one block per SM;
//   - TMA: the producer loads the block's Q tile once, then K and V tiles of
//     128 keys x Dh into a 3-stage ring in shared memory, each stage with a
//     full barrier per tensor (mbarrier with the TMA's byte count) and one
//     empty barrier the consumers' warps arrive on when the stage is used.
//     Rows are Dh*2 bytes (128/64/32) and the tiles use the swizzle of that
//     width (128B/64B/32B), which is the layout wgmma reads;
//   - S = Q K^T on wgmma m64n128k16 (bf16 in, float32 accumulate), with Q
//     and K both K-major operands straight from the swizzled tiles;
//   - the online softmax runs in registers: each accumulator row sits in
//     four lanes, so its max and sum take two shuffles. At Dh 64 the
//     exponentials (one per score, on the special-function unit at 16 a
//     clock per SM) cost about as much time as the tensor-core work, so
//     each is one ex2.approx.ftz of s*log2(e) - m. p is rounded to bf16
//     and repacked in registers as the A operand of O += P V on wgmma
//     m64nDhk16, whose B operand V is read MN-major through wgmma's
//     transpose bit, so no transposed copy of V exists anywhere;
//   - the ragged tail (1500 = 11*128 + 92): the tensors are described to TMA
//     as 3-D (Dh, T, B*H), so the T bound clips per head and the rows past T
//     arrive as zeros (a 2-D (B*H*T, Dh) view would fetch the next head's
//     first keys); keys >= T get a score of -inf, query rows >= T are not
//     stored.
// Tensor maps are encoded on the host by cuTensorMapEncodeTiled, fetched
// through cudaGetDriverEntryPoint so the library needs no -lcuda, and passed
// as __grid_constant__ parameters.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumers = 3;                      // warpgroups of 64 query rows
constexpr int kBlockM = 64 * kConsumers;           // query rows per block
constexpr int kBlockN = 128;                       // keys per K/V tile
constexpr int kStages = 3;                         // K/V ring depth
constexpr int kThreads = 128 * kConsumers + 32;    // consumers, then the producer warp
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr float kLog2e = 1.4426950408889634f;

template <int kDh>
struct Layout {
  static constexpr int kRowBytes = kDh * 2;
  static constexpr int kQBytes = kBlockM * kRowBytes;
  static constexpr int kTileBytes = kBlockN * kRowBytes;
  static constexpr int kBytes = kQBytes + 2 * kStages * kTileBytes;
  // 8 rows of one swizzle atom: the descriptors' stride between row groups
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;
  // wgmma descriptor layout code (1 = 128B, 2 = 64B, 3 = 32B swizzle)
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// ~4e9 clocks (seconds) can only be a fault: it traps, so the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done && clock64() - start > 4000000000LL) __trap();
  } while (!done);
}

// One TMA tile copy, coordinates (dh 0, row, head); completion counts bytes
// on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(0), "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout. The tiles start on
// 1024-byte boundaries, so the base offset field stays 0.
template <uint64_t kSwizzle>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (kSwizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching accumulator registers across the async
// product: ties each one to a point after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (+)= A B for one m64n128k16 step, A and B read from shared memory
// through descriptors, both K-major; accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for one m64n16k16 step, A (bf16 pairs) from registers, B read
// from shared memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for one m64n32k16 step, A (bf16 pairs) from registers, B read
// from shared memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for one m64n64k16 step, A (bf16 pairs) from registers, B read
// from shared memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int kDh>
__device__ __forceinline__ void wgmma_pv(float (&d)[kDh / 2], const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<16>(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n16(d, a, db);
}

template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n32(d, a, db);
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (weights under 2^-126 of the row's largest weight, which is 1).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int kDh>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             uint32_t* __restrict__ o,   // (B*H, T, Dh) bf16 pairs
                             int t) {
  using L = Layout<kDh>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages];
  __shared__ __align__(8) uint64_t v_full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];

  // the swizzled tiles need 1024-byte alignment (the launch asks 1 KB extra)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* k_s = q_s + L::kQBytes;
  uint8_t* v_s = k_s + kStages * L::kTileBytes;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int n_tiles = (t + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // ---- producer warp: one lane starts every TMA copy ----
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(&q_full, L::kQBytes);
      tma_load(q_s, &map_q, &q_full, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        mbar_expect_tx(&k_full[s], L::kTileBytes);
        tma_load(k_s + s * L::kTileBytes, &map_k, &k_full[s], i * kBlockN, bh);
        mbar_expect_tx(&v_full[s], L::kTileBytes);
        tma_load(v_s + s * L::kTileBytes, &map_v, &v_full[s], i * kBlockN, bh);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64*wg .. +63 ----
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // row within the warp's 8-row half
  const int tq = lane % 4;  // column pair within each 8-column block
  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * L::kRowBytes;
  const uint32_t k_addr = smem_u32(k_s);
  const uint32_t v_addr = smem_u32(v_s);

  float acc[kDh / 2];
#pragma unroll
  for (int i = 0; i < kDh / 2; ++i) acc[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8 (log2 units)
  float l0 = 0.0f, l1 = 0.0f;            // this lane's share of the running sums

  mbar_wait(&q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const uint32_t ks = k_addr + s * L::kTileBytes;
    const uint32_t vs = v_addr + s * L::kTileBytes;

    // S = Q K^T: 64 rows x 128 keys, Dh/16 steps of 16 along the head dim
    float sc[kBlockN / 2];
    mbar_wait(&k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kDh / 16; ++kc) {
      wgmma_ss_n128(sc,
                    wgmma_desc<L::kSwizzle>(q_addr + kc * 32, 16, L::kGroupBytes),
                    wgmma_desc<L::kSwizzle>(ks + kc * 32, 16, L::kGroupBytes), kc > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // sc[4j + e]: row g + 8*(e/2), key 8j + 2*tq + (e%2); keys >= t masked
    const int k0 = i * kBlockN;
    if (k0 + kBlockN > t) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const int c = k0 + 8 * j + 2 * tq;
        if (c >= t) sc[4 * j] = sc[4 * j + 2] = -INFINITY;
        if (c + 1 >= t) sc[4 * j + 1] = sc[4 * j + 3] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key 0 of every tile is real, so the new max is finite; exp2(-inf) = 0
    // clears the empty start state
    const float mn0 = fmaxf(m0, mx0 * kLog2e), mn1 = fmaxf(m1, mx1 * kLog2e);
    const float a0 = exp2_ftz(m0 - mn0), a1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      acc[4 * j] *= a0;
      acc[4 * j + 1] *= a0;
      acc[4 * j + 2] *= a1;
      acc[4 * j + 3] *= a1;
    }
    // p = exp(s - m), summed unrounded, rounded to bf16 into the A fragments
    // of P V: step kk covers keys 16kk..16kk+15 = accumulator blocks 2kk, 2kk+1
    uint32_t pa[kBlockN / 16][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      const float p0 = exp2_ftz(fmaf(sc[4 * j], kLog2e, -m0));
      const float p1 = exp2_ftz(fmaf(sc[4 * j + 1], kLog2e, -m0));
      const float p2 = exp2_ftz(fmaf(sc[4 * j + 2], kLog2e, -m1));
      const float p3 = exp2_ftz(fmaf(sc[4 * j + 3], kLog2e, -m1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: Dh columns, 8 steps of 16 keys; V's rows advance the K dim
    mbar_wait(&v_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      wgmma_pv<kDh>(acc, pa[kk],
                    wgmma_desc<L::kSwizzle>(vs + kk * 16 * L::kRowBytes, L::kGroupBytes,
                                            L::kGroupBytes));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const int row0 = q0 + wg * 64 + warp * 16 + g;
  const int row1 = row0 + 8;
  const size_t base = static_cast<size_t>(bh) * t * (kDh / 2);
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    const int w = j * 4 + tq;
    if (row0 < t) o[base + static_cast<size_t>(row0) * (kDh / 2) + w] =
        pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row1 < t) o[base + static_cast<size_t>(row1) * (kDh / 2) + w] =
        pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

constexpr int kF32R = 8;                // query rows per thread
constexpr int kF32Rows = 16 * kF32R;    // query rows per block: 16 row groups
constexpr int kF32Keys = 64;            // keys per K/V tile: 8 key lanes of 8
constexpr int kF32Threads = 128;        // thread (ty, tx) = (threadIdx.x / 8, threadIdx.x % 8)
constexpr int kF32MinBlocks = 2;        // resident blocks a SM: 255 registers a thread
constexpr int kF32MaxSplit = 8;         // key splits: blocks of one cluster, the portable size
constexpr int kF32PStride = kF32Rows + 4;  // the P tile is [key][row slot], padded

// Offsets in floats of the float32 body's shared memory: the Q tile, one K
// tile, one V tile, the P tile.
template <int kDh>
struct F32Layout {
  static constexpr int kStride = kDh + 4;            // a padded row of Q, K or V
  static constexpr int kTile = kF32Keys * kStride;   // K or V
  static constexpr int kK = kF32Rows * kStride;
  static constexpr int kV = kK + kTile;
  static constexpr int kP = kV + kTile;
  static constexpr int kFloats = kP + kF32Keys * kF32PStride;
  static constexpr int kDv = kDh / 8;                // output dims per thread
};

// 16 bytes global -> shared without registers; `real` false zero-fills the
// 16 bytes and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool real) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src)), "r"(real ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of rows [r0, r0 + kN) of one head's (t, kDh) matrix into
// a padded tile; rows >= t are zero-filled. Neighbouring threads copy
// neighbouring 16-byte pieces of a row.
template <int kDh, int kN>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int t) {
  constexpr int kVec = kDh / 4;
#pragma unroll
  for (int n = 0; n < kN * kVec / kF32Threads; ++n) {
    const int i = threadIdx.x + n * kF32Threads;
    const int r = i / kVec, c = i % kVec;
    const bool real = r0 + r < t;
    cp_async16(dst + r * F32Layout<kDh>::kStride + 4 * c,
               src + (real ? static_cast<size_t>(r0 + r) * kDh + 4 * c : 0), real);
  }
}

// A thread's kDh / 8 output dims of a row: float4s at 32c + 4tx (Dh 32,
// 64), so the 8 lanes of a row group read 128 contiguous bytes at once; a
// float2 at 2tx (Dh 16).
template <int kDh>
__device__ __forceinline__ void load_dims(float (&x)[kDh / 8], const float* row, int tx) {
  if constexpr (kDh >= 32) {
#pragma unroll
    for (int c = 0; c < kDh / 32; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(row + 32 * c + 4 * tx);
      x[4 * c] = a.x; x[4 * c + 1] = a.y; x[4 * c + 2] = a.z; x[4 * c + 3] = a.w;
    }
  } else {
    const float2 a = *reinterpret_cast<const float2*>(row + 2 * tx);
    x[0] = a.x; x[1] = a.y;
  }
}

template <int kDh>
__device__ __forceinline__ void store_dims(float* row, const float (&x)[kDh / 8], int tx) {
  if constexpr (kDh >= 32) {
#pragma unroll
    for (int c = 0; c < kDh / 32; ++c) {
      *reinterpret_cast<float4*>(row + 32 * c + 4 * tx) =
          make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
    }
  } else {
    *reinterpret_cast<float2*>(row + 2 * tx) = make_float2(x[0], x[1]);
  }
}

// Grid (ceil(t / 64) * splits, B*H); with splits > 1, clusters of `splits`
// blocks along x: block rank r of query block qb takes key tiles
// [r * per, min((r + 1) * per, n_tiles)), per = ceil(n_tiles / splits),
// which the launcher checks is never empty. Thread (ty, tx) owns query rows
// ty + 16r (r < kF32R; 4 consecutive rows across a warp's row groups, so a
// q load hits 4 distinct bank groups), keys tx + 8j (j < 8) of every tile,
// and output dims as load_dims.
template <int kDh>
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks)
flash_attention_f32_kernel(const float* __restrict__ q,  // (B*H, T, Dh)
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o, int t, int splits) {
  using L = F32Layout<kDh>;
  constexpr int kStride = L::kStride;
  constexpr int kDv = L::kDv;
  extern __shared__ float4 smem_f32[];
  float* q_s = reinterpret_cast<float*>(smem_f32);
  float* k_s = q_s + L::kK;
  float* v_s = q_s + L::kV;
  float* p_s = q_s + L::kP;

  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int rank = blockIdx.x % splits;
  const int q0 = blockIdx.x / splits * kF32Rows;
  const int n_tiles = (t + kF32Keys - 1) / kF32Keys;
  const int per = (n_tiles + splits - 1) / splits;
  const int first = rank * per;
  const int last = min(n_tiles, first + per);
  const size_t base = static_cast<size_t>(blockIdx.y) * t * kDh;
  const float* qh = q + base;
  const float* kh = k + base;
  const float* vh = v + base;

  load_rows<kDh, kF32Rows>(q_s, qh, q0, t);
  load_rows<kDh, kF32Keys>(k_s, kh, first * kF32Keys, t);
  cp_async_commit();

  float acc[kF32R][kDv];  // rows ty + 16r
  float m[kF32R], l[kF32R];   // running max; this lane's share of the running sum
#pragma unroll
  for (int r = 0; r < kF32R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < kDv; ++e) acc[r][e] = 0.0f;
  }

  // One K and one V buffer, filled alternately: V_i lands while S_i is
  // computed, K_{i+1} while P_i V_i is.
  for (int i = first; i < last; ++i) {
    cp_async_wait_all();
    __syncthreads();  // K_i has landed; every thread is done with V_{i-1}
    load_rows<kDh, kF32Keys>(v_s, vh, i * kF32Keys, t);
    cp_async_commit();

    // S: rows ty + 16r x keys tx + 8j, summed over d in order
    float s[kF32R][8];
#pragma unroll
    for (int r = 0; r < kF32R; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[r][j] = 0.0f;
    }
#pragma unroll
    for (int d = 0; d < kDh; d += 4) {
      float4 a[kF32R], b[8];
#pragma unroll
      for (int r = 0; r < kF32R; ++r) {
        a[r] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * r) * kStride + d);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = *reinterpret_cast<const float4*>(k_s + (tx + 8 * j) * kStride + d);
      }
#pragma unroll
      for (int r = 0; r < kF32R; ++r) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[r][j] = fmaf(a[r].x, b[j].x, s[r][j]);
          s[r][j] = fmaf(a[r].y, b[j].y, s[r][j]);
          s[r][j] = fmaf(a[r].z, b[j].z, s[r][j]);
          s[r][j] = fmaf(a[r].w, b[j].w, s[r][j]);
        }
      }
    }
    const int k0 = i * kF32Keys;
    if (k0 + kF32Keys > t) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (k0 + tx + 8 * j >= t) {
#pragma unroll
          for (int r = 0; r < kF32R; ++r) s[r][j] = -INFINITY;
        }
      }
    }
    // key k0 is real, so every new max is finite, and expf(-inf) = 0 clears
    // the empty start state
#pragma unroll
    for (int r = 0; r < kF32R; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[r][j]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float mn = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < kDv; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[r][j] = expf(s[r][j] - mn);
        l[r] += s[r][j];
      }
    }
    // P[key][kF32R * ty + r] holds row ty + 16r, so a thread reads its rows'
    // p as kF32R / 4 float4s
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < kF32R; r += 4) {
        *reinterpret_cast<float4*>(p_s + (tx + 8 * j) * kF32PStride + kF32R * ty + r) =
            make_float4(s[r][j], s[r + 1][j], s[r + 2][j], s[r + 3][j]);
      }
    }

    cp_async_wait_all();
    __syncthreads();  // V_i has landed and P is written; every thread is done with K_i
    if (i + 1 < last) load_rows<kDh, kF32Keys>(k_s, kh, (i + 1) * kF32Keys, t);
    cp_async_commit();

    // O += P V over the tile's keys in order (8 keys an unrolled step: 4 ran
    // slower, a full unroll spills)
#pragma unroll 8
    for (int c = 0; c < kF32Keys; ++c) {
      float p[kF32R];
#pragma unroll
      for (int r = 0; r < kF32R; r += 4) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(p_s + c * kF32PStride + kF32R * ty + r);
        p[r] = p4.x; p[r + 1] = p4.y; p[r + 2] = p4.z; p[r + 3] = p4.w;
      }
      float x[kDv];
      load_dims<kDh>(x, v_s + c * kStride, tx);
#pragma unroll
      for (int r = 0; r < kF32R; ++r) {
#pragma unroll
        for (int e = 0; e < kDv; ++e) acc[r][e] = fmaf(p[r], x[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kF32R; ++r) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
  }
  if (splits == 1) {
#pragma unroll
    for (int r = 0; r < kF32R; ++r) {
      const int row = q0 + ty + 16 * r;
      if (row < t) {
        float out[kDv];
#pragma unroll
        for (int e = 0; e < kDv; ++e) out[e] = acc[r][e] / l[r];
        store_dims<kDh>(o + base + static_cast<size_t>(row) * kDh, out, tx);
      }
    }
    return;
  }

  // Key split: publish (m, l, O) of the block's rows over the K and V
  // tiles (the last committed copy group is empty, so nothing lands there),
  // then after one cluster barrier rank r combines rows [r * rows,
  // (r + 1) * rows) from every rank's shared memory, in rank order.
  __syncthreads();
  float* m_s = k_s;
  float* l_s = m_s + kF32Rows;
  float* o_s = l_s + kF32Rows;  // [row][kDh]
#pragma unroll
  for (int r = 0; r < kF32R; ++r) {
    const int row = ty + 16 * r;
    if (tx == 0) {
      m_s[row] = m[r];
      l_s[row] = l[r];
    }
    store_dims<kDh>(o_s + row * kDh, acc[r], tx);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int kVec = kDh / 4;
  const int rows = (kF32Rows + splits - 1) / splits;
  for (int it = threadIdx.x; it < rows * kVec; it += kF32Threads) {
    const int row = rank * rows + it / kVec, c = it % kVec;
    if (row >= kF32Rows || q0 + row >= t) continue;
    float mx = -INFINITY;
    for (int src = 0; src < splits; ++src) {
      mx = fmaxf(mx, *cluster.map_shared_rank(m_s + row, src));
    }
    float sum = 0.0f;
    float4 acc4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int src = 0; src < splits; ++src) {
      const float w = expf(*cluster.map_shared_rank(m_s + row, src) - mx);
      sum = fmaf(*cluster.map_shared_rank(l_s + row, src), w, sum);
      const float4 x =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(o_s + row * kDh + 4 * c, src));
      acc4.x = fmaf(x.x, w, acc4.x);
      acc4.y = fmaf(x.y, w, acc4.y);
      acc4.z = fmaf(x.z, w, acc4.z);
      acc4.w = fmaf(x.w, w, acc4.w);
    }
    *reinterpret_cast<float4*>(o + base + static_cast<size_t>(q0 + row) * kDh + 4 * c) =
        make_float4(acc4.x / sum, acc4.y / sum, acc4.z / sum, acc4.w / sum);
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

template <int kDh>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int t,
               int splits, cudaStream_t stream) {
  const int n_tiles = (t + kF32Keys - 1) / kF32Keys;
  if (splits < 1 || splits > kF32MaxSplit || splits > n_tiles ||
      (splits - 1) * ((n_tiles + splits - 1) / splits) >= n_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);  // a split would get no key tile
  }
  auto kernel = flash_attention_f32_kernel<kDh>;
  constexpr int smem = F32Layout<kDh>::kFloats * static_cast<int>(sizeof(float));
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // the largest carveout, so kF32MinBlocks blocks' shared memory fit on one SM
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    attrs_set = true;
  }
  const dim3 grid((t + kF32Rows - 1) / kF32Rows * splits, bh);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (splits == 1) {
    kernel<<<grid, kF32Threads, smem, stream>>>(qf, kf, vf, of, t, 1);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kF32Threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, qf, kf, vf, of, t, splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the runtime has already loaded.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A (Dh, T, B*H) bf16 tensor map with boxes of (Dh, rows, 1): the T bound
// clips each head's tail, and TMA fills rows past it with zeros.
template <int kDh>
CUresult make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int bh, int t,
                  int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kDh), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kDh) * 2,
                                 static_cast<cuuint64_t>(t) * kDh * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kDh), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = kDh == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : kDh == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kEncodeError = 1000;  // + the CUresult of a failed encode

template <int kDh>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int t,
           cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  CUresult r = make_map<kDh>(encode, &mq, q, bh, t, kBlockM);
  if (r == CUDA_SUCCESS) r = make_map<kDh>(encode, &mk, k, bh, t, kBlockN);
  if (r == CUDA_SUCCESS) r = make_map<kDh>(encode, &mv, v, bh, t, kBlockN);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  auto kernel = flash_attention_wgmma_kernel<kDh>;
  const int smem = Layout<kDh>::kBytes + 1024;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  dim3 grid((t + kBlockM - 1) / kBlockM, bh);
  kernel<<<grid, kThreads, smem, stream>>>(mq, mk, mv, static_cast<uint32_t*>(o), t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. q, k, v, o are contiguous
// (bh, t, dh) bf16, 16-byte aligned; dh 16, 32 or 64; 1 <= bh <= 65535.
// Launches on `stream` without synchronising and returns 0 on success, a
// cudaError_t, or 1000 + the CUresult of a failed tensor-map encode.
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

// The float32 body, same contract: q, k, v, o contiguous (bh, t, dh)
// float32, 16-byte aligned; dh 16, 32 or 64; 1 <= bh <= 65535; and
// `splits`, the blocks of one cluster that share each query block's keys
// (1-8, each given at least one 64-key tile; the wrapper's planner picks
// it). Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_f32_launch(const void* q, const void* k, const void* v,
                                          void* o, int bh, int t, int dh, int splits,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_f32<16>(q, k, v, o, bh, t, splits, s);
    case 32: return launch_f32<32>(q, k, v, o, bh, t, splits, s);
    case 64: return launch_f32<64>(q, k, v, o, bh, t, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
