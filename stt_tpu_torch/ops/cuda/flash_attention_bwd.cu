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
// P and dS are rounded to the input type before the three products, as the
// TPU bodies round them (p.T.astype(do.dtype), ds.T.astype(do.dtype),
// ds.astype(k.dtype)); a no-op in float32. Every sum is float32 and each
// gradient rounds once at the store.
//
// Two kernels, as on the TPU, so that no sum crosses blocks and nothing is
// atomic: a dK/dV kernel whose block owns a run of keys and walks every
// query tile, and a dQ kernel whose block owns a run of query rows and walks
// every key tile; both recompute P from lse. Sums run in a fixed order, so
// repeated calls are bit-identical. The split recomputes S and dP in both
// kernels: 14*T^2*Dh flops per (b, h) against a fused backward's 10.
//
// What bounds them on the H100: dK/dV does 8*T^2*Dh flops per (b, h) (S,
// dP, dV, dK) and dQ 6*T^2*Dh (S, dP, dQ), against ~10*T*Dh values moved,
// so both are bound by arithmetic: at 4 x 12 x 1500 x 64, 0.056 ms and
// 0.042 ms at the 989 TFLOP/s bf16 tensor-core peak, 0.83 ms and 0.62 ms at
// the 67 TFLOP/s float32 CUDA-core peak. Each type has its own body.
//
// The bf16 bodies (the design of flash_attention.cu's bf16 body):
//   - warp specialisation: consumer warpgroups of 64 keys (dK/dV, two a
//     block: 288 threads, up to 224 registers each, which its two float32
//     sums and two score tiles need) or 64 query rows (dQ, three a block:
//     416 threads, up to 152 registers), so each streamed tile serves 128
//     keys or 192 rows, and one producer warp; 1 block a SM (on the H100,
//     dQ ran clearly slower with two warpgroups, and dK/dV with three
//     spilled and ran slower);
//   - TMA: the producer loads the block's own tiles once (K and V; or Q and
//     dO) and streams 64-row tiles of the others (Q and dO; or K and V)
//     into a 4-stage ring, each stage with a full barrier (the TMA's byte
//     count) and an empty barrier the consumers' warps arrive on. The
//     tensors are described as 3-D (Dh, T, B*H), so the T bound clips per
//     head and rows past T arrive as zeros (1500 = 23*64 + 28); rows are
//     Dh*2 bytes and the tiles use the swizzle of that width, the layout
//     wgmma reads;
//   - dK/dV computes in transposed form, so nothing is transposed in memory:
//     S^T = K Q^T and dP^T = V dO^T on wgmma m64n64k16 (A and B both
//     K-major from the swizzled tiles); P^T = exp2(s*log2e - lse*log2e)
//     (ex2.approx, lse pre-scaled by the producer, +inf for rows past T,
//     so they give P = 0) and dS^T = P^T (dP^T - di) stay in registers, lse
//     and di broadcast along the accumulator's columns; rounded to bf16
//     and repacked in registers they are the A operands of dV += P^T dO and
//     dK += dS^T Q on wgmma m64nDhk16, whose B (dO, Q) is read MN-major
//     through wgmma's transpose bit. The producer warp's lanes write each
//     stage's lse and di beside its TMA copies and arrive on its barrier;
//   - dQ: S = Q K^T and dP = dO V^T on wgmma; keys past T score -inf; dS in
//     registers, rounded to bf16, is the A operand of dQ += dS K, K read
//     MN-major;
//   - dK, dV and dQ accumulate in float32 registers; neither P nor dS
//     touches shared memory. Rows and keys past T are never stored.
//
// The float32 bodies stay on the CUDA cores, with nothing rounded below
// float32 (no TF32), and follow the forward float32 body's recipe: an SM
// moves 128 bytes a clock from shared memory into registers while its FMA
// pipes do 128 FMAs, so a thread that loads r + c floats for an r x c block
// of FMAs keeps both level only at r*c/(r+c) >= 4: every product here runs
// in 8 x 8 register micro-tiles read as float4 from rows padded to Dh + 4
// floats, so 8 consecutive rows hit 8 distinct bank groups. A thread holds
// 64 sums, 64 scores and 64 loaded values (up to 255 registers), so the
// ~200 KB of tiles a block needs leave room for one block a SM; blocks are
// 256 threads, two teams of 128, so that each SM still runs 8 warps:
//   - dK/dV owns 64 keys and walks 128-row query tiles. Team 0 computes S^T
//     and team 1 dP^T at once, 8 keys x 8 rows a thread; P goes to a shared
//     [row][key slot] tile, team 1 reads its P back from the same slots for
//     dS, which goes to a second one; then four 64-thread groups sum dV and
//     dK over the tile's two 64-row halves, each thread 8 keys x 8 dims,
//     reading 8 keys of P or dS and 8 dims of dO or Q as float4s at each
//     row. The halves' sums are added once, at the end;
//   - dQ owns 128 rows and walks 128-key tiles, team 0 taking the first 64
//     keys of each and team 1 the rest: dP, then S -> P -> dS, 8 rows x 8
//     keys a thread in a shared [key][row slot] tile, then dQ += dS K as the
//     forward's O += P V; the two teams' sums are added once, at the end;
//   - the next tiles are copied by 16-byte cp.async.cg (4-byte cp.async.ca
//     for lse and di), zero-filled past T, while others are computed:
//     dK/dV double-buffers Q (and lse, di) and reloads dO after each tile;
//     dQ loads V_{i+1} during S_i and dQ_i, and K_{i+1} during dP_{i+1};
//   - the score loop is unrolled only twice, and dK/dV's teams and groups
//     share one call site each: fully unrolled copies (~70 KB of SASS each
//     at Dh 64) overflowed the instruction cache, and dQ with two of them
//     ran at about half the speed on the H100. Query rows past T give P = 0
//     by index; in dQ keys past T do.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---- TMA, mbarrier and wgmma helpers (as in flash_attention.cu) ----------

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

// d (+)= A B for one m64n64k16 step, A and B read from shared memory
// through descriptors, both K-major; accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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

// d += A B for one m64n32k16 step, as above.
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

// d += A B for one m64n64k16 step, as above.
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

// d += A B, Dh columns: A a (64, 16) bf16 fragment in registers, B 16 rows
// of a (rows, Dh) tile read MN-major.
template <int kDh>
__device__ __forceinline__ void wgmma_rs(float (&d)[kDh / 2], const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n16(d, a, db);
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n32(d, a, db);
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}

// 2^x on the special-function unit, subnormal results flushed to zero.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- bf16 bodies: wgmma + TMA --------------------------------------------

constexpr int kDkvConsumers = 2;   // dK/dV's warpgroups of 64 keys
constexpr int kDqConsumers = 3;    // dQ's warpgroups of 64 query rows
constexpr int kTile = 64;          // rows of a streamed tile
constexpr int kStages = 4;         // ring depth

// kWg consumer warpgroups, then the producer warp
constexpr int threads_of(int kWg) { return 128 * kWg + 32; }

template <int kDh, int kWg>
struct Layout {
  static constexpr int kBlock = 64 * kWg;                // keys (dK/dV) or rows (dQ) a block owns
  static constexpr int kRowBytes = kDh * 2;
  static constexpr int kOwnBytes = kBlock * kRowBytes;   // one tile the block keeps
  static constexpr int kTileBytes = kTile * kRowBytes;   // one streamed tile
  // the block's two own tiles, then two rings of streamed tiles
  static constexpr int kBytes = 2 * kOwnBytes + 2 * kStages * kTileBytes;
  // 8 rows of one swizzle atom: the descriptors' stride between row groups
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;
  // wgmma descriptor layout code (1 = 128B, 2 = 64B, 3 = 32B swizzle)
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
};

// S (+)= A B^T over Dh for a 64 x 64 tile: A and B 64 rows of Dh, K-major.
template <int kDh>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a, uint32_t b) {
  using L = Layout<kDh, 1>;
#pragma unroll
  for (int kc = 0; kc < kDh / 16; ++kc) {
    wgmma_ss_n64(d, wgmma_desc<L::kSwizzle>(a + kc * 32, 16, L::kGroupBytes),
                 wgmma_desc<L::kSwizzle>(b + kc * 32, 16, L::kGroupBytes), kc > 0);
  }
}

// d += A B over a 64-row tile: A four (64, 16) fragments, B the tile's
// (64, Dh) rows read MN-major, 16 rows a step.
template <int kDh>
__device__ __forceinline__ void tile_product(float (&d)[kDh / 2], const uint32_t (&a)[4][4],
                                             uint32_t b) {
  using L = Layout<kDh, 1>;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    wgmma_rs<kDh>(d, a[kk], wgmma_desc<L::kSwizzle>(b + kk * 16 * L::kRowBytes,
                                                    L::kGroupBytes, L::kGroupBytes));
  }
}

// Stores one warpgroup's (64, Dh) float32 accumulator as bf16 rows r0 + ...
// of one head, rows >= t skipped. d[4j + e] is row 16*warp + g + 8*(e/2),
// column 8j + 2*tq + (e%2).
template <int kDh>
__device__ __forceinline__ void store_rows(uint32_t* out, const float (&d)[kDh / 2], int r0,
                                           int t) {
  const int lane = threadIdx.x % 32;
  const int row0 = r0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int row1 = row0 + 8;
  const int tq = lane % 4;
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    const int w = j * 4 + tq;
    if (row0 < t) out[static_cast<size_t>(row0) * (kDh / 2) + w] = pack_bf16(d[4 * j], d[4 * j + 1]);
    if (row1 < t) {
      out[static_cast<size_t>(row1) * (kDh / 2) + w] = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

// Grid (ceil(t / 64kWg), B*H). Block x owns keys k0 = 64kWg x .. + 64kWg - 1;
// consumer warpgroup wg keys k0 + 64wg .. + 63.
template <int kDh, int kWg>
__global__ void __launch_bounds__(threads_of(kWg), 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,    // 64-row boxes
                           const __grid_constant__ CUtensorMap map_k,    // 64kWg-row boxes
                           const __grid_constant__ CUtensorMap map_v,    // 64kWg-row boxes
                           const __grid_constant__ CUtensorMap map_do,   // 64-row boxes
                           const float* __restrict__ lse,   // (B*H, T)
                           const float* __restrict__ di,    // (B*H, T)
                           uint32_t* __restrict__ dk,       // (B*H, T, Dh) bf16 pairs
                           uint32_t* __restrict__ dv,
                           int t) {
  using L = Layout<kDh, kWg>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ __align__(16) float lse_s[kStages][kTile];  // lse * log2(e); +inf past t
  __shared__ __align__(16) float di_s[kStages][kTile];   // di; 0 past t

  // the swizzled tiles need 1024-byte alignment (the launch asks 1 KB extra)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = smem;
  uint8_t* v_s = k_s + L::kOwnBytes;
  uint8_t* q_s = v_s + L::kOwnBytes;
  uint8_t* do_s = q_s + kStages * L::kTileBytes;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * L::kBlock;
  const int n_tiles = (t + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer's 32 lanes, and the TMA bytes
      mbar_init(&empty[s], 4 * kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kWg) {
    // ---- producer warp: lane 0 starts every TMA copy; each lane writes two
    // rows of the stage's lse and di, then arrives ----
    const int lane = threadIdx.x % 32;
    const size_t rbase = static_cast<size_t>(bh) * t;
    if (lane == 0) {
      mbar_expect_tx(&kv_full, 2 * L::kOwnBytes);
      tma_load(k_s, &map_k, &kv_full, k0, bh);
      tma_load(v_s, &map_v, &kv_full, k0, bh);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
      for (int j = lane; j < kTile; j += 32) {
        const int r = i * kTile + j;
        lse_s[s][j] = r < t ? lse[rbase + r] * kLog2e : INFINITY;  // P = 0 past t
        di_s[s][j] = r < t ? di[rbase + r] : 0.0f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * L::kTileBytes);
        tma_load(q_s + s * L::kTileBytes, &map_q, &full[s], i * kTile, bh);
        tma_load(do_s + s * L::kTileBytes, &map_do, &full[s], i * kTile, bh);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: keys k0 + 64*wg .. +63 ----
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;  // column pair within each 8-column block
  const uint32_t k_addr = smem_u32(k_s) + wg * 64 * L::kRowBytes;
  const uint32_t v_addr = smem_u32(v_s) + wg * 64 * L::kRowBytes;

  float dk_acc[kDh / 2], dv_acc[kDh / 2];
#pragma unroll
  for (int i = 0; i < kDh / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  mbar_wait(&kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const uint32_t qs = smem_u32(q_s) + s * L::kTileBytes;
    const uint32_t dos = smem_u32(do_s) + s * L::kTileBytes;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 query rows each
    float st[32], dpt[32];
    mbar_wait(&full[s], parity);
    wgmma_fence();
    scores<kDh>(st, k_addr, qs);
    scores<kDh>(dpt, v_addr, dos);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // st[4j + e]: key g + 8*(e/2) of the warp's 16, query row 8j + 2*tq +
    // (e%2) of the tile. P^T and dS^T, rounded to bf16, become the A
    // fragments of the next products: step kk covers rows 16kk..16kk+15 =
    // accumulator blocks 2kk, 2kk+1
    uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(&lse_s[s][8 * j + 2 * tq]);
      const float2 dd = *reinterpret_cast<const float2*>(&di_s[s][8 * j + 2 * tq]);
      const float p0 = exp2_ftz(fmaf(st[4 * j], kLog2e, -l2.x));
      const float p1 = exp2_ftz(fmaf(st[4 * j + 1], kLog2e, -l2.y));
      const float p2 = exp2_ftz(fmaf(st[4 * j + 2], kLog2e, -l2.x));
      const float p3 = exp2_ftz(fmaf(st[4 * j + 3], kLog2e, -l2.y));
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      dsa[j / 2][(j % 2) * 2] = pack_bf16(p0 * (dpt[4 * j] - dd.x), p1 * (dpt[4 * j + 1] - dd.y));
      dsa[j / 2][(j % 2) * 2 + 1] =
          pack_bf16(p2 * (dpt[4 * j + 2] - dd.x), p3 * (dpt[4 * j + 3] - dd.y));
    }

    // dV += P^T dO and dK += dS^T Q: Dh columns, 4 steps of 16 rows each
    wgmma_fence();
    tile_product<kDh>(dv_acc, pa, dos);
    tile_product<kDh>(dk_acc, dsa, qs);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t base = static_cast<size_t>(bh) * t * (kDh / 2);
  store_rows<kDh>(dk + base, dk_acc, k0 + wg * 64, t);
  store_rows<kDh>(dv + base, dv_acc, k0 + wg * 64, t);
}

// Grid (ceil(t / 64kWg), B*H). Block x owns query rows q0 = 64kWg x ..
// + 64kWg - 1; consumer warpgroup wg rows q0 + 64wg .. + 63.
template <int kDh, int kWg>
__global__ void __launch_bounds__(threads_of(kWg), 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,    // 64kWg-row boxes
                          const __grid_constant__ CUtensorMap map_k,    // 64-row boxes
                          const __grid_constant__ CUtensorMap map_v,    // 64-row boxes
                          const __grid_constant__ CUtensorMap map_do,   // 64kWg-row boxes
                          const float* __restrict__ lse,
                          const float* __restrict__ di,
                          uint32_t* __restrict__ dq,
                          int t) {
  using L = Layout<kDh, kWg>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];

  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* do_s = q_s + L::kOwnBytes;
  uint8_t* k_s = do_s + L::kOwnBytes;
  uint8_t* v_s = k_s + kStages * L::kTileBytes;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * L::kBlock;
  const int n_tiles = (t + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kWg) {
    // ---- producer warp: one lane starts every TMA copy ----
    if (threadIdx.x == 128 * kWg) {
      mbar_expect_tx(&q_full, 2 * L::kOwnBytes);
      tma_load(q_s, &map_q, &q_full, q0, bh);
      tma_load(do_s, &map_do, &q_full, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::kTileBytes);
        tma_load(k_s + s * L::kTileBytes, &map_k, &full[s], i * kTile, bh);
        tma_load(v_s + s * L::kTileBytes, &map_v, &full[s], i * kTile, bh);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64*wg .. +63 ----
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * L::kRowBytes;
  const uint32_t do_addr = smem_u32(do_s) + wg * 64 * L::kRowBytes;
  // this thread's rows g and g + 8 of its warp's 16: lse pre-scaled to log2
  // units; rows past t are computed (from zero Q and dO) but never stored
  const int row0 = q0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int row1 = row0 + 8;
  const size_t rbase = static_cast<size_t>(bh) * t;
  const float lse0 = row0 < t ? lse[rbase + row0] * kLog2e : 0.0f;
  const float lse1 = row1 < t ? lse[rbase + row1] * kLog2e : 0.0f;
  const float di0 = row0 < t ? di[rbase + row0] : 0.0f;
  const float di1 = row1 < t ? di[rbase + row1] : 0.0f;

  float acc[kDh / 2];
#pragma unroll
  for (int i = 0; i < kDh / 2; ++i) acc[i] = 0.0f;

  mbar_wait(&q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const uint32_t ks = smem_u32(k_s) + s * L::kTileBytes;
    const uint32_t vs = smem_u32(v_s) + s * L::kTileBytes;

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each
    float sc[32], dp[32];
    mbar_wait(&full[s], parity);
    wgmma_fence();
    scores<kDh>(sc, q_addr, ks);
    scores<kDh>(dp, do_addr, vs);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // sc[4j + e]: row g + 8*(e/2), key 8j + 2*tq + (e%2); keys >= t score -inf
    const int c0 = i * kTile;
    if (c0 + kTile > t) {
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const int c = c0 + 8 * j + 2 * tq;
        if (c >= t) sc[4 * j] = sc[4 * j + 2] = -INFINITY;
        if (c + 1 >= t) sc[4 * j + 1] = sc[4 * j + 3] = -INFINITY;
      }
    }
    uint32_t dsa[kTile / 16][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const float p0 = exp2_ftz(fmaf(sc[4 * j], kLog2e, -lse0));
      const float p1 = exp2_ftz(fmaf(sc[4 * j + 1], kLog2e, -lse0));
      const float p2 = exp2_ftz(fmaf(sc[4 * j + 2], kLog2e, -lse1));
      const float p3 = exp2_ftz(fmaf(sc[4 * j + 3], kLog2e, -lse1));
      dsa[j / 2][(j % 2) * 2] = pack_bf16(p0 * (dp[4 * j] - di0), p1 * (dp[4 * j + 1] - di0));
      dsa[j / 2][(j % 2) * 2 + 1] =
          pack_bf16(p2 * (dp[4 * j + 2] - di1), p3 * (dp[4 * j + 3] - di1));
    }

    // dQ += dS K: Dh columns, 4 steps of 16 keys
    wgmma_fence();
    tile_product<kDh>(acc, dsa, ks);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  store_rows<kDh>(dq + static_cast<size_t>(bh) * t * (kDh / 2), acc, q0 + wg * 64, t);
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

// Four maps: q and dout with `qrows`-row boxes, k and v with `krows`.
template <int kDh>
int make_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
              const void* dout, int bh, int t, int qrows, int krows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUresult r = make_map<kDh>(encode, &maps[0], q, bh, t, qrows);
  if (r == CUDA_SUCCESS) r = make_map<kDh>(encode, &maps[1], k, bh, t, krows);
  if (r == CUDA_SUCCESS) r = make_map<kDh>(encode, &maps[2], v, bh, t, krows);
  if (r == CUDA_SUCCESS) r = make_map<kDh>(encode, &maps[3], dout, bh, t, qrows);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

// Sets a kernel's dynamic shared memory limit (and, for the float32 bodies,
// the largest carveout) once.
template <typename Kernel>
int set_smem(Kernel kernel, int bytes, bool carveout, bool& done) {
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err == cudaSuccess && carveout) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

template <int kDh>
int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* di, void* dk, void* dv, int bh, int t,
                    cudaStream_t stream) {
  using L = Layout<kDh, kDkvConsumers>;
  CUtensorMap maps[4];
  int rc = make_maps<kDh>(maps, q, k, v, dout, bh, t, kTile, L::kBlock);
  if (rc != 0) return rc;
  auto kernel = flash_bwd_dkv_wgmma_kernel<kDh, kDkvConsumers>;
  const int smem = L::kBytes + 1024;
  static bool smem_set = false;
  rc = set_smem(kernel, smem, false, smem_set);
  if (rc != 0) return rc;
  const dim3 grid((t + L::kBlock - 1) / L::kBlock, bh);
  kernel<<<grid, threads_of(kDkvConsumers), smem, stream>>>(maps[0], maps[1], maps[2], maps[3], lse, di,
                                           static_cast<uint32_t*>(dk),
                                           static_cast<uint32_t*>(dv), t);
  return static_cast<int>(cudaGetLastError());
}

template <int kDh>
int launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, void* dq, int bh, int t,
                   cudaStream_t stream) {
  using L = Layout<kDh, kDqConsumers>;
  CUtensorMap maps[4];
  int rc = make_maps<kDh>(maps, q, k, v, dout, bh, t, L::kBlock, kTile);
  if (rc != 0) return rc;
  auto kernel = flash_bwd_dq_wgmma_kernel<kDh, kDqConsumers>;
  const int smem = L::kBytes + 1024;
  static bool smem_set = false;
  rc = set_smem(kernel, smem, false, smem_set);
  if (rc != 0) return rc;
  const dim3 grid((t + L::kBlock - 1) / L::kBlock, bh);
  kernel<<<grid, threads_of(kDqConsumers), smem, stream>>>(maps[0], maps[1], maps[2], maps[3], lse, di,
                                           static_cast<uint32_t*>(dq), t);
  return static_cast<int>(cudaGetLastError());
}

// ---- float32 bodies: CUDA-core FMAs in 8 x 8 register micro-tiles ---------

constexpr int kF32Threads = 256;            // two teams of 128 threads
constexpr int kF32Keys = 64;                // keys a dK/dV block owns; a dQ team's keys of a tile
constexpr int kF32Rows = 128;               // rows of a dK/dV Q/dO tile; rows a dQ block owns
constexpr int kF32PStride = kF32Keys + 4;   // dK/dV's P and dS: [row][key slot], padded
constexpr int kF32DsStride = kF32Rows + 4;  // dQ's dP, then dS: [key][row slot], padded

template <int kDh>
struct F32Layout {
  static constexpr int kStride = kDh + 4;              // a padded row of Q, K, V or dO
  static constexpr int kRowTile = kF32Rows * kStride;  // 128 rows
  static constexpr int kKeyTile = kF32Keys * kStride;  // 64 rows
  static constexpr int kDv = kDh / 8;                  // output dims per thread
  // dK/dV: K, V, two Q tiles, dO, P, dS, two lse and two di tiles
  static constexpr int kDkvFloats =
      2 * kKeyTile + 3 * kRowTile + 2 * kF32Rows * kF32PStride + 4 * kF32Rows;
  // dQ: Q, dO, a 128-key K tile and V tile, dP/dS
  static constexpr int kDqFloats = 4 * kRowTile + 2 * kF32Keys * kF32DsStride;
};

// 16 bytes global -> shared without registers; `real` false zero-fills the
// 16 bytes and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool real) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src)), "r"(real ? 16 : 0)
               : "memory");
}

// The same for 4 bytes (lse and di rows, which need not be 16-byte aligned).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool real) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src)), "r"(real ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
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

// Starts the copy of values [r0, r0 + kF32Rows) of one head's (t,) row of
// lse or di (threads 0-127, one value each); values past t are zero-filled.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0, int t) {
  const int i = threadIdx.x;
  if (i < kF32Rows) {
    const bool real = r0 + i < t;
    cp_async4(dst + i, src + (real ? r0 + i : 0), real);
  }
}

// A thread's kDh / 8 dims of a row: float4s at 32c + 4u (Dh 32, 64), so the
// 8 lanes of a row group read 128 contiguous bytes at once; a float2 at 2u
// (Dh 16).
template <int kDh>
__device__ __forceinline__ void load_dims(float (&x)[kDh / 8], const float* row, int u) {
  if constexpr (kDh >= 32) {
#pragma unroll
    for (int c = 0; c < kDh / 32; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(row + 32 * c + 4 * u);
      x[4 * c] = a.x; x[4 * c + 1] = a.y; x[4 * c + 2] = a.z; x[4 * c + 3] = a.w;
    }
  } else {
    const float2 a = *reinterpret_cast<const float2*>(row + 2 * u);
    x[0] = a.x; x[1] = a.y;
  }
}

template <int kDh>
__device__ __forceinline__ void store_dims(float* row, const float (&x)[kDh / 8], int u) {
  if constexpr (kDh >= 32) {
#pragma unroll
    for (int c = 0; c < kDh / 32; ++c) {
      *reinterpret_cast<float4*>(row + 32 * c + 4 * u) =
          make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
    }
  } else {
    *reinterpret_cast<float2*>(row + 2 * u) = make_float2(x[0], x[1]);
  }
}

// s[r][j] = sum_d a[ty + 16r][d] b[tx + 8j][d] over the head dim, in order:
// 8 float4 of a and 8 of b for 256 FMAs a step of 4 dims. a and b are padded
// tiles; a warp's 4 row groups read 4 consecutive rows of a and its 8 lanes
// 8 consecutive rows of b, all in distinct bank groups. The step loop is
// unrolled only twice (see the file's notes on the instruction cache).
template <int kDh>
__device__ __forceinline__ void micro_scores(float (&s)[8][8], const float* a, const float* b,
                                             int ty, int tx) {
  constexpr int kStride = F32Layout<kDh>::kStride;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[r][j] = 0.0f;
  }
#pragma unroll 2
  for (int d = 0; d < kDh; d += 4) {
    float4 x[8], y[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = *reinterpret_cast<const float4*>(a + (ty + 16 * r) * kStride + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = *reinterpret_cast<const float4*>(b + (tx + 8 * j) * kStride + d);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[r][j] = fmaf(x[r].x, y[j].x, s[r][j]);
        s[r][j] = fmaf(x[r].y, y[j].y, s[r][j]);
        s[r][j] = fmaf(x[r].z, y[j].z, s[r][j]);
        s[r][j] = fmaf(x[r].w, y[j].w, s[r][j]);
      }
    }
  }
}

__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// acc[a][e] += sum_r w[r][slot 8u + a] x[r][dims of v], r over 64 rows in
// order: 8 weights (2 float4) and Dh/8 dims a row, 64 FMAs.
template <int kDh, int kWStride>
__device__ __forceinline__ void micro_sum(float (&acc)[8][kDh / 8], const float* w,
                                          const float* x, int u, int v) {
#pragma unroll 8
  for (int r = 0; r < 64; ++r) {
    float p[8], y[kDh / 8];
    load8(p, w + r * kWStride + 8 * u);
    load_dims<kDh>(y, x + r * F32Layout<kDh>::kStride, v);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int e = 0; e < kDh / 8; ++e) acc[a][e] = fmaf(p[a], y[e], acc[a][e]);
    }
  }
}

// Sum of the two halves' partial sums in a fixed order: threads with `give`
// park theirs in `red` (slot `who` of 64 or 128 threads), the others add them
// after a barrier every thread reaches.
template <int kDh, int kWho>
__device__ __forceinline__ void add_partials(float (&acc)[8][kDh / 8], float* red, bool give,
                                             int who) {
  if (give) {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int e = 0; e < kDh / 8; ++e) red[(a * (kDh / 8) + e) * kWho + who] = acc[a][e];
    }
  }
  __syncthreads();
  if (!give) {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int e = 0; e < kDh / 8; ++e) acc[a][e] += red[(a * (kDh / 8) + e) * kWho + who];
    }
  }
}

// Grid (ceil(t / 64), B*H). Block x owns keys k0 = 64x .. k0 + 63 and walks
// the 128-row query tiles. Threads 128 * team + 8ty + tx: in each tile team
// 0 computes S^T and team 1 dP^T, both as s[b][a] for query rows ty + 16b
// and keys tx + 8a (a, b < 8); key tx + 8a sits in slot 8tx + a of the P
// and dS tiles, so team 1 reads its P back from the same slots. Then the
// four 64-thread groups g = threadIdx.x / 64 sum over rows 64(g % 2) .. +63
// of the tile: dV (g < 2) and dK (g >= 2), thread u = threadIdx.x % 64
// owning keys u/8 + 8a (slots 8(u/8) + a) and dims as load_dims(u % 8). The
// two row halves' sums are added once, at the end.
template <int kDh>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dk, float* __restrict__ dv, int t) {
  using L = F32Layout<kDh>;
  constexpr int kStride = L::kStride;
  constexpr int kDv = L::kDv;
  extern __shared__ float4 smem_f32[];
  float* k_s = reinterpret_cast<float*>(smem_f32);
  float* v_s = k_s + L::kKeyTile;
  float* q_buf = v_s + L::kKeyTile;        // two Q tiles
  float* do_s = q_buf + 2 * L::kRowTile;
  float* p_s = do_s + L::kRowTile;
  float* ds_s = p_s + kF32Rows * kF32PStride;
  float* lse_buf = ds_s + kF32Rows * kF32PStride;  // two tiles each
  float* di_buf = lse_buf + 2 * kF32Rows;

  const int team = threadIdx.x / 128;
  const int tx = threadIdx.x % 8, ty = (threadIdx.x % 128) / 8;
  const int grp = threadIdx.x / 64, u = threadIdx.x % 64;
  const int half = grp % 2;
  const int k0 = blockIdx.x * kF32Keys;
  const size_t base = static_cast<size_t>(blockIdx.y) * t * kDh;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * t;
  const float* qh = q + base;
  const float* doh = dout + base;
  const int n_tiles = (t + kF32Rows - 1) / kF32Rows;

  load_rows<kDh, kF32Keys>(k_s, k + base, k0, t);
  load_rows<kDh, kF32Keys>(v_s, v + base, k0, t);
  load_rows<kDh, kF32Rows>(q_buf, qh, 0, t);
  load_rows<kDh, kF32Rows>(do_s, doh, 0, t);
  load_vec(lse_buf, lse + rbase, 0, t);
  load_vec(di_buf, di + rbase, 0, t);
  cp_async_commit();

  float acc[8][kDv];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int e = 0; e < kDv; ++e) acc[a][e] = 0.0f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = i * kF32Rows;
    const float* q_s = q_buf + (i % 2) * L::kRowTile;
    const float* lse_s = lse_buf + (i % 2) * kF32Rows;
    const float* di_s = di_buf + (i % 2) * kF32Rows;
    cp_async_wait<0>();
    __syncthreads();  // Q_i and dO_i have landed
    if (i + 1 < n_tiles) {
      const int nb = (i + 1) % 2;
      load_rows<kDh, kF32Rows>(q_buf + nb * L::kRowTile, qh, q0 + kF32Rows, t);
      load_vec(lse_buf + nb * kF32Rows, lse + rbase, q0 + kF32Rows, t);
      load_vec(di_buf + nb * kF32Rows, di + rbase, q0 + kF32Rows, t);
    }
    cp_async_commit();

    // team 0: S^T -> P (rows >= t give 0) into the P tile; team 1: dP^T
    float s[8][8];
    micro_scores<kDh>(s, team == 0 ? q_s : do_s, team == 0 ? k_s : v_s, ty, tx);
    if (team == 0) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int r = ty + 16 * b;
        const float l = lse_s[r];
        const bool real = q0 + r < t;
#pragma unroll
        for (int a = 0; a < 8; ++a) s[b][a] = real ? expf(s[b][a] - l) : 0.0f;
        store8(p_s + r * kF32PStride + 8 * tx, s[b]);
      }
    }
    __syncthreads();  // P is written
    if (team == 1) {
      // dS^T = P^T (dP^T - di)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int r = ty + 16 * b;
        const float d = di_s[r];
        float p[8];
        load8(p, p_s + r * kF32PStride + 8 * tx);
#pragma unroll
        for (int a = 0; a < 8; ++a) s[b][a] = p[a] * (s[b][a] - d);
        store8(ds_s + r * kF32PStride + 8 * tx, s[b]);
      }
    }
    __syncthreads();  // dS is written

    // dV += P^T dO (groups 0-1), dK += dS^T Q (groups 2-3), over this
    // group's 64 rows of the tile in order
    const int r0 = 64 * half;
    micro_sum<kDh, kF32PStride>(acc, (grp < 2 ? p_s : ds_s) + r0 * kF32PStride,
                                (grp < 2 ? do_s : q_s) + r0 * kStride, u / 8, u % 8);
    __syncthreads();  // every thread is done with dO_i, P and dS
    if (i + 1 < n_tiles) load_rows<kDh, kF32Rows>(do_s, doh, q0 + kF32Rows, t);
    cp_async_commit();
  }

  // rows 0-63 of every tile, then rows 64-127: the P tile holds the second
  // halves' sums (dV's at 0, dK's at 64 * 8 * kDv)
  add_partials<kDh, 64>(acc, p_s + (grp / 2) * 64 * 8 * kDv, half == 1, u);
  if (half == 0) {
    float* out = (grp < 2 ? dv : dk) + base;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int key = k0 + u / 8 + 8 * a;
      if (key < t) store_dims<kDh>(out + static_cast<size_t>(key) * kDh, acc[a], u % 8);
    }
  }
}

// Grid (ceil(t / 128), B*H). Block x owns query rows q0 = 128x .. q0 + 127
// and walks 128-key K/V tiles, team 0 taking keys 0-63 of each and team 1
// keys 64-127. Thread 128 * team + 8ty + tx owns rows ty + 16r (r < 8); in
// dP and S keys tx + 8j of its team's half (j < 8), in dQ dims as
// load_dims(tx). Key c of the tile holds row ty + 16r of its dP, then dS,
// in slot 8ty + r of the [key][row slot] tile. dP comes first, so that K
// (needed by S and dQ) and V (needed by dP) each load while the other is
// used. The two teams' sums are added once, at the end.
template <int kDh>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        float* __restrict__ dq, int t) {
  using L = F32Layout<kDh>;
  constexpr int kStride = L::kStride;
  constexpr int kDv = L::kDv;
  constexpr int kTileKeys = 2 * kF32Keys;
  extern __shared__ float4 smem_f32[];
  float* q_s = reinterpret_cast<float*>(smem_f32);
  float* do_s = q_s + L::kRowTile;
  float* k_s = do_s + L::kRowTile;  // 128 keys
  float* v_s = k_s + L::kRowTile;
  float* ds_s = v_s + L::kRowTile;

  const int team = threadIdx.x / 128;
  const int tx = threadIdx.x % 8, ty = (threadIdx.x % 128) / 8;
  const int kofs = team * kF32Keys;  // this team's keys within a tile
  const int q0 = blockIdx.x * kF32Rows;
  const size_t base = static_cast<size_t>(blockIdx.y) * t * kDh;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * t;
  const float* kh = k + base;
  const float* vh = v + base;
  const int n_tiles = (t + kTileKeys - 1) / kTileKeys;

  load_rows<kDh, kF32Rows>(q_s, q + base, q0, t);
  load_rows<kDh, kF32Rows>(do_s, dout + base, q0, t);
  load_rows<kDh, kTileKeys>(v_s, vh, 0, t);
  cp_async_commit();
  load_rows<kDh, kTileKeys>(k_s, kh, 0, t);
  cp_async_commit();

  float acc[8][kDv], lse_r[8], di_r[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + ty + 16 * r;
    lse_r[r] = row < t ? lse[rbase + row] : 0.0f;  // rows past t are never stored
    di_r[r] = row < t ? di[rbase + row] : 0.0f;
#pragma unroll
    for (int e = 0; e < kDv; ++e) acc[r][e] = 0.0f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int c0 = i * kTileKeys + kofs;  // this team's first key
    cp_async_wait<1>();
    __syncthreads();  // V_i has landed (K_i may not have); every thread is done with tile i - 1

    // dP: rows ty + 16r x keys kofs + tx + 8j, parked in the dS tile
    float s[8][8];
    micro_scores<kDh>(s, do_s, v_s + kofs * kStride, ty, tx);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) p[r] = s[r][j];
      store8(ds_s + (kofs + tx + 8 * j) * kF32DsStride + 8 * ty, p);
    }

    cp_async_wait<0>();
    __syncthreads();  // K_i has landed; every thread is done with V_i
    if (i + 1 < n_tiles) load_rows<kDh, kTileKeys>(v_s, vh, (i + 1) * kTileKeys, t);
    cp_async_commit();

    // S -> P (keys >= t give 0) -> dS = P (dP - di), dP read back from this
    // thread's slots
    micro_scores<kDh>(s, q_s, k_s + kofs * kStride, ty, tx);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* slot = ds_s + (kofs + tx + 8 * j) * kF32DsStride + 8 * ty;
      const bool real = c0 + tx + 8 * j < t;
      float p[8];
      load8(p, slot);
#pragma unroll
      for (int r = 0; r < 8; ++r) p[r] = (real ? expf(s[r][j] - lse_r[r]) : 0.0f) * (p[r] - di_r[r]);
      store8(slot, p);
    }
    __syncthreads();  // dS is written

    // dQ += dS K over this team's 64 keys of the tile in order
    micro_sum<kDh, kF32DsStride>(acc, ds_s + kofs * kF32DsStride, k_s + kofs * kStride, ty, tx);
    __syncthreads();  // every thread is done with K_i
    if (i + 1 < n_tiles) load_rows<kDh, kTileKeys>(k_s, kh, (i + 1) * kTileKeys, t);
    cp_async_commit();
  }

  // keys 0-63 of every tile, then keys 64-127: the dS tile holds team 1's sums
  add_partials<kDh, 128>(acc, ds_s, team == 1, threadIdx.x % 128);
  if (team == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + ty + 16 * r;
      if (row < t) store_dims<kDh>(dq + base + static_cast<size_t>(row) * kDh, acc[r], tx);
    }
  }
}

template <int kDh>
int launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, void* dk, void* dv, int bh, int t,
                   cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_f32_kernel<kDh>;
  constexpr int smem = F32Layout<kDh>::kDkvFloats * static_cast<int>(sizeof(float));
  static bool smem_set = false;
  const int rc = set_smem(kernel, smem, true, smem_set);
  if (rc != 0) return rc;
  const dim3 grid((t + kF32Keys - 1) / kF32Keys, bh);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, static_cast<float*>(dk), static_cast<float*>(dv),
      t);
  return static_cast<int>(cudaGetLastError());
}

template <int kDh>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* di, void* dq, int bh, int t,
                  cudaStream_t stream) {
  auto kernel = flash_bwd_dq_f32_kernel<kDh>;
  constexpr int smem = F32Layout<kDh>::kDqFloats * static_cast<int>(sizeof(float));
  static bool smem_set = false;
  const int rc = set_smem(kernel, smem, true, smem_set);
  if (rc != 0) return rc;
  const dim3 grid((t + kF32Rows - 1) / kF32Rows, bh);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, static_cast<float*>(dq), t);
  return static_cast<int>(cudaGetLastError());
}

template <int kDh>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* di, void* dk, void* dv, int bh, int t,
               bool bf16, cudaStream_t s) {
  return bf16 ? launch_dkv_bf16<kDh>(q, k, v, dout, lse, di, dk, dv, bh, t, s)
              : launch_dkv_f32<kDh>(q, k, v, dout, lse, di, dk, dv, bh, t, s);
}

template <int kDh>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* di, void* dq, int bh, int t, bool bf16,
              cudaStream_t s) {
  return bf16 ? launch_dq_bf16<kDh>(q, k, v, dout, lse, di, dq, bh, t, s)
              : launch_dq_f32<kDh>(q, k, v, dout, lse, di, dq, bh, t, s);
}

}  // namespace

// Plain C entry points, loaded with ctypes. q, k, v, dout and the outputs
// are contiguous (bh, t, dh) of one type, 16-byte aligned, `bf16` 1 for
// bfloat16 (the wgmma bodies) and 0 for float32 (the CUDA-core bodies); lse
// and di are contiguous (bh, t) float32; dh 16, 32 or 64; 1 <= bh <= 65535.
// Each launches on `stream` without synchronising and returns 0 on success,
// the launch's cudaError_t, or 1000 + the CUresult of a failed tensor-map
// encode (bf16).
extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* di, void* dk, void* dv, int bh,
                                              int t, int dh, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  switch (dh) {
    case 16: return launch_dkv<16>(q, k, v, dout, l, d, dk, dv, bh, t, bf16 != 0, s);
    case 32: return launch_dkv<32>(q, k, v, dout, l, d, dk, dv, bh, t, bf16 != 0, s);
    case 64: return launch_dkv<64>(q, k, v, dout, l, d, dk, dv, bh, t, bf16 != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* di, void* dq, int bh, int t, int dh,
                                             int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  switch (dh) {
    case 16: return launch_dq<16>(q, k, v, dout, l, d, dq, bh, t, bf16 != 0, s);
    case 32: return launch_dq<32>(q, k, v, dout, l, d, dq, bh, t, bf16 != 0, s);
    case 64: return launch_dq<64>(q, k, v, dout, l, d, dq, bh, t, bf16 != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
