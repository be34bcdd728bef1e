// Flash attention on Hopper's tensor cores (sm_90a): the serving prefill's
// attention for bf16 with a head width hd % 8 == 0 and hd <= 256.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas
// (kernel body _attn_kernel) on that route; flash_attention.cu keeps the
// SIMT kernel for f32 (TF32 would miss the f32 tolerance) and for hd % 8
// != 0 (TMA needs every global stride to be a multiple of 16 bytes).  Same
// contract: q (B, T, H, hd); k, v (B, S, Hkv, hd), bf16, contiguous -> out
// (B, T, H, hd) bf16.  Scale 1/sqrt(hd); q head h reads kv head
// h / (H / Hkv); key positions start at 0, query positions at q_off (0
// but for a shard of the query rows); causal keeps k_pos <= q_pos, window
// > 0 keeps q_pos - k_pos < window; masked scores get
// probability 0 and the sum is clamped at 1e-30, so a row with no valid key
// gives 0.  T and S take any length.
//
// Grid (ceil(T / 128), H, B), 384 threads in 3 warpgroups; one block owns
// 128 query rows of one (head, batch) and walks the BN-token key/value
// tiles that some row of it can see (the causal and window skip; q tiles
// in reverse, the longest first).  HDP, the head width in shared memory,
// is 64, 128 or 256; BN is 128, or 64 at HDP 256.
//  - Warpgroup 2, the producer, gives its registers away (setmaxnreg.dec)
//    and one thread issues TMA loads from 4-D tensor maps over q (B, T, H,
//    hd) and k, v (B, S, Hkv, hd): boxes of 64 hd x 1 head x 128 (q) or
//    BN (k, v) tokens, 128-byte swizzle, so a tile is HDP / 64 panels of
//    128 or BN rows x 128 bytes.  TMA zero-fills past the tensor's edge:
//    hd 96 pads to 128, hd 16 to 64, hd 160 to 256, tokens past T and S
//    read as 0 (the mask still decides validity).  Q is loaded once; K and
//    V go through a ring of STAGES stages with full/empty mbarriers.
//    Shared memory at HDP 128: 32 KB of Q + 3 x (32 + 32) KB; at HDP 256:
//    64 KB of Q + 2 x (32 + 32) KB (three stages, or 128-token tiles,
//    would pass the 227 KB a block may hold).
//  - Warpgroups 0 and 1, the consumers (setmaxnreg.inc), own 64 query rows
//    each.  S = Q K^T is wgmma m64nBNk16 with both operands in shared
//    memory, K-major, HDP / 16 steps.  Online softmax on the f32
//    accumulator in registers: a row lives in the 4 lanes of a quad (max by
//    shfl_xor 1, 2; the sum stays per lane until the end); the mask comes
//    from each register's (row, column), only on tiles that need it;
//    exp2f with scale * log2(e) folded in.  P is rounded to bf16 in
//    registers, where the accumulator's layout already is wgmma's register
//    A fragment, and O += P V is wgmma m64nHDPk16 (at HDP 256, two of
//    m64n128k16, one for each half of O) with V read from shared memory
//    MN-major (the transpose bit), so V is never transposed.  A consumer
//    thread holds BN / 2 scores and HDP / 2 output values: 32 + 128 at
//    HDP 256, which the 64-token tiles keep within its 232 registers.  The
//    next tile's Q K^T is issued right behind P V, and one wait covers both.
//  - Epilogue: O / max(l, 1e-30) to bf16, stored from registers, rows < T
//    and dims < hd only.
//
// Bound: operations, 4 * hd flops per valid (query head, q, k) pair at 989
// TFLOP/s in bf16, at prefill lengths.  What holds this design back from
// it: within a consumer the softmax waits for S, and the tensor cores wait
// for the softmax (no ping-pong scheduling of the two consumers, no
// second S buffer to run one tile's softmax beside the next tile's
// Q K^T), and the grid is not persistent, so the last wave of blocks runs
// part-empty.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;              // query rows per block
constexpr int THREADS = 384;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}
// Wait until the barrier's phase with this parity completes.  (No trap
// after a bound: a trap path makes ptxas spill the consumers' registers.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// ------------------------------------------------------------------ TMA
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1): start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D (64 x 128, f32) += A (64 x 16, shared) * B (16 x 128, shared), both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, shared) * B (16 x 64, shared), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, shared,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, shared,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// 2^x in one MUFU instruction, subnormals flushed (the library's exp2f
// adds a range fix-up without --use_fast_math, which the codec forbids).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x in one MUFU instruction: IEEE division calls a slow-path
// subroutine, and a call makes the consumers save registers to the stack.
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The tiles of one head width: panels of 64 dims (128 bytes a row,
// swizzled), a Q tile of BM rows and K/V tiles of BN rows.
template <int HDP>
struct Tiles {
  static constexpr int BN = HDP == 256 ? 64 : 128;  // tokens per K/V tile
  static constexpr int STAGES = HDP == 256 ? 2 : 3;
  static constexpr int NP = HDP / 64;               // panels of 64 dims
  static constexpr int Q_PANEL = BM * 128;
  static constexpr int KV_PANEL = BN * 128;
  static constexpr int Q_TILE = NP * Q_PANEL;
  static constexpr int KV_TILE = NP * KV_PANEL;
  static constexpr int BYTES = Q_TILE + 2 * STAGES * KV_TILE;  // then bars
  static constexpr int SMEM = BYTES + 8 * (1 + 2 * STAGES) + 1024;
};

// Issue S = Q K^T (64 x BN) for one consumer warpgroup: HDP / 16 steps of
// 16 dims, both operands K-major in 128-byte-swizzled panels of 64 dims
// (8 rows of 128 bytes every 1024 bytes: SBO); a step moves 32 bytes
// along the row, a panel Q_PANEL or KV_PANEL on.
template <int HDP>
__device__ __forceinline__ void issue_qk(float (&s)[Tiles<HDP>::BN / 2],
                                         uint32_t q_addr, uint32_t k_addr) {
  using L = Tiles<HDP>;
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint64_t dq = smem_desc(
        q_addr + (kk / 4) * L::Q_PANEL + (kk % 4) * 32, 16, 1024);
    const uint64_t dk = smem_desc(
        k_addr + (kk / 4) * L::KV_PANEL + (kk % 4) * 32, 16, 1024);
    if constexpr (L::BN == 128) wgmma_ss_n128(s, dq, dk, kk > 0);
    else wgmma_ss_n64(s, dq, dk, kk > 0);
  }
  wg_commit();
}

// Where one block's tiles and barriers lie in shared memory, and which
// query rows, head and key tiles it owns.
template <int HDP>
struct Block {
  uint8_t *q_s, *k_s, *v_s;       // Q, then STAGES K and STAGES V tiles
  uint64_t *q_full, *full, *empty;
  int q0, h, b, g, kt_lo, n_tiles;
  __device__ __forceinline__ Block(int T_len, int S, int H, int Hkv,
                                   int causal, int window, int q_off) {
    extern __shared__ uint8_t smem_raw[];
    // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    using L = Tiles<HDP>;
    q_s = smem;
    k_s = smem + L::Q_TILE;
    v_s = k_s + L::STAGES * L::KV_TILE;
    q_full = reinterpret_cast<uint64_t*>(smem + L::BYTES);
    full = q_full + 1;
    empty = full + L::STAGES;
    q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // the longest rows first
    h = blockIdx.y;
    b = blockIdx.z;
    g = h / (H / Hkv);
    // keys some row of this block can see: tiles [kt_lo, kt_lo + n_tiles)
    const int hi = causal ? min(S, q_off + q0 + BM) : S;
    const int lo = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
    kt_lo = lo / L::BN;
    n_tiles = max(0, (hi + L::BN - 1) / L::BN - kt_lo);
  }
};

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ out, int T_len, int S,
                          int H, int Hkv, int hd, float scale_log2,
                          int causal, int window, int q_off) {
  if (threadIdx.x == 0) {
    const Block<HDP> blk(T_len, S, H, Hkv, causal, window, q_off);
    mbar_init(blk.q_full, 1);
    for (int st = 0; st < Tiles<HDP>::STAGES; ++st) {
      mbar_init(&blk.full[st], 1);
      mbar_init(&blk.empty[st], 2 * 128);   // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Each role derives the block's layout anew after its setmaxnreg, so no
  // value lives across the register reallocation.
  if (threadIdx.x / 128 == 2) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const Block<HDP> blk(T_len, S, H, Hkv, causal, window, q_off);
    using L = Tiles<HDP>;
    if (threadIdx.x == 256) {
      mbar_expect_tx(blk.q_full, L::Q_TILE);
#pragma unroll
      for (int p = 0; p < L::NP; ++p)
        tma_load(blk.q_s + p * L::Q_PANEL, &tq, blk.q_full, p * 64, blk.h,
                 blk.q0, blk.b);
      for (int it = 0; it < blk.n_tiles; ++it) {
        const int st = it % L::STAGES, ph = (it / L::STAGES) & 1;
        const int k0 = (blk.kt_lo + it) * L::BN;
        mbar_wait(&blk.empty[st], ph ^ 1);      // the first pass is free
        mbar_expect_tx(&blk.full[st], 2 * L::KV_TILE);
#pragma unroll
        for (int p = 0; p < L::NP; ++p) {
          const int off = st * L::KV_TILE + p * L::KV_PANEL;
          tma_load(blk.k_s + off, &tk, &blk.full[st], p * 64, blk.g, k0,
                   blk.b);
          tma_load(blk.v_s + off, &tv, &blk.full[st], p * 64, blk.g, k0,
                   blk.b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const Block<HDP> blk(T_len, S, H, Hkv, causal, window, q_off);
    using L = Tiles<HDP>;
    constexpr int BN = L::BN, NS = BN / 2;       // scores a thread holds
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // this thread's rows (of the block) are r0 and r0 + 8, and its
    // columns in each 8-wide group are 2 * (lane % 4) and that + 1
    const int r0 = wg * 64 + warp * 16 + lane / 4;
    const int qa = blk.q0 + r0, qb = qa + 8;        // their rows
    const int pos_a = q_off + qa, pos_b = pos_a + 8;   // and positions
    const int cq = 2 * (lane % 4);
    const int wg_lo = q_off + blk.q0 + wg * 64, wg_hi = wg_lo + 63;

    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
    const uint32_t q_addr = smem_u32(blk.q_s) + wg * 64 * 128;

    float s[NS];
    mbar_wait(blk.q_full, 0);
    if (blk.n_tiles > 0) {
      mbar_wait(&blk.full[0], 0);
      issue_qk<HDP>(s, q_addr, smem_u32(blk.k_s));
      wg_wait();
      fence_regs(s);
    }
    for (int it = 0; it < blk.n_tiles; ++it) {
      const int st = it % L::STAGES;
      const int k0 = (blk.kt_lo + it) * BN;

      // online softmax; s[i] sits at row r0 + 8 * ((i / 2) % 2), column
      // k0 + cq + c(i) with c(i) = 8 * (i / 4) + i % 2, a constant: key
      // k0 + cq + c is valid for query qp iff c < S - k0 - cq, c <= qp - k0
      // - cq (causal) and c > qp - window - k0 - cq (window)
      const bool masked = k0 + BN > S || (causal && k0 + BN - 1 > wg_lo)
                          || (window > 0 && wg_hi - k0 >= window);
      float mx_a = NEG_INF, mx_b = NEG_INF;
      if (masked) {
        const int base = k0 + cq, c_s = S - base;
        const int ca_hi = causal ? pos_a - base : BN;
        const int cb_hi = causal ? pos_b - base : BN;
        const int ca_lo = window > 0 ? pos_a - window - base : -1;
        const int cb_lo = window > 0 ? pos_b - window - base : -1;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int c = 8 * (i / 4) + i % 2;
          const bool row_b = (i / 2) % 2;
          const bool ok = c < c_s && c <= (row_b ? cb_hi : ca_hi)
                          && c > (row_b ? cb_lo : ca_lo);
          s[i] = ok ? s[i] * scale_log2 : NEG_INF;
        }
      } else {
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] *= scale_log2;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if ((i / 2) % 2) mx_b = fmaxf(mx_b, s[i]);
        else mx_a = fmaxf(mx_a, s[i]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float c_a = ex2(m_a - mn_a), c_b = ex2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
      // P in bf16, packed in pairs: pa[4 kk .. 4 kk + 3] (keys 16 kk ..
      // 16 kk + 15) is wgmma's A fragment kk just as the accumulator lies
      uint32_t pa[NS / 2];
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const float mn = (i / 2) % 2 ? mn_b : mn_a;
        const float p0 = s[i] == NEG_INF ? 0.f : ex2(s[i] - mn);
        const float p1 = s[i + 1] == NEG_INF ? 0.f : ex2(s[i + 1] - mn);
        if ((i / 2) % 2) sum_b += p0 + p1; else sum_a += p0 + p1;
        pa[i / 2] = pack_bf16(p0, p1);
      }
      l_a = l_a * c_a + sum_a;       // per lane; the quad is summed at the end
      l_b = l_b * c_b + sum_b;
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) o[i] *= (i / 2) % 2 ? c_b : c_a;

      // O += P V: V is (tokens x dims), dims contiguous = MN-major B;
      // 16 tokens a step (2 KB), the next 64 dims one panel on (LBO); at
      // HDP 256 the second half of O starts two panels on.  The next
      // tile's Q K^T is issued behind it, so the tensor cores run both
      // while this warpgroup waits once.
      const uint32_t v_addr = smem_u32(blk.v_s + st * L::KV_TILE);
      fence_regs(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t vk = v_addr + kk * 16 * 128;
        const uint64_t dv = smem_desc(vk, L::KV_PANEL, 1024);
        if constexpr (HDP == 256) {
          wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o), pa + 4 * kk, dv);
          wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o + 64), pa + 4 * kk,
                        smem_desc(vk + 2 * L::KV_PANEL, L::KV_PANEL, 1024));
        } else if constexpr (HDP == 128) {
          wgmma_rs_n128(o, pa + 4 * kk, dv);
        } else {
          wgmma_rs_n64(o, pa + 4 * kk, dv);
        }
      }
      wg_commit();
      if (it + 1 < blk.n_tiles) {
        const int nx = (it + 1) % L::STAGES;
        mbar_wait(&blk.full[nx], ((it + 1) / L::STAGES) & 1);
        issue_qk<HDP>(s, q_addr, smem_u32(blk.k_s + nx * L::KV_TILE));
      }
      wg_wait();
      fence_regs(o);
      fence_regs(s);
      mbar_arrive(&blk.empty[st]);
    }

    // epilogue: O / max(l, 1e-30) in bf16, rows < T, dims < hd
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = rcp(fmaxf(l_a, 1e-30f));
    const float inv_b = rcp(fmaxf(l_b, 1e-30f));
#pragma unroll
    for (int i = 0; i < HDP / 2; i += 2) {
      const bool row_b = (i / 2) % 2;
      const int qp = row_b ? qb : qa;
      const int d = 8 * (i / 4) + cq;
      if (qp < T_len && d < hd) {
        const float inv = row_b ? inv_b : inv_a;
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)blk.b * T_len + qp) * H + blk.h) * hd + d) =
            __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
      }
    }
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.  0 when the driver has none.
EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// A (B, n_tok, n_head, hd) bf16 tensor as a 4-D map, boxes of 64 dims x 1
// head x box_tok tokens, 128-byte swizzle, zeros past every edge.
int encode(CUtensorMap* map, const void* ptr, int B, int n_tok, int n_head,
           int hd, int box_tok) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)n_head,
                              (cuuint64_t)n_tok, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)n_head * hd * 2,
                                 (cuuint64_t)n_tok * n_head * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_tok, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T_len, int S, int H, int Hkv, int hd, float scale, int causal,
           int window, int q_off, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, B, T_len, H, hd, BM);
  if (rc == 0) rc = encode(&tk, k, B, S, Hkv, hd, Tiles<HDP>::BN);
  if (rc == 0) rc = encode(&tv, v, B, S, Hkv, hd, Tiles<HDP>::BN);
  if (rc != 0) return rc;
  constexpr int smem = Tiles<HDP>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_tc_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_len + BM - 1) / BM, H, B);
  flash_attention_tc_kernel<HDP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), T_len, S, H, Hkv, hd,
      scale * LOG2E, causal, window, q_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 only; hd % 8 == 0, S > 0, 16-byte aligned pointers (the wrapper
// checks); q_off the position of query row 0; hdp, the padded head width
// in shared memory, 64 (hd <= 64), 128
// (hd <= 128) or 256 (hd <= 256).  Returns 0, a CUDA error, or
// cudaErrorInvalidValue for another hdp or when a tensor map could not be
// encoded.
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* out, int B, int T_len, int S, int H,
                              int Hkv, int hd, int hdp, float scale,
                              int causal, int window, int q_off,
                              void* stream) {
  if ((hdp != 64 && hdp != 128 && hdp != 256) || hd > hdp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TC_LAUNCH(HDP)                                                       \
  return launch<HDP>(q, k, v, out, B, T_len, S, H, Hkv, hd, scale, causal,   \
                     window, q_off, s)
  if (hdp == 64) TC_LAUNCH(64);
  if (hdp == 128) TC_LAUNCH(128);
  TC_LAUNCH(256);
#undef TC_LAUNCH
}

}  // extern "C"
