// Hopper GEMM behind the weight matmuls of the ViT block kernels: kernel G
// (bf16, B and C; vit_block.cu :: toc3d_gemm, and the patch embedding A's
// product, patch_embed.cu :: toc3d_patchify) and kernel G8 (int8, B8 and
// C8; vit_block.cu :: toc3d_gemm_s8_sm90), one kernel body generic over the
// operand type:
//
//   C[m, n] = epilogue( sum_k A[m, k] * W[n, k] )
//
// A is row-major (M, K) and W a torch Linear weight (N, K), both K-major,
// both bf16 (f32 sums) or both int8 (exact s32 sums); the epilogues are
// those of gemm.cuh's epilogue2 (int8 dequantization, bias, residual, SwiGLU
// gate, f32 out) at the same rounding points, and the blocks' QKV epilogue:
// the f32 value the f32 epilogue stores, q and k rotated by RoPE in f32,
// then bf16, the q / k / v the window attention reads.
//
// Replaces the weight products inside the TPU block kernels,
// toc3d_tpu/ops/pallas/vit_block.py:
//   bf16: the jnp.dot(..., preferred_element_type=f32) of _full_block_kernel
//   via _attention (QKV :113-116, O :150) and _swiglu (w1 / w2 :163-164, w3
//   :176); _compressed_block_kernel (:682) through the same two helpers on
//   its compressed rows (:706, :708; the stripe forms through
//   _attention_grouped :428-431 and _swiglu, :513, :765-768);
//   int8: _qmm (:277-284, the int32 dot dequantized by xs * w_scale), fed by
//   _actquant (:271), in the same helpers of the same two pallas_calls
//   (:639, :906).
//
// Bound on the H100 at the main-path shapes: operations, but for the int8
// QKV GEMM. One block row costs 2 * (3C*C + C*C + 2hp*C + hp*C) = 25.2 MFLOP
// at C 1024, hp 2736, so B's 30001 rows are 0.756 TFLOP (0.76 ms at 989
// TFLOP/s in bf16, 0.38 ms at 1979 TOP/s in int8) against ~0.26 GB of
// operands and outputs (~0.08 ms at 3.35 TB/s); the whole frame's block
// GEMMs are 1.17e13 operations, 11.9 ms at the bf16 peak, 5.9 at the int8
// one. The int8 QKV GEMM writes 184 MB of bf16 q / k / v at 30001 rows
// (0.06 ms of bytes against 0.1 ms of operations; 369 MB of f32 until the
// QKV epilogue).
//
// Design (Hopper's TMA + wgmma, warp-specialised, persistent):
//   * one TMA descriptor per operand (128-byte swizzle, boxes of one
//     128-byte row of K x rows: 64 bf16 or 128 int8), encoded on the host
//     (memoised by base, shape and stride) and passed as __grid_constant__
//     parameters; a K tile is exactly one 128-byte swizzle row in either
//     type, so the ring, the boxes and the wgmma descriptors are the same in
//     bytes, and TMA zero-fills the box past K, M and N, so the K tail (2736
//     = 42.75 bf16 or 21.375 int8 tiles) needs no masking;
//   * a ring of 4 shared-memory stages (1024-byte aligned, as the
//     swizzle requires), each an A tile (128 rows) and a W tile (256 rows)
//     of 128 bytes of K, with a full and an empty mbarrier per stage;
//   * warpgroup 0 is the producer: it gives up registers (setmaxnreg 40)
//     and one thread issues the two TMA loads of each stage; warpgroups 1
//     and 2 are consumers (setmaxnreg 232), each owns 64 rows of the 128 x
//     256 output tile and issues wgmma.mma_async straight from the swizzled
//     stage, four 32-byte k steps a stage (m64n256k16 f32.bf16.bf16, or
//     m64n256k32 s32.s8.s8), keeping one commit group in flight and
//     releasing a stage when the group that read it has retired;
//   * a persistent grid of min(tiles, SMs) blocks walks the tiles in row-
//     major order (n fastest): the blocks in flight share a few 128-row
//     panels of A, and every weight matrix (at most 11 MB) stays in the
//     50 MB L2, so A is read from memory about once;
//   * the epilogue works on the accumulator registers: wgmma's f32 or s32
//     fragment gives each thread the column pairs (2t, 2t + 1) of rows g
//     and g + 8 in every 8-column group, as mma.sync m16n8 does, so
//     epilogue2's arithmetic carries over pair by pair and the gate's
//     interleaved (w1 row j, w2 row j) pair lands in one thread. int8
//     dequantizes first, as epilogue2 does: float(acc) * (xs[row] *
//     ws[col]), the rows' scales read once a tile and the channel scales in
//     pairs beside the bias. The bias, channel scales and residual of a
//     chunk are loaded while the previous chunk (or, for the first, the
//     main loop) runs, but for the bias and scales of the gate and of the
//     int8 residual epilogue, loaded at their chunk (beside the next
//     chunk's they do not fit in registers). The QKV epilogue turns the
//     fragment into its f32 values and rotates q and k in place before it
//     stages anything (value_chunk, rope_pass), with the RoPE tables of a
//     few 8-column groups in flight, the first during the main loop; the
//     results go through swizzled
//     staging buffers to TMA stores, which clip rows and columns past M and
//     N and drain while the next tile's main loop runs, so the tensor cores
//     do not wait for the output's memory traffic.
// The head's int8 linears (H8) run on int8_linear.cu's kernel, which takes
// this file's TMA, barrier, descriptor and wgmma helpers and tensor maps.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (the encoder is fetched at
                    // run time through the runtime's driver entry point)
#include <string.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "gemm.cuh"

namespace gemm90 {

constexpr int BM = 128;        // rows per tile: two consumer warpgroups x 64
constexpr int BN = 256;        // columns per tile: one m64n256 wgmma
constexpr int BK = 64;         // bf16 K per stage: one 128-byte swizzle row
constexpr int BK_S8 = 128;     // int8 K per stage: the same 128 bytes
constexpr int THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
// the ring, four 8 KB output staging buffers (two per consumer warpgroup),
// the barriers, and slack to align the ring to 1024 bytes
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 4 * 64 * 128
                           + 2 * STAGES * 8 + 1024;

// what the operand type changes: the accumulator and the K of a stage (one
// 128-byte swizzle row either way)
template <typename T>
struct Operand;
template <>
struct Operand<bf16> {
  typedef float Acc;
  static constexpr int K = BK;
};
template <>
struct Operand<int8_t> {
  typedef int Acc;
  static constexpr int K = BK_S8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed; a
// wait of more than 2^35 clocks (~20 s) traps, so a broken pipeline fails
// the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (!t0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 35))
      __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: the box at (k, row) of the tensor map into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte swizzle:
// start address >> 4, LBO 1 (unused for swizzled K-major), SBO 1024 bytes
// (the next group of 8 rows), layout type 1 (128B swizzle). Advancing K by
// one k step (16 bf16 or 32 int8) inside the swizzle row adds 32 bytes to
// the start.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it sees the registers as written by each issue)
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the 128 accumulator registers of an m64n256 fragment
#define G90_DREGS                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
  "%56, %57, %58, %59, %60, %61, %62, %63, "                              \
  "%64, %65, %66, %67, %68, %69, %70, %71, "                              \
  "%72, %73, %74, %75, %76, %77, %78, %79, "                              \
  "%80, %81, %82, %83, %84, %85, %86, %87, "                              \
  "%88, %89, %90, %91, %92, %93, %94, %95, "                              \
  "%96, %97, %98, %99, %100, %101, %102, %103, "                          \
  "%104, %105, %106, %107, %108, %109, %110, %111, "                      \
  "%112, %113, %114, %115, %116, %117, %118, %119, "                      \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define G90_D8(c, i)                                                      \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),            \
      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define G90_D128(c)                                                       \
  G90_D8(c, 0), G90_D8(c, 8), G90_D8(c, 16), G90_D8(c, 24),               \
      G90_D8(c, 32), G90_D8(c, 40), G90_D8(c, 48), G90_D8(c, 56),         \
      G90_D8(c, 64), G90_D8(c, 72), G90_D8(c, 80), G90_D8(c, 88),         \
      G90_D8(c, 96), G90_D8(c, 104), G90_D8(c, 112), G90_D8(c, 120)

// d (64 x 256 f32 fragment) (+)= A (64 x 16 bf16, smem) * W (256 x 16,
// smem)^T
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " G90_DREGS
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : G90_D128("+f")
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 256 s32 fragment) (+)= A (64 x 32 s8, smem) * W (256 x 32,
// smem)^T; the integer form takes no scale or transpose immediates
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " G90_DREGS
      ", %128, %129, p;\n}\n"
      : G90_D128("+r")
      : "l"(da), "l"(db), "r"(scale_d));
}

// the s32 fragments of the narrower tiles of the head's int8 linear (H8,
// int8_linear.cu): m64n64k32 (32 registers) and m64n128k32 (64), laid out
// as m64n256's first columns
#define G90_DREGS32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define G90_DREGS64                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t da, uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " G90_DREGS32
      ", %32, %33, p;\n}\n"
      : G90_D8("+r", 0), G90_D8("+r", 8), G90_D8("+r", 16), G90_D8("+r", 24)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da, uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " G90_DREGS64
      ", %64, %65, p;\n}\n"
      : G90_D8("+r", 0), G90_D8("+r", 8), G90_D8("+r", 16), G90_D8("+r", 24),
        G90_D8("+r", 32), G90_D8("+r", 40), G90_D8("+r", 48), G90_D8("+r", 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef G90_DREGS64
#undef G90_DREGS32
#undef G90_D128
#undef G90_D8
#undef G90_DREGS

// The epilogue of a launch is fixed at compile time: the fragment's
// epilogue is unrolled (128 column pairs a thread), and with every
// branch of every epilogue in each copy it outgrows the instruction cache.
// OUT_QKV is the blocks' QKV product handed to the window attention: q and
// k rotated by RoPE in f32, then q, k and v rounded to bf16.
enum Mode { OUT_BF16 = 0, OUT_F32 = 1, OUT_RES = 2, OUT_GATE = 3,
            OUT_QKV = 4 };

// The output goes out in chunks of 128 bytes a row: each consumer
// warpgroup writes its 64 rows of a chunk to one of its two 8 KB staging
// buffers (128-byte swizzled, as the output's tensor map reads them) and one
// thread hands the chunk to a TMA store, which clips rows and columns past M
// and N and drains while the next tile's main loop runs.
template <int MODE>
struct Out {
  // accumulator columns a chunk holds: 32 f32, 64 bf16, or 128 gated into
  // 64 bf16
  static constexpr int ACC_COLS = MODE == OUT_F32 ? 32
                                  : MODE == OUT_GATE ? 128 : 64;
  static constexpr int J = ACC_COLS / 8;   // 8-column groups per chunk
};
constexpr int OUT_BYTES = 64 * 128;        // one staging buffer

// The QKV epilogue works on the accumulator registers in place, in two
// passes before the staging, which only rounds: value_chunk turns each
// chunk into the f32 value the f32 epilogue stores, and rope_pass rotates q
// and k one 8-column group at a time, with the RoPE tables of RG groups in
// flight (the first RG load during the main loop). Held whole beside the
// accumulator (64 registers a thread), the tables spilled in G8. Each step
// is an asm whose operands are tied to the accumulator register, so that
// the compiler computes in place (G8's f32 values went to fresh registers
// and spilled).
__device__ __forceinline__ float as_value(float r) { return r; }
__device__ __forceinline__ float as_value(int r) { return __int_as_float(r); }

// pairwise rotate-half RoPE of one pair (a, b) -> (-b, a) in f32, in place:
// a c0 - b s0 and b c1 + a s1, each one FMA over the rounded second
// product (fma(a, c0, fl(-b s0)), fma(b, c1, fl(a s1))), written out so
// that no choice of contraction can move the int8 blocks' values
#define G90_ROPE2                                                         \
  "mul.rn.f32 rp, rb, %4;\nneg.f32 rp, rp;\nmul.rn.f32 rq, ra, %5;\n"     \
  "fma.rn.f32 rp, ra, %2, rp;\nfma.rn.f32 rq, rb, %3, rq;\n"
__device__ __forceinline__ void rope2(float& x, float& y, float c0, float c1,
                                      float s0, float s1) {
  asm("{\n.reg .f32 ra, rb, rp, rq;\nmov.f32 ra, %0;\nmov.f32 rb, %1;\n"
      G90_ROPE2 "mov.f32 %0, rp;\nmov.f32 %1, rq;\n}\n"
      : "+f"(x), "+f"(y)
      : "f"(c0), "f"(c1), "f"(s0), "f"(s1));
}
__device__ __forceinline__ void rope2(int& x, int& y, float c0, float c1,
                                      float s0, float s1) {
  asm("{\n.reg .f32 ra, rb, rp, rq;\nmov.b32 ra, %0;\nmov.b32 rb, %1;\n"
      G90_ROPE2 "mov.b32 %0, rp;\nmov.b32 %1, rq;\n}\n"
      : "+r"(x), "+r"(y)
      : "f"(c0), "f"(c1), "f"(s0), "f"(s1));
}
#undef G90_ROPE2

// the f32 value of one accumulator register, in place: acc (+ bias), or
// for int8 float(acc) * scale (+ bias), each step rounded on its own as
// stage_chunk's
__device__ __forceinline__ void to_value(float& r, float, float bias,
                                         bool has_bias) {
  if (has_bias) asm("add.rn.f32 %0, %0, %1;\n" : "+f"(r) : "f"(bias));
}
__device__ __forceinline__ void to_value(int& r, float scale, float bias,
                                         bool has_bias) {
  if (has_bias)
    asm("{\n.reg .f32 rf;\ncvt.rn.f32.s32 rf, %0;\nmul.rn.f32 rf, rf, %1;\n"
        "add.rn.f32 rf, rf, %2;\nmov.b32 %0, rf;\n}\n"
        : "+r"(r)
        : "f"(scale), "f"(bias));
  else
    asm("{\n.reg .f32 rf;\ncvt.rn.f32.s32 rf, %0;\nmul.rn.f32 rf, rf, %1;\n"
        "mov.b32 %0, rf;\n}\n"
        : "+r"(r)
        : "f"(scale));
}

// the table row of output row m (Args: cos_t); m < M
__device__ __forceinline__ int table_row(const gemm::Args& a, int m) {
  if (a.pos) return a.pos[m];
  if (m >= a.map_rows) return m - a.map_rows;
  const int y = (m / a.map_w) % a.map_h, x = m % a.map_w;
  return (y % a.win) * a.win + x % a.win;
}

// an 8-byte read-only load that stays where it is written: the compiler
// may move a plain read-only load (__ldg) across the pipeline's barriers
// and the tensor-core asm, to where its registers are scarce
__device__ __forceinline__ float2 ld_pinned(const float* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p));
  return v;
}

// the tables of column group j (columns 8j + 2t of a head: a chunk of 64
// columns starts on a head, rope_d 32 or 64 dividing 64) at the thread's
// two rows, table rows tr
__device__ __forceinline__ void load_group(const gemm::Args& a,
                                           const int (&tr)[2], int t, int j,
                                           float2 (&c)[2], float2 (&s)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i =
        (long long)tr[h] * a.rope_d + (8 * j + 2 * t) % a.rope_d;
    c[h] = ld_pinned(a.cos_t + i);
    s[h] = ld_pinned(a.sin_t + i);
  }
}

// column groups whose tables are in flight: G's and G8's (whose scales
// take registers too), the fastest on an H100 of 2, 4, 6 and 8 (ptxas
// spilled at 8 in G and at 4 in G8)
constexpr int RG_BF16 = 4, RG_S8 = 2;
constexpr int RG_MAX = RG_BF16 > RG_S8 ? RG_BF16 : RG_S8;

__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// the f32 pairs of vector v (the bias, or the int8 channel scales) at the
// thread's column pairs of one chunk (acc columns c0 + 8j + 2t), zero past
// n or for a null v; 8-byte loads: the wrappers check that both vectors
// lie on an 8-byte boundary
template <int J>
__device__ __forceinline__ void load_pairs(const float* v, int n, int c0,
                                           int t, float2 (&p)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    p[j] = v && c < n ? *reinterpret_cast<const float2*>(v + c)
                      : make_float2(0.f, 0.f);
  }
}

// the residual of the same column pairs in the thread's rows gm and gm + 8,
// kept as bf16 pairs (one register each)
template <int J>
__device__ __forceinline__ void load_res(const gemm::Args& a, int gm, int c0,
                                         int t, bf162 (&r)[2][J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = c0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      r[h][j] = c < a.N && gm + 8 * h < a.M
                    ? *reinterpret_cast<const bf162*>(
                          a.res + (long long)(gm + 8 * h) * a.ldr + c)
                    : __float2bfloat162_rn(0.f);
  }
}

// epilogue2's rounding points (and its arithmetic, but for the bf16 gate's
// fast silu) for chunk ch of the thread's fragment, written to the staging
// buffer sb: the fragment of m64n256 holds, in register 4j + e, row 16 *
// warp + g (+ 8 for e >= 2) and column 8j + 2t + (e & 1), so the gate's
// (w1 row j, w2 row j) pair is one thread's. xs: the int8 scales of rows g
// and g + 8. OUT_QKV: the registers already hold the final f32 values
// (value_chunk, rope_pass), which are only rounded.
template <int MODE, typename Acc>
__device__ __forceinline__ void stage_chunk(
    const gemm::Args& a, const Acc (&acc)[BN / 2], int ch, int warp, int g,
    int t, const float2 (&b)[Out<MODE>::J], const float2 (&s)[Out<MODE>::J],
    const float (&xs)[2], const bf162 (&r)[2][Out<MODE>::J],
    unsigned char* sb) {
  constexpr int J = Out<MODE>::J;
  constexpr bool S8 = std::is_same<Acc, int>::value;
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * (ch * J + j) + 2 * h;
      float v0, v1;
      if constexpr (MODE == OUT_QKV) {
        v0 = as_value(acc[i]);
        v1 = as_value(acc[i + 1]);
      } else if constexpr (S8) {
        // float(acc) * (xs * ws), each product rounded on its own (no FMA
        // with the bias add below), as epilogue2 and _qmm
        v0 = __fmul_rn(__int2float_rn(acc[i]), __fmul_rn(xs[h], s[j].x));
        v1 = __fmul_rn(__int2float_rn(acc[i + 1]), __fmul_rn(xs[h], s[j].y));
      } else {
        v0 = acc[i];
        v1 = acc[i + 1];
      }
      if (a.bias && MODE != OUT_QKV) {
        v0 += b[j].x;
        v1 += b[j].y;
      }
      const int row = 16 * warp + g + 8 * h;
      unsigned char* line = sb + row * 128;
      const int sw = row & 7;   // 128-byte swizzle: 16-byte chunk ^ row
      if (MODE == OUT_F32) {
        const int q = 2 * j + (t >> 1);
        *reinterpret_cast<float2*>(line + ((q ^ sw) << 4) + 8 * (t & 1)) =
            make_float2(v0, v1);
      } else if (MODE == OUT_GATE) {
        const float x1 = bfr(v0), x2 = bfr(v1);
        float sl;
        if constexpr (S8) {
          // epilogue2's expf and IEEE division, so that the output equals
          // the mma.sync tile's bit for bit: it is quantized at the ffn_in
          // site, where one flipped bf16 bit moves a whole int8 step
          sl = bfr(x1 / (1.f + expf(-x1)));
        } else {
          // the SFU's exponential and reciprocal, a few f32 ulps from
          // epilogue2's expf and IEEE division (both slow, and paid on
          // every gate output) before the same rounding to bf16
          sl = bfr(__fdividef(x1, 1.f + __expf(-x1)));
        }
        *reinterpret_cast<bf16*>(line + (((j >> 1) ^ sw) << 4) +
                                 8 * (j & 1) + 2 * t) =
            __float2bfloat16(sl * x2);
      } else {
        if (MODE == OUT_RES) {
          const float2 rs = __bfloat1622float2(r[h][j]);
          v0 = bfr(v0) + rs.x;
          v1 = bfr(v1) + rs.y;
        }
        *reinterpret_cast<bf162*>(line + ((j ^ sw) << 4) + 4 * t) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// QKV epilogue, first pass: chunk ch of the fragment turned in place into
// the f32 value the f32 epilogue stores (int8: dequantized as stage_chunk
// does; then the bias), at the same rounding points
template <int J, typename Acc>
__device__ __forceinline__ void value_chunk(const gemm::Args& a,
                                            Acc (&acc)[BN / 2], int ch,
                                            const float2 (&b)[J],
                                            const float2 (&s)[J],
                                            const float (&xs)[2]) {
  constexpr bool S8 = std::is_same<Acc, int>::value;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * (ch * J + j) + 2 * h;
      to_value(acc[i], S8 ? __fmul_rn(xs[h], s[j].x) : 0.f, b[j].x,
               a.bias != nullptr);
      to_value(acc[i + 1], S8 ? __fmul_rn(xs[h], s[j].y) : 0.f, b[j].y,
               a.bias != nullptr);
    }
}

// QKV epilogue, second pass: q and k (columns below rope_cols; the tile's
// chunks start at column n0) rotated in place, one column group at a time
// over the chunks: the tables of groups 0 .. RG - 1 are in gc / gs, and
// group j + RG's load into group j's registers once they are used
template <int J, int CHUNKS, int RG, typename Acc>
__device__ __forceinline__ void rope_pass(const gemm::Args& a,
                                          Acc (&acc)[BN / 2],
                                          const int (&tr)[2], int t, int n0,
                                          float2 (&gc)[RG_MAX][2],
                                          float2 (&gs)[RG_MAX][2]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int r = j % RG;
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch) {
      if (n0 + ch * 64 + 8 * j + 2 * t < a.rope_cols) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * (ch * J + j) + 2 * h;
          rope2(acc[i], acc[i + 1], gc[r][h].x, gc[r][h].y, gs[r][h].x,
                gs[r][h].y);
        }
      }
    }
    if (j + RG < J) load_group(a, tr, t, j + RG, gc[r], gs[r]);
  }
}

// the kernel body of operand type T (bf16 or int8_t), epilogue MODE
template <int MODE, typename T>
__device__ __forceinline__ void gemm_sm90(const CUtensorMap& map_a,
                                          const CUtensorMap& map_w,
                                          const CUtensorMap& map_c,
                                          const gemm::Args& a) {
  typedef Out<MODE> O;
  typedef typename Operand<T>::Acc Acc;
  constexpr bool S8 = std::is_same<T, int8_t>::value;
  constexpr int KT = Operand<T>::K;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* staging = ring + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 4 * OUT_BYTES);
  uint64_t* empty = full + STAGES;
  const int tiles_n = (a.N + BN - 1) / BN;
  const int tiles = (a.M + BM - 1) / BM * tiles_n;
  const int ktiles = (a.K + KT - 1) / KT;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);    // the producer's expect_tx arrival
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full, the warpgroup's other
    // threads leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * STAGE_BYTES;
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          tma_load(st, &map_a, &full[stage], kt * KT, m0);
          tma_load(st + A_BYTES, &map_w, &full[stage], kt * KT, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;                       // rows cw * 64 of the tile
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;
    unsigned char* bufs = staging + cw * 2 * OUT_BYTES;
    const int n_out = MODE == OUT_GATE ? a.N / 2 : a.N;
    Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
    int stage = 0, phase = 0, nchunk = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      const int gm = m0 + cw * 64 + warp * 16 + g;
      // the first chunk's bias, scales and residual, and the rows' int8
      // scales, load during the main loop
      float2 b[O::J], s[O::J];
      bf162 r[2][O::J];
      float xs[2] = {0.f, 0.f};
      load_pairs(a.bias, a.N, n0, t, b);
      if (S8) load_pairs(a.ws, a.N, n0, t, s);
      if (MODE == OUT_RES) load_res(a, gm, n0, t, r);
      if (S8) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xs[h] = gm + 8 * h < a.M ? a.xs[a.xs_row ? gm + 8 * h : 0] : 0.f;
      }
      // OUT_QKV: the rows' table rows, and the tables of the first RG column
      // groups once the second k tile is issued (a table row read from pos
      // has landed by then)
      constexpr int RG = S8 ? RG_S8 : RG_BF16;
      float2 gc[RG_MAX][2], gs[RG_MAX][2];
      int tr[2] = {0, 0};
      const bool rot = MODE == OUT_QKV && a.cos_t && n0 < a.rope_cols;
      if (rot) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (gm + 8 * h < a.M) tr[h] = table_row(a, gm + 8 * h);
      }
      const int tab_kt = ktiles > 1 ? 1 : 0;
      int prev = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = ring + stage * STAGE_BYTES;
        const unsigned char* as = st + cw * 64 * 128;
        const unsigned char* ws = st + A_BYTES;
        wgmma_fence();
        // four k steps of 32 bytes (16 bf16 or 32 int8) per 128-byte row
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma(acc, sw128_desc(as + kk * 32), sw128_desc(ws + kk * 32),
                (kt > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        if constexpr (MODE == OUT_QKV) {
          if (rot && kt == tab_kt) {
#pragma unroll
            for (int q = 0; q < RG; ++q)
              load_group(a, tr, t, q, gc[q], gs[q]);
          }
        }
        // the group before this one has retired: its stage is free
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      // the next chunk's residual loads while this one is staged, and its
      // bias and channel scales too but for the gate (16 column groups a
      // chunk) and the int8 residual epilogue: beside the next chunk's those
      // do not fit in registers (ptxas spilled), so they load at their chunk
      constexpr int CHUNKS = BN / O::ACC_COLS;
      constexpr bool vec_ahead = MODE != OUT_GATE &&
                                 !(S8 && MODE == OUT_RES) && MODE != OUT_QKV;
      if constexpr (MODE == OUT_QKV) {
        // the values (the next chunk's bias and scales loading while a
        // chunk is turned), then RoPE; the staging below only rounds
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) {
          float2 bn[O::J], sn[O::J];
          const int c_next = n0 + (ch + 1) * O::ACC_COLS;
          if (ch + 1 < CHUNKS) {
            load_pairs(a.bias, a.N, c_next, t, bn);
            if (S8) load_pairs(a.ws, a.N, c_next, t, sn);
          }
          value_chunk(a, acc, ch, b, s, xs);
#pragma unroll
          for (int j = 0; j < O::J; ++j) {
            b[j] = bn[j];
            s[j] = sn[j];
          }
        }
        if (rot) rope_pass<O::J, CHUNKS, RG>(a, acc, tr, t, n0, gc, gs);
      }
#pragma unroll
      for (int ch = 0; ch < CHUNKS; ++ch) {
        float2 bn[O::J], sn[O::J];
        bf162 rn[2][O::J];
        const int c_next = n0 + (ch + 1) * O::ACC_COLS;
        if (MODE == OUT_RES && ch + 1 < CHUNKS) load_res(a, gm, c_next, t, rn);
        if (vec_ahead && ch + 1 < CHUNKS) {
          load_pairs(a.bias, a.N, c_next, t, bn);
          if (S8) load_pairs(a.ws, a.N, c_next, t, sn);
        }
        if (!vec_ahead && MODE != OUT_QKV && ch > 0) {
          load_pairs(a.bias, a.N, n0 + ch * O::ACC_COLS, t, b);
          if (S8) load_pairs(a.ws, a.N, n0 + ch * O::ACC_COLS, t, s);
        }
        const int col = (MODE == OUT_GATE ? n0 / 2 : n0) +
                        ch * (MODE == OUT_F32 ? 32 : 64);
        // a chunk wholly past N, or a warpgroup's rows wholly past M, has
        // nothing to store (the same for the whole warpgroup)
        if (col < n_out && m0 + cw * 64 < a.M) {
          unsigned char* sb = bufs + (nchunk & 1) * OUT_BYTES;
          // the store that last read this buffer (two chunks ago) is done
          if (leader)
            asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          wg_sync(1 + cw);
          stage_chunk<MODE>(a, acc, ch, warp, g, t, b, s, xs, r, sb);
          // the generic-proxy writes, visible to the TMA store
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          wg_sync(1 + cw);
          if (leader) {
            asm volatile(
                "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
                " [%0, {%2, %3}], [%1];\n" ::"l"(
                    reinterpret_cast<uint64_t>(&map_c)),
                "r"(smem_u32(sb)), "r"(col), "r"(m0 + cw * 64)
                : "memory");
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          }
          ++nchunk;
        }
#pragma unroll
        for (int j = 0; j < O::J; ++j) {
          if (vec_ahead) {
            b[j] = bn[j];
            s[j] = sn[j];
          }
          if (MODE == OUT_RES) {
            r[0][j] = rn[0][j];
            r[1][j] = rn[1][j];
          }
        }
      }
    }
    // the last stores have read shared memory and written their rows
    if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// kernel G (bf16) and kernel G8 (int8): the one body under two names, so
// that a profile tells them apart
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_c,
                     const __grid_constant__ gemm::Args a) {
  gemm_sm90<MODE, bf16>(map_a, map_w, map_c, a);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_s8_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_w,
                        const __grid_constant__ CUtensorMap map_c,
                        const __grid_constant__ gemm::Args a) {
  gemm_sm90<MODE, int8_t>(map_a, map_w, map_c, a);
}

// cuTensorMapEncodeTiled, fetched once through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                          cudaEnableDefault, &q);
#endif
  if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
    fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

// what a tensor map of a row-major (rows, cols) matrix of 1-, 2- or 4-byte
// elements with row stride ld elements, read or written in 128-byte
// swizzled boxes of box_cols x box_rows (box_cols * elsize = 128 bytes, one
// swizzle row), depends on; with flat, boxes of box_cols x box_rows as they
// lie (rows of box_cols * elsize bytes, a multiple of 16, no swizzle); 48
// bytes, no padding (flat and unused are 0 where a key leaves them out)
struct MapKey {
  const void* base;
  long long ld;
  int type, elsize, rows, cols, box_cols, box_rows;
  int flat, unused;
  bool operator==(const MapKey& o) const {
    return memcmp(this, &o, sizeof(MapKey)) == 0;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    const unsigned char* p = reinterpret_cast<const unsigned char*>(&k);
    size_t h = 1469598103934665603ull;   // FNV-1a
    for (size_t i = 0; i < sizeof(MapKey); ++i)
      h = (h ^ p[i]) * 1099511628211ull;
    return h;
  }
};

inline int encode(CUtensorMap* map, const MapKey& k) {
  EncodeTiled enc = encoder();
  if (!enc) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k.cols),
                              static_cast<cuuint64_t>(k.rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k.ld) * k.elsize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(k.box_cols),
                             static_cast<cuuint32_t>(k.box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  CUresult r = enc(map, static_cast<CUtensorMapDataType>(k.type), 2,
                   const_cast<void*>(k.base), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE,
                   k.flat ? CU_TENSOR_MAP_SWIZZLE_NONE
                          : CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// encode, memoised: a map is a pure function of its key, and the same
// weights and (through PyTorch's caching allocator) mostly the same
// activation buffers come back every frame, so most calls skip the driver's
// encoder. Bounded: the memo starts over past 4096 maps.
inline int cached_map(CUtensorMap* map, const MapKey& k) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> memo;
  std::lock_guard<std::mutex> lock(mu);
  auto it = memo.find(k);
  if (it != memo.end()) {
    *map = it->second;
    return 0;
  }
  if (int e = encode(map, k)) return e;
  if (memo.size() >= 4096) memo.clear();
  memo.emplace(k, *map);
  return 0;
}

inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

// one launch of epilogue MODE on operands of type T (a.A, a.B bf16 or
// int8_t; the wrappers check 16-byte aligned bases, row strides a multiple
// of 16 bytes and an 8-byte aligned bias and channel scales)
template <int MODE, typename T>
inline int launch_mode(const gemm::Args& a, cudaStream_t stream) {
  constexpr bool S8 = std::is_same<T, int8_t>::value;
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, gemm::Args) =
      S8 ? gemm_s8_sm90_kernel<MODE> : gemm_sm90_kernel<MODE>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  if (a.M <= 0 || a.N <= 0) return static_cast<int>(cudaGetLastError());
  const int bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int in = S8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : bf;
  const int es = sizeof(T), kt = Operand<T>::K;
  CUtensorMap ma, mw, mc;
  if (int e = cached_map(&ma, {a.A, a.lda, in, es, a.M, a.K, kt, BM}))
    return e;
  if (int e = cached_map(&mw, {a.B, a.ldb, in, es, a.N, a.K, kt, BN}))
    return e;
  // the output: (M, N) f32 or bf16, or (M, N / 2) bf16 for the gate, in
  // the staging chunks of 64 rows x 128 bytes
  if (int e = cached_map(
          &mc, MODE == OUT_F32
                   ? MapKey{a.C, a.ldc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                            a.M, a.N, 32, 64}
                   : MapKey{a.C, a.ldc, bf, 2, a.M,
                            MODE == OUT_GATE ? a.N / 2 : a.N, 64, 64}))
    return e;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long tiles =
      (long long)((a.M + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(ma, mw, mc, a);
  return static_cast<int>(cudaGetLastError());
}

// A (M, K) x W (N, K)^T of type T with gemm.cuh's epilogues (gate first, as
// epilogue2 takes it, then f32 out, then the residual); for int8 the
// dequantization by a.xs and a.ws comes first
template <typename T>
inline int launch(const gemm::Args& a, cudaStream_t stream) {
  if (a.gate) return launch_mode<OUT_GATE, T>(a, stream);
  if (a.out_f32) return launch_mode<OUT_F32, T>(a, stream);
  if (a.res) return launch_mode<OUT_RES, T>(a, stream);
  return launch_mode<OUT_BF16, T>(a, stream);
}

// the same product with the QKV epilogue (Args: cos_t ..): the f32 value
// OUT_F32 would store, RoPE on the columns below rope_cols, then bf16; the
// tables (rope_d 32 or 64, f32 pairs on 8 bytes) are the wrapper's to check
template <typename T>
inline int launch_qkv(const gemm::Args& a, cudaStream_t stream) {
  if (a.cos_t && (a.rope_d <= 0 || 64 % a.rope_d || !a.sin_t ||
                  (!a.pos && (a.map_h <= 0 || a.map_w <= 0 || a.win <= 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_mode<OUT_QKV, T>(a, stream);
}

}  // namespace gemm90
