// Kernel H8: the head decoder's int8 linear, one launch a call, with the
// dynamic row quantization of its input fused into the A path of an s8
// wgmma GEMM:
//
//   a[m]   = max(max_k |x[m, k]|, 1e-6)             (x bf16, read as f32)
//   q[m,k] = clip(rint(x[m, k] * (127 / a[m])))     (an IEEE division)
//   acc    = sum_k q[m, k] * w[n, k]                (exact s32)
//   y[m,n] = bf16(bf16((float(acc) * (a[m] * (1/127))) * ws[n])
//                 + bf16(b[n]))
//
// Replaces toc3d_tpu/layers.py :: linear on a w_scale pack (:81-88) and
// _int8_matmul (:110-121), XLA in JAX (no pallas_call); the plain version is
// ops/cuda/int8.int8_linear_plain, which this kernel equals bit for bit, as
// does the mma.sync tile of gemm.cuh (row_quant + gemm_s8 with head), kept as
// its oracle.
//
// Bound on the H100: bytes. Its five main-path shapes (ToC3D_faster_1600,
// 900 queries, 768 memory entries, 6 x 50 x 100 image tokens, 6 decoder
// layers) move x in bf16, the int8 weight, the f32 channel scales and bias
// and y in bf16: (900, 256) -> 256 0.295 us, (1668, 256) -> 256 0.530 us,
// (30000, 256) -> 256 9.19 us, (900, 256) -> 2048 1.40 us, (900, 2048) ->
// 256 1.40 us at 3.35 TB/s, against 0.01-0.24 us of int8 operations. All but
// the cross-attention's key and value projections (30000 rows) are smaller
// than a launch costs.
//
// Design (64 rows x BN columns a tile, BN 128 or 256, K up to 2048, four
// warpgroups a block, one block an SM):
//   * the plan (BN, grid, ring depths) is made by the wrapper
//     (ops/cuda/int8.h8_plan): the smallest BN whose tiles fit in one wave,
//     else BN 256 and a persistent grid whose size is a multiple of the
//     column tiles, so that every tile of a block has one weight tile;
//   * x arrives by TMA in chunks of 64 rows x 128 columns (one box, rows as
//     they lie, zero past M and K) into a ring of buffers that thread 256
//     refills as soon as every quantizing warp has read a chunk. For K <=
//     256 a tile's one or two chunks are read once into registers: the amax
//     pass and the quantizing pass run on them. Above, the chunks stream
//     twice: the amax pass, then the quantizing pass (the rows come back
//     from L2);
//   * warpgroups 2 and 3 quantize: 16 threads a row, 8 columns a thread,
//     the row's amax by shuffles, one IEEE division a thread shared by
//     shuffles, quant8x4 (common.cuh: quant8's rounding off the conversion
//     pipe); each thread writes its 8 int8 straight into a 128-byte
//     swizzled K-major slot that the wgmma descriptor reads (a chunk of 128
//     columns is one k block), fences them to the async proxy
//     (fence.proxy.async.shared::cta) and arrives on the slot's barrier; the
//     slots are a ring, so the quantizer runs up to two tiles ahead;
//   * the weight tile, BN rows x 128 bytes of K a stage, by TMA (the weights,
//     64-512 KB, stay in L2): loaded once a block when the stages hold all of
//     K (K <= 256 at every main-path width), else a ring refilled as each
//     stage's wgmma group retires;
//   * warpgroups 0 and 1 each run wgmma m64n(BN/2)k32 s32.s8.s8 on their
//     half of the columns from shared memory (gemm_sm90.cuh's descriptors
//     and wgmma forms), four k steps a k block, then the epilogue in the
//     head's order from the s32 fragment (xs, then ws, each product rounded;
//     the bias added after the cast to bf16, as gemm.cuh's epilogue2 with
//     head), staged in 128-byte swizzled 64 x 64 chunks and written by TMA
//     stores that clip past M and N and drain while the next tile runs.
#include "gemm_sm90.cuh"

namespace h8 {

using namespace gemm90;

constexpr int BM = 64;            // rows a tile: the wgmma's M
constexpr int KB = 128;           // K a block: one 128-byte swizzle row of
                                  // int8, and one x chunk of 128 bf16
constexpr int THREADS = 512;      // four warpgroups
constexpr int A_BLOCK = BM * KB;  // one quantized k block
constexpr int X_BYTES = BM * KB * 2;   // one bf16 chunk (one TMA box)
constexpr int STAGE_OUT = 64 * 128;    // an output staging buffer
constexpr int K_MAX = 2048;
constexpr int MAX_BARS = 48;
constexpr int BN_MAX = 256;
constexpr int SMEM_MAX = 232448;
constexpr int BAR_MMA = 1;        // named barrier of the two consumer
                                  // warpgroups; 2 + c: of consumer c alone

struct Args {
  const float* ws;     // (N,) channel scales
  const float* bias;   // (N,) or null
  int M, N, K;
  int tiles_n, tiles;
  int nkb;        // k blocks of 128 (K rounded up)
  int nas;        // quantized k block slots (a ring)
  int nxb;        // x chunk buffers (a ring)
  int wst;        // weight stages
  int panel;      // 1: K <= 256, a tile's chunks read once into registers
  int resident;   // 1: the weight tile is loaded once a block
};

// barriers of a plan: weight stages full; x buffers full and free; k block
// slots quantized and free; the rows' scales (two tiles) free
inline int bars(int nas, int nxb, int wst) {
  return wst + 2 * nxb + 2 * nas + 2;
}

// dynamic shared memory of a plan, aligned regions in this order: weight
// stages, k block slots, x buffers, four output staging buffers (two a
// consumer), the rows' scales (two tiles), the tile's channel scales and
// bias, barriers; 1024 bytes of slack to align the first
inline int smem_bytes(int bn, int nas, int nxb, int wst) {
  return 1024 + wst * bn * KB + nas * A_BLOCK + nxb * X_BYTES +
         4 * STAGE_OUT + 2 * BM * 4 + 2 * BN_MAX * 4 +
         bars(nas, nxb, wst) * 8;
}

// an 8-byte global -> shared copy (cp.async), zero-filled when !pred
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(pred ? 8 : 0)
               : "memory");
}

// Roles: warpgroups 0 and 1 are the consumers, each the wgmma and the
// epilogue of half the tile's columns (BN / 2: m64n64 or m64n128, whose
// s32 fragment leaves the registers for the epilogue's work in flight);
// warpgroups 2 and 3 quantize (8 rows a warp), ahead of the consumers by as
// many k blocks as the slots hold, and their thread 256 issues the x loads;
// thread 0 issues the weight loads.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    int8_linear_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_c,
                       const __grid_constant__ Args a) {
  constexpr int WSTAGE = BN * KB;
  constexpr int HALF = BN / 2;        // a consumer's columns
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* wring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* aring = wring + a.wst * WSTAGE;
  unsigned char* xbuf = aring + a.nas * A_BLOCK;
  unsigned char* outst = xbuf + a.nxb * X_BYTES;
  float* xs_s = reinterpret_cast<float*>(outst + 4 * STAGE_OUT);
  float* ws_s = xs_s + 2 * BM;        // the tile's channel scales
  float* bs_s = ws_s + BN_MAX;        // and its bias
  uint64_t* wfull = reinterpret_cast<uint64_t*>(bs_s + BN_MAX);
  uint64_t* xfull = wfull + a.wst;
  uint64_t* xempty = xfull + a.nxb;
  uint64_t* afull = xempty + a.nxb;
  uint64_t* aempty = afull + a.nas;
  uint64_t* xsempty = aempty + a.nas;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this block's tiles: blockIdx.x, + gridDim.x, ...
  const int mine = static_cast<int>(blockIdx.x) < a.tiles
                       ? (a.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int xper = a.panel ? a.nkb : 2 * a.nkb;   // chunk loads a tile
  const int xtotal = mine * xper;
  const int wtotal = a.resident ? a.nkb : mine * a.nkb;
  // a k block's slot and weight stage are freed as soon as its wgmma
  // retires, unless every block of a tile is resident anyway
  const bool per_block = !a.resident || !a.panel;

  // the tensor maps' descriptors, fetched while the barriers are set up
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_w)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_c)) : "memory");
  }
  if (tid == 256)
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_x)) : "memory");
  if (tid == 0) {
    for (int s = 0; s < a.wst; ++s) mbar_init(&wfull[s], 1);
    for (int s = 0; s < a.nxb; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], 8);       // the quantizing warps
    }
    for (int s = 0; s < a.nas; ++s) {
      mbar_init(&afull[s], 8);        // the quantizing warps
      mbar_init(&aempty[s], 8);       // the consumers' warps
    }
    for (int s = 0; s < 2; ++s) mbar_init(&xsempty[s], 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (mine == 0) return;

  // weight load s: k block s % nkb of the block's tile s / nkb
  auto load_w = [&](int s) {
    if (s >= wtotal) return;
    const int tile = blockIdx.x + (s / a.nkb) * gridDim.x;
    const int slot = s % a.wst;
    mbar_expect_tx(&wfull[slot], WSTAGE);
    tma_load(wring + slot * WSTAGE, &map_w, &wfull[slot], (s % a.nkb) * KB,
             tile % a.tiles_n * BN);
  };

  // x chunk load s: chunk (s % xper) % nkb of the block's tile s / xper
  // (64 rows x 128 columns, zero past M and K, rows of 256 bytes as they
  // lie) into buffer s % nxb
  auto load_x = [&](int s) {
    const int slot = s % a.nxb;
    const int tile = blockIdx.x + (s / xper) * gridDim.x;
    mbar_expect_tx(&xfull[slot], X_BYTES);
    tma_load(xbuf + slot * X_BYTES, &map_x, &xfull[slot],
             s % xper % a.nkb * KB, tile / a.tiles_n * BM);
  };
  // the first x buffers and, from another thread, the first weight stages
  if (tid == 256)
    for (int s = 0; s < a.nxb && s < xtotal; ++s) load_x(s);
  if (tid == 0)
    for (int w = 0; w < a.wst; ++w) load_w(w);

  const int qh = lane >> 4, qc = lane & 15;
  if (warp >= 8) {
    // ---- the quantizer: warp qw takes rows 8 qw + 2 j + qh (j < 4) and
    // columns 8 qc .. 8 qc + 7 of every chunk (16-byte unit qc of the
    // row's 256 bytes) ----
    const int qw = warp - 8;
    int xseq = 0;
    auto row = [&](int j) { return 8 * qw + 2 * j + qh; };
    auto load_rows = [&](uint4 (&v)[4]) {
      const int slot = xseq % a.nxb, use = xseq / a.nxb;
      mbar_wait(&xfull[slot], use & 1);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = *reinterpret_cast<const uint4*>(xbuf + slot * X_BYTES +
                                               row(j) * 256 + qc * 16);
      // the rows are in registers: the buffer is free; once every
      // quantizing warp has read it, thread 256 loads the chunk nxb ahead
      __syncwarp();
      if (lane == 0) mbar_arrive(&xempty[slot]);
      if (tid == 256 && xseq + a.nxb < xtotal) {
        mbar_wait(&xempty[slot], use & 1);
        load_x(xseq + a.nxb);
      }
      ++xseq;
    };
    auto amax_of = [&](const uint4 (&v)[4], float (&amax)[4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned u[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16(u[e]);
          amax[j] = fmaxf(amax[j], fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    };
    // k block q into slot q % nas, once the wgmma that read the slot
    // before has retired in both consumers
    auto put_block = [&](int q, const float (&inv)[4], const uint4 (&v)[4]) {
      const int slot = q % a.nas;
      if (q >= a.nas) mbar_wait(&aempty[slot], ((q / a.nas) - 1) & 1);
      unsigned char* ab = aring + slot * A_BLOCK;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = row(j);
        *reinterpret_cast<uint2*>(ab + r * 128 +
                                  (((qc >> 1) ^ (r & 7)) << 4) +
                                  (qc & 1) * 8) =
            make_uint2(quant8x4(v[j].x, v[j].y, inv[j]),
                       quant8x4(v[j].z, v[j].w, inv[j]));
      }
      // the block's generic-proxy writes, visible to the wgmma that reads
      // it once every quantizing warp has arrived
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&afull[slot]);
    };
    for (int i = 0; i < mine; ++i) {
      float amax[4], inv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) amax[j] = 0.f;
      // K <= 256: the tile's one or two chunks stay in registers (v0, v1)
      // between the amax pass and the quantizing pass
      uint4 v0[4], v1[4];
      const bool two = a.panel && a.nkb > 1;
      if (a.panel) {
        load_rows(v0);
        amax_of(v0, amax);
        if (two) {
          load_rows(v1);
          amax_of(v1, amax);
        }
      } else {
        for (int c = 0; c < a.nkb; ++c) {
          load_rows(v0);
          amax_of(v0, amax);
        }
      }
      // each row's amax over its 16 threads; then its multiplier, one IEEE
      // division a thread (row qc & 3 of its half) shared by shuffles; the
      // rows' scales into xs_s[i & 1] once the consumers have read tile
      // i - 2's
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          amax[j] = fmaxf(amax[j], __shfl_xor_sync(0xffffffffu, amax[j], o));
      const int jr = qc & 3;
      float am = amax[0];
#pragma unroll
      for (int j = 1; j < 4; ++j)
        if (jr == j) am = amax[j];
      if (i >= 2) mbar_wait(&xsempty[i & 1], ((i >> 1) - 1) & 1);
      const float my =
          quant_inv(nullptr, am, xs_s + (i & 1) * BM + row(jr), qc < 4 ? 0 : 1);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        inv[j] = __shfl_sync(0xffffffffu, my, (lane & 16) + j);
      if (a.panel) {
        put_block(i * a.nkb, inv, v0);
        if (two) put_block(i * a.nkb + 1, inv, v1);
      } else {
        for (int c = 0; c < a.nkb; ++c) {
          load_rows(v0);
          put_block(i * a.nkb + c, inv, v0);
        }
      }
    }
    return;
  }

  // ---- consumer cw (warpgroups 0 and 1): the wgmma and the epilogue of
  // columns cw * BN / 2 .. of the tile ----
  const int cw = warp >> 2, ctid = tid & 127;
  int acc[HALF / 2];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) acc[i] = 0;
  // block q's wgmma has retired in this warp: free its slot (once both
  // consumers' warps have) and, in a ring, refill its weight stage
  auto release = [&](int q) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&aempty[q % a.nas]);
    if (!a.resident) {
      asm volatile("bar.sync %0, 256;\n" ::"r"(BAR_MMA) : "memory");
      if (tid == 0) load_w(q + a.wst);
    }
  };
  // the wgmma of the block's k block q (tile q / nkb, block q % nkb)
  auto mma_block = [&](int q) {
    const int c = q % a.nkb, slot = q % a.nas;
    mbar_wait(&afull[slot], (q / a.nas) & 1);
    const int s = a.resident ? c : q, wslot = s % a.wst;
    mbar_wait(&wfull[wslot], (s / a.wst) & 1);
    if (c == 0) wgmma_fence();
    const unsigned char* ab = aring + slot * A_BLOCK;
    const unsigned char* wsm = wring + wslot * WSTAGE + cw * HALF * KB;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma(acc, sw128_desc(ab + kk * 32), sw128_desc(wsm + kk * 32),
            (c > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    if (per_block) {
      // the group before this one has retired
      wgmma_wait<1>();
      if (c > 0) release(q - 1);
    }
  };
  auto csync = [&]() {
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
  };

  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;   // the fragment's rows r0, r0 + 8
  // K <= 256: |acc| <= 127^2 * 256 < 2^22, so float(acc) is exact as
  // (acc + bits(1.5 * 2^23)) - 1.5 * 2^23, off the conversion pipe
  const bool small_k = a.K <= 2 * KB;
  int nchunk = 0, cols_n0 = -1;
  for (int i = 0; i < mine; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    const int m0 = tile / a.tiles_n * BM, n0 = tile % a.tiles_n * BN;
    const int nh = n0 + cw * HALF;    // this consumer's first column
    if (n0 != cols_n0) {
      // its channel scales and bias, copied while the product runs (its
      // last epilogue's reads ended at its last barrier)
      for (int p = ctid; p < HALF / 2; p += 128) {
        const int c = nh + 2 * p;
        cp_async8(ws_s + cw * HALF + 2 * p, a.ws + c, c < a.N);
        if (a.bias) cp_async8(bs_s + cw * HALF + 2 * p, a.bias + c, c < a.N);
      }
      cp_async_commit();
      cols_n0 = n0;
    }
    for (int c = 0; c < a.nkb; ++c) mma_block(i * a.nkb + c);
    wgmma_wait<0>();
    fence_acc(acc);
    if (per_block) {
      release(i * a.nkb + a.nkb - 1);
    } else {
      for (int c = 0; c < a.nkb; ++c) release(i * a.nkb + c);
    }
    // the rows' scales, then xs_s[i & 1] is free for tile i + 2
    const float xs[2] = {xs_s[(i & 1) * BM + r0], xs_s[(i & 1) * BM + r0 + 8]};
    __syncwarp();
    if (lane == 0) mbar_arrive(&xsempty[i & 1]);
    cp_async_wait<0>();

    // epilogue: 64-column chunks, each staged and stored by TMA
#pragma unroll
    for (int ch = 0; ch < HALF / 64; ++ch) {
      const int col = nh + ch * 64;
      if (col < a.N) {   // the same for the whole warpgroup
        unsigned char* sb = outst + (2 * cw + (nchunk & 1)) * STAGE_OUT;
        // the store that last read this buffer (two chunks ago) is done,
        // and (first chunk) the column vectors are in shared memory
        if (ctid == 0)
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        csync();
        const float* wsh = ws_s + cw * HALF + ch * 64;
        const float* bsh = bs_s + cw * HALF + ch * 64;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 sc = *reinterpret_cast<const float2*>(wsh + c);
          const bf162 bb = __float22bfloat162_rn(
              *reinterpret_cast<const float2*>(bsh + c));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 4 * (ch * 8 + j) + 2 * h;
            float f0, f1;
            if (small_k) {
              f0 = __fsub_rn(__int_as_float(acc[e] + 0x4B400000), 12582912.f);
              f1 = __fsub_rn(__int_as_float(acc[e + 1] + 0x4B400000),
                             12582912.f);
            } else {
              f0 = __int2float_rn(acc[e]);
              f1 = __int2float_rn(acc[e + 1]);
            }
            // (float(acc) * xs) * ws, each product rounded on its own, cast
            // to bf16, then the bias added in bf16 (layers.py:83-87,
            // :120-121): one bf16 addition rounds the exact sum of two bf16
            // values once, as bf16(f32(sum)) does (the sum is exact in f32
            // unless the two lie more than 16 bits apart, and then the
            // smaller is far below half a bf16 step of the larger)
            bf162 y =
                __floats2bfloat162_rn(__fmul_rn(__fmul_rn(f0, xs[h]), sc.x),
                                      __fmul_rn(__fmul_rn(f1, xs[h]), sc.y));
            if (a.bias) y = __hadd2(y, bb);
            const int row = r0 + 8 * h;
            *reinterpret_cast<bf162*>(sb + row * 128 +
                                      ((j ^ (row & 7)) << 4) + 4 * t) = y;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        csync();
        if (ctid == 0) {
          asm volatile(
              "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
              " [%0, {%2, %3}], [%1];\n" ::"l"(
                  reinterpret_cast<uint64_t>(&map_c)),
              "r"(smem_u32(sb)), "r"(col), "r"(m0)
              : "memory");
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
        ++nchunk;
      }
    }
  }
  // the last stores have read shared memory and written their rows
  if (ctid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int BN>
inline int launch_bn(const CUtensorMap& mx, const CUtensorMap& mw,
                  const CUtensorMap& mc, const Args& a, int grid, int smem,
                  cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        int8_linear_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  int8_linear_kernel<BN><<<grid, THREADS, smem, stream>>>(mx, mw, mc, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace h8

// y (M, N) bf16 = the head's int8 linear of x (M, K) bf16 with the int8
// weight w (N, K), channel scales ws (N,) and bias (N,) or null, on the plan
// of ops/cuda/int8.h8_plan (bn, grid, nab, nxb, wst). The wrapper checks
// the operands (16-byte aligned x, w and y, 8-byte aligned ws and bias); a
// plan or shape the kernel does not take returns cudaErrorInvalidValue
// before anything is launched.
TOC3D_EXPORT int toc3d_int8_linear(const void* x, const void* w,
                                   const void* ws, const void* bias, void* y,
                                   int M, int N, int K, int bn, int grid,
                                   int nas, int nxb, int wst, void* stream) {
  const int nkb = (K + h8::KB - 1) / h8::KB;
  const int tiles_n = bn > 0 ? (N + bn - 1) / bn : 0;
  const int tiles = (M + h8::BM - 1) / h8::BM * tiles_n;
  const int smem = h8::smem_bytes(bn, nas, nxb, wst);
  const bool panel = K <= 2 * h8::KB;
  if (M <= 0 || N <= 0 || N % 8 || K < 16 || K > h8::K_MAX || K % 16 ||
      (bn != 128 && bn != 256) || grid <= 0 || nas < 1 ||
      wst < 1 || nxb < 1 || h8::bars(nas, nxb, wst) > h8::MAX_BARS ||
      smem > h8::SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  h8::Args a;
  a.ws = static_cast<const float*>(ws);
  a.bias = static_cast<const float*>(bias);
  a.M = M;
  a.N = N;
  a.K = K;
  a.tiles_n = tiles_n;
  a.tiles = tiles;
  a.nkb = nkb;
  a.nas = nas;
  a.nxb = nxb;
  a.wst = wst;
  a.panel = panel;
  a.resident = wst >= nkb && (tiles <= grid || grid % tiles_n == 0);
  CUtensorMap mx, mw, mc;
  const int bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (int e = gemm90::cached_map(&mx, {x, K, bf, 2, M, K, h8::KB, h8::BM,
                                       1, 0}))
    return e;
  if (int e = gemm90::cached_map(
          &mw, {w, K, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, h8::KB, bn}))
    return e;
  if (int e = gemm90::cached_map(&mc, {y, N, bf, 2, M, N, 64, 64})) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128) return h8::launch_bn<128>(mx, mw, mc, a, grid, smem, s);
  return h8::launch_bn<256>(mx, mw, mc, a, grid, smem, s);
}
