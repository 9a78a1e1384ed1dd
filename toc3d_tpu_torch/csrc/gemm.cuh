// Tiled int8 tensor-core GEMM with fused epilogues (vit_block.cu ::
// toc3d_gemm_s8), on no main path: the oracle of the Hopper kernels. The
// block matmuls, bf16 and int8, and the patch embedding's product run on
// gemm_sm90.cuh's TMA + wgmma kernel, whose epilogues keep epilogue2's
// rounding points, and the head's int8 linears on int8_linear.cu's kernel
// (H8, the head epilogue); the card tests and chip_smoke.py hold kernel G8
// to this tile, and H8 to row quantization and this tile with head, bit for
// bit. Its Args and epilogue order are the ones gemm_sm90.cuh builds on.
//
//   C[m, n] = epilogue( sum_k A[m, k] * B[n, k] )
//
// int8 operands, int32 accumulators, mma.sync m16n8k32 s8.s8.s32. A is
// row-major (M, K) and B a torch Linear weight (N, K), row-major, i.e. the
// "col" operand of the tensor-core product. Tiles of 128 x 128 x 64 int8 go
// through a 3-stage cp.async ring in shared memory; 8 warps each own a
// 64 x 32 slice of the output, fed by ldmatrix (whose 8x8 b16 tiles hold,
// lane for lane, the fragments of m16n8k32 s8). The epilogue works on each
// thread's column pairs straight from the accumulator registers:
//   v = float(acc) * (xs[m] * ws[n])  (xs: the row's activation scale, or
//       the one static scale; the product order of ops/pallas/vit_block.py
//       _qmm); with head, (float(acc) * xs[m]) * ws[n] (layers.py
//       _int8_matmul)
//   bias  : + bias[n] (f32); with head, bf16(bf16(v) + bf16(bias[n])), the
//           linear's bias added after the cast to the activation dtype
//   res   : t = bf16(acc + bias); out = bf16(t + res[m, n])   (residual add)
//   gate  : columns come in interleaved pairs (2j, 2j+1) = (w1 row j, w2 row
//           j); out[m, j] = bf16(bf16(silu(bf16(a))) * bf16(b)), width N/2
//   out_f32: store acc + bias as f32 (no rounding)
// (gemm_sm90.cuh adds a fifth, the QKV epilogue: RoPE on acc + bias in f32,
// then bf16; this tile has no such form.)
// Requirements (checked by the Python wrappers): K a multiple of one 16-byte
// chunk (16 int8), lda/ldb likewise, 16-byte aligned bases, N and ldc/ldr
// even.
#pragma once

#include "common.cuh"

namespace gemm {

constexpr int BM = 128, BN = 128, STAGES = 3, THREADS = 256;
constexpr int BK = 64;            // int8 K per tile (64 bytes)
constexpr int LDSB = BK + 16;     // bytes per smem row (80 B, skewed)
constexpr int PIPE_BYTES = STAGES * (BM + BN) * LDSB;
constexpr int SMEM_BYTES = PIPE_BYTES;

struct Args {
  const void* A;
  long long lda;
  const void* B;
  long long ldb;
  const float* bias;
  const bf16* res;
  long long ldr;
  void* C;
  long long ldc;
  int M, N, K;
  int out_f32;
  int gate;
  // int8 dequantization: xs[xs_row ? m : 0] * ws[n]; head: product order
  // and bias rounding of the head's int8 linears (see above)
  const float* xs = nullptr;
  int xs_row = 0;
  const float* ws = nullptr;
  int head = 0;
  // gemm_sm90.cuh's QKV epilogue (OUT_QKV): the f32 RoPE tables (positions
  // x rope_d; null: no rotation), applied to the columns below rope_cols
  // (q and k) at the table row of each output row m: pos[m] (dense rows),
  // else, for the map_rows rows of a (B, map_h, map_w) map, the token's
  // place in its window of side win, and m - map_rows past them (the rows
  // of out-of-image tokens, one a window place)
  const float* cos_t = nullptr;
  const float* sin_t = nullptr;
  const int* pos = nullptr;
  int rope_d = 0, rope_cols = 0, map_h = 0, map_w = 0, win = 0, map_rows = 0;
};

__device__ __forceinline__ void load_tile(const Args& a, unsigned char* As,
                                          unsigned char* Bs, int m0, int n0,
                                          int k0, int tid) {
  constexpr int CPR = BK / 16;       // 16-byte chunks per tile row
  const int8_t* A = static_cast<const int8_t*>(a.A);
  const int8_t* B = static_cast<const int8_t*>(a.B);
#pragma unroll
  for (int c = tid; c < BM * CPR; c += THREADS) {
    const int r = c / CPR;
    const int m = m0 + r, k = k0 + (c % CPR) * 16;
    const bool ok = (m < a.M) && (k < a.K);
    cp_async16(As + r * LDSB + (c % CPR) * 16,
               ok ? A + (long long)m * a.lda + k : A, ok);
  }
#pragma unroll
  for (int c = tid; c < BN * CPR; c += THREADS) {
    const int r = c / CPR;
    const int n = n0 + r, k = k0 + (c % CPR) * 16;
    const bool ok = (n < a.N) && (k < a.K);
    cp_async16(Bs + r * LDSB + (c % CPR) * 16,
               ok ? B + (long long)n * a.ldb + k : B, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// D = A (16x32 s8, row) * B (32x8 s8, col) + D (16x8 s32)
__device__ __forceinline__ void mma(int* d, const unsigned* a,
                                    const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the accumulator pair (v0, v1) of row gm, columns gn and gn + 1 (gn even)
__device__ __forceinline__ void epilogue2(const Args& a, int gm, int gn,
                                          float v0, float v1) {
  if (gm >= a.M || gn >= a.N) return;
  if (a.ws) {
    const float xm = a.xs[a.xs_row ? gm : 0];
    if (a.head) {
      v0 = __fmul_rn(__fmul_rn(v0, xm), a.ws[gn]);
      v1 = __fmul_rn(__fmul_rn(v1, xm), a.ws[gn + 1]);
    } else {
      v0 = __fmul_rn(v0, __fmul_rn(xm, a.ws[gn]));
      v1 = __fmul_rn(v1, __fmul_rn(xm, a.ws[gn + 1]));
    }
  }
  if (a.bias) {
    if (a.head) {
      v0 = bfr(v0) + bfr(a.bias[gn]);
      v1 = bfr(v1) + bfr(a.bias[gn + 1]);
    } else {
      v0 += a.bias[gn];
      v1 += a.bias[gn + 1];
    }
  }
  if (a.gate) {
    const float x1 = bfr(v0), x2 = bfr(v1);
    const float s = bfr(x1 / (1.f + expf(-x1)));
    static_cast<bf16*>(a.C)[(long long)gm * a.ldc + gn / 2] =
        __float2bfloat16(s * x2);
    return;
  }
  if (a.out_f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(a.C) +
                               (long long)gm * a.ldc + gn) =
        make_float2(v0, v1);
    return;
  }
  if (a.res) {
    const float2 r = __bfloat1622float2(*reinterpret_cast<const bf162*>(
        a.res + (long long)gm * a.ldr + gn));
    v0 = bfr(v0) + r.x;
    v1 = bfr(v1) + r.y;
  }
  *reinterpret_cast<bf162*>(static_cast<bf16*>(a.C) + (long long)gm * a.ldc +
                            gn) = __floats2bfloat162_rn(v0, v1);
}

__global__ void __launch_bounds__(THREADS) gemm_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile: 64 rows x 32 cols
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int kt_n = (a.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) {
      unsigned char* As = smem_raw + s * (BM + BN) * LDSB;
      load_tile(a, As, As + BM * LDSB, m0, n0, s * BK, tid);
    }
    cp_async_commit();
  }

  // ldmatrix lane addressing (bytes): A tiles as four 8x8 b16 matrices
  // (rows 0-7 / 8-15 x 16-byte halves); B (stored n-major) the same on (n, k)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_col = 16 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4);
  const int b_col = 16 * ((lane >> 3) & 1);

  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < kt_n) {
      unsigned char* As = smem_raw + (nk % STAGES) * (BM + BN) * LDSB;
      load_tile(a, As, As + BM * LDSB, m0, n0, nk * BK, tid);
    }
    cp_async_commit();
    const unsigned char* As = smem_raw + (kt % STAGES) * (BM + BN) * LDSB;
    const unsigned char* Bs = As + BM * LDSB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {   // one mma depth = 32 bytes
      unsigned af[4][4], bq[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], As + (wm * 64 + i * 16 + a_row) * LDSB + kk + a_col);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        unsigned r[4];
        ldmatrix_x4(r, Bs + (wn * 32 + jj * 16 + b_row) * LDSB + kk + b_col);
        bq[2 * jj][0] = r[0];
        bq[2 * jj][1] = r[1];
        bq[2 * jj + 1][0] = r[2];
        bq[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], af[i], bq[j]);
    }
  }
  cp_async_wait<0>();

  // accumulator layout of m16n8: (row g, cols 2t, 2t+1) and (row g + 8, ...)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + wm * 64 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + wn * 32 + j * 8 + 2 * t;
      epilogue2(a, gm, gn, float(acc[i][j][0]), float(acc[i][j][1]));
      epilogue2(a, gm + 8, gn, float(acc[i][j][2]), float(acc[i][j][3]));
    }
  }
}

inline int launch(const Args& a, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  if (a.M <= 0 || a.N <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  gemm_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm
