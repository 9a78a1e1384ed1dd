// Tiled tensor-core GEMM with fused epilogues, behind the patch embedding
// (patch_embed.cu, bf16 with PATCH) and the head's int8 linears
// (vit_block.cu, int8 with head). The block matmuls, bf16 and int8, run on
// gemm_sm90.cuh's TMA + wgmma kernel, whose epilogues keep epilogue2's
// rounding points; the card tests hold its int8 form to this tile bit for
// bit.
//
//   C[m, n] = epilogue( sum_k A[m, k] * B[n, k] )
//
// The operand type T is bf16 (f32 accumulators, mma.sync m16n8k16) or int8
// (int32 accumulators, mma.sync m16n8k32 s8.s8.s32). A is row-major (M, K)
// (int8) or, with PATCH (bf16), the implicit im2col view of a channel-last
// (img, H, W, 3) image, read straight from the image — and B is a torch
// Linear weight (N, K), row-major, i.e. the "col" operand of the tensor-core
// product. Tiles of 128 x 128 x 64 bytes (32 bf16 or 64 int8 along K) go
// through a 3-stage cp.async ring in shared memory; 8 warps each own a
// 64 x 32 slice of the output, fed by ldmatrix. The two types share one
// shared-memory layout in bytes: ldmatrix's 8x8 b16 tiles hold, lane for
// lane, the fragments of m16n8k32 s8 as they hold those of m16n8k16 bf16.
// The epilogue works on each thread's column pairs straight from the
// accumulator registers:
//   int8  : v = float(acc) * (xs[m] * ws[n])  (xs: the row's activation
//           scale, or the one static scale; the product order of
//           ops/pallas/vit_block.py _qmm); with head, (float(acc) * xs[m])
//           * ws[n] (layers.py _int8_matmul)
//   bias  : + bias[n] (f32); with head, bf16(bf16(v) + bf16(bias[n])), the
//           linear's bias added after the cast to the activation dtype
//   res   : t = bf16(acc + bias); out = bf16(t + res[m, n])   (residual add)
//   gate  : columns come in interleaved pairs (2j, 2j+1) = (w1 row j, w2 row
//           j); out[m, j] = bf16(bf16(silu(bf16(a))) * bf16(b)), width N/2
//   out_f32: store acc + bias as f32 (no rounding)
// Requirements (checked by the Python wrappers): K a multiple of one 16-byte
// chunk (8 bf16, 16 int8), lda/ldb likewise, 16-byte aligned bases, N and
// ldc/ldr even.
#pragma once

#include "common.cuh"

namespace gemm {

constexpr int BM = 128, BN = 128, STAGES = 3, THREADS = 256;
constexpr int BKB = 64;           // bytes of K per tile
constexpr int LDSB = BKB + 16;    // bytes per smem row (80 B, skewed)
constexpr int PIPE_BYTES = STAGES * (BM + BN) * LDSB;
constexpr int SMEM_BYTES = PIPE_BYTES;

template <typename T>
struct Op;
template <>
struct Op<bf16> {
  typedef float Acc;
  static constexpr int EPC = 8;   // elements per 16-byte chunk
};
template <>
struct Op<int8_t> {
  typedef int Acc;
  static constexpr int EPC = 16;
};

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
  // PATCH: the image is (nimg, pH, pW, 3); patch grid pgh x pgw; patch ps
  int pH, pW, pgh, pgw, ps;
  // int8 dequantization: xs[xs_row ? m : 0] * ws[n]; head: product order
  // and bias rounding of the head's int8 linears (see above)
  const float* xs = nullptr;
  int xs_row = 0;
  const float* ws = nullptr;
  int head = 0;
};

template <bool PATCH, typename T>
__device__ __forceinline__ const T* a_ptr(const Args& a, int m, int k) {
  const T* A = static_cast<const T*>(a.A);
  if (!PATCH) return A + (long long)m * a.lda + k;
  const int per = a.pgh * a.pgw;
  const int b = m / per;
  const int rem = m - b * per;
  const int i = rem / a.pgw;
  const int j = rem - i * a.pgw;
  const int rowlen = a.ps * 3;       // one patch row: ps pixels x 3 channels
  const int r = k / rowlen;
  const int within = k - r * rowlen;
  const long long y = (long long)b * a.pH + (long long)i * a.ps + r;
  return A + (y * a.pW + (long long)j * a.ps) * 3 + within;
}

template <bool PATCH, typename T>
__device__ __forceinline__ void load_tile(const Args& a, unsigned char* As,
                                          unsigned char* Bs, int m0, int n0,
                                          int k0, int tid) {
  constexpr int EPC = Op<T>::EPC;
  constexpr int CPR = BKB / 16;      // 16-byte chunks per tile row
  const T* B = static_cast<const T*>(a.B);
#pragma unroll
  for (int c = tid; c < BM * CPR; c += THREADS) {
    const int r = c / CPR;
    const int kc = (c % CPR) * EPC;
    const int m = m0 + r, k = k0 + kc;
    const bool ok = (m < a.M) && (k < a.K);
    const T* src = ok ? a_ptr<PATCH, T>(a, m, k) : static_cast<const T*>(a.A);
    cp_async16(As + r * LDSB + (c % CPR) * 16, src, ok);
  }
#pragma unroll
  for (int c = tid; c < BN * CPR; c += THREADS) {
    const int r = c / CPR;
    const int kc = (c % CPR) * EPC;
    const int n = n0 + r, k = k0 + kc;
    const bool ok = (n < a.N) && (k < a.K);
    const T* src = ok ? B + (long long)n * a.ldb + k : B;
    cp_async16(Bs + r * LDSB + (c % CPR) * 16, src, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D (16x8 f32)
__device__ __forceinline__ void mma(float* d, const unsigned* a,
                                    const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

template <bool PATCH, typename T>
__global__ void __launch_bounds__(THREADS) gemm_kernel(Args a) {
  typedef typename Op<T>::Acc Acc;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile: 64 rows x 32 cols
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  constexpr int BK = BKB / sizeof(T);        // K elements per tile

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  const int kt_n = (a.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) {
      unsigned char* As = smem_raw + s * (BM + BN) * LDSB;
      load_tile<PATCH, T>(a, As, As + BM * LDSB, m0, n0, s * BK, tid);
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
      load_tile<PATCH, T>(a, As, As + BM * LDSB, m0, n0, nk * BK, tid);
    }
    cp_async_commit();
    const unsigned char* As = smem_raw + (kt % STAGES) * (BM + BN) * LDSB;
    const unsigned char* Bs = As + BM * LDSB;
#pragma unroll
    for (int kk = 0; kk < BKB; kk += 32) {   // one mma depth = 32 bytes
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

template <bool PATCH, typename T = bf16>
inline int launch(const Args& a, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<PATCH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  if (a.M <= 0 || a.N <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  gemm_kernel<PATCH, T><<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm
