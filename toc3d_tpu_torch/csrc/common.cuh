// Shared helpers for the toc3d_tpu_torch Hopper kernels (sm_90a).
//
// Every kernel here is plain CUDA C++ behind a C interface; the Python side
// (toc3d_tpu_torch/ops/cuda/build.py) builds each .cu into a shared library
// with nvcc and binds it with ctypes. Each C entry point launches on the
// stream it is given and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

// round an f32 value to the nearest bf16 and back (the rounding points of
// the TPU kernels, which keep activations in bf16 between matmuls)
__device__ __forceinline__ float bfr(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// bf16 pair (element c in the low half, c + 1 in the high) <-> f32 pair
__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// int8 quantization of the TPU kernels' _rowquant / _statquant (and of the
// head's _int8_matmul): round half to even (rintf), clip to +-127; shared by
// the quantizing LayerNorm, row quantization and the head's int8 linear so
// that all round at the same points
__device__ __forceinline__ signed char quant8(float v) {
  return static_cast<signed char>(
      static_cast<int>(fminf(fmaxf(rintf(v), -127.f), 127.f)));
}

// the two int8 values of a bf16 pair, as the 2 bytes of a char2 store
__device__ __forceinline__ unsigned quant8x2(unsigned pair, float inv) {
  const float2 f = unpack_bf16(pair);
  return static_cast<unsigned char>(quant8(f.x * inv)) |
         static_cast<unsigned>(static_cast<unsigned char>(quant8(f.y * inv)))
             << 8;
}

// quant8 off the conversion pipe (which does 16 results a clock on an SM,
// and would bound a kernel that quantizes every element it reads): clip
// first, so that NaN gives -127 and +-inf +-127 as quant8 does, then round
// half to even by adding 1.5 * 2^23 in f32 (every sum lies in [2^23, 2^24),
// where the f32 step is 1); the low byte of the sum's bits is the int8 value
// in two's complement. Equal to quant8(v) for every float v.
__device__ __forceinline__ unsigned quant8_bits(float v) {
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(v, -127.f), 127.f), 12582912.f));
}

// the four int8 values of two bf16 pairs (elements 0-3 in bytes 0-3), each
// quant8(x * inv) with the product rounded on its own
__device__ __forceinline__ unsigned quant8x4(unsigned p01, unsigned p23,
                                             float inv) {
  const float2 a = unpack_bf16(p01), b = unpack_bf16(p23);
  const unsigned lo = __byte_perm(quant8_bits(__fmul_rn(a.x, inv)),
                                  quant8_bits(__fmul_rn(a.y, inv)), 0x0040);
  const unsigned hi = __byte_perm(quant8_bits(__fmul_rn(b.x, inv)),
                                  quant8_bits(__fmul_rn(b.y, inv)), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// the multiplier that quantizes a row: 1 / s for a static scale s, else
// 127 / max(amax, 1e-6), an IEEE division (no fast math in the build flags);
// the row's scale a * (1/127) goes to *scale_out, written by the row's
// thread 0
__device__ __forceinline__ float quant_inv(const float* sscale, float amax,
                                           float* scale_out, int t) {
  if (sscale) return 1.0f / sscale[0];
  const float a = fmaxf(amax, 1e-6f);
  if (t == 0) *scale_out = a * (1.0f / 127.0f);
  return 127.0f / a;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte global -> shared copy; with pred false the 16 bytes are zeroed and
// nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int sz = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(sz));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// register-resident attention (flash attention, window attention): mma.sync
// m16n8k16 on ldmatrix fragments
// ---------------------------------------------------------------------------

// ldmatrix lane addressing of a 16x16 bf16 tile: as the A operand (and as V
// under .trans) lane L supplies row a_row(L), 8-column half a_half(L); as
// the B operand from an n-major tile, row b_row(L), half b_half(L)
__device__ __forceinline__ int ldsm_a_row(int lane) {
  return (lane & 7) + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ int ldsm_a_half(int lane) { return lane >> 4; }
__device__ __forceinline__ int ldsm_b_row(int lane) {
  return (lane & 7) + 8 * (lane >> 4);
}
__device__ __forceinline__ int ldsm_b_half(int lane) {
  return (lane >> 3) & 1;
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// the bf16 A operand (16 rows x 16 keys) of P.V for key chunk kc of a
// 64-key tile: P's accumulator layout is the A operand layout
__device__ __forceinline__ void p_fragment(unsigned* pa, float (&s)[8][4],
                                           int kc) {
  pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
  pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
  pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// the online softmax of the flash kernel (cross_attn.cu) and of the window
// attention's one-pass body (vit_block.cu)
constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx.ftz.f32: relative error about 2^-22; 2^-inf
// is +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One 16 x 64 tile of the online softmax, for the two rows (g, g + 8) a
// thread holds in the m16n8 accumulator layout: s[8][4] are the logits
// (masked ones at -inf), m* the running row maxima (raw logit units), l*
// this thread's share of the running row sums, o[NO][4] the running P.V.
// Turns s into p = 2^(s log2e - m log2e) = e^(s - m) (one FFMA and one
// MUFU.EX2 per logit, FlashAttention's form) and rescales l and o. The
// first tile must hold a finite logit in every row, so m never stays -inf.
template <int NO>
__device__ __forceinline__ void online_softmax_tile(float (&s)[8][4],
                                                    float& m0, float& m1,
                                                    float& l0, float& l1,
                                                    float (&o)[NO][4]) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float ms0 = mx0 * LOG2E, ms1 = mx1 * LOG2E;
  const float al0 = ex2(fmaf(m0, LOG2E, -ms0));
  const float al1 = ex2(fmaf(m1, LOG2E, -ms1));
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = ex2(fmaf(s[j][0], LOG2E, -ms0));
    s[j][1] = ex2(fmaf(s[j][1], LOG2E, -ms0));
    s[j][2] = ex2(fmaf(s[j][2], LOG2E, -ms1));
    s[j][3] = ex2(fmaf(s[j][3], LOG2E, -ms1));
    ps0 += s[j][0] + s[j][1];
    ps1 += s[j][2] + s[j][3];
  }
  l0 = al0 * l0 + ps0;
  l1 = al1 * l1 + ps1;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    o[n][0] *= al0;
    o[n][1] *= al0;
    o[n][2] *= al1;
    o[n][3] *= al1;
  }
}

#define TOC3D_EXPORT extern "C" __attribute__((visibility("default")))

TOC3D_EXPORT const char* toc3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
