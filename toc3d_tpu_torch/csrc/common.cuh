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

#define TOC3D_EXPORT extern "C" __attribute__((visibility("default")))

TOC3D_EXPORT const char* toc3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
