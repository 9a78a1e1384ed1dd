// Flash attention core for the PETR decoder: softmax(q k^T) v per head,
// split over the key axis.
//
// Replaces: toc3d_tpu/ops/pallas/cross_attn.py :: flash_attention_core
//   (pallas_call :149, body _flash_kernel :45).
//
// Bound on the H100 at the main-path shapes (8 heads of d = 32, bf16):
//   cross-attention q (1, 900, 256), k/v (1, 30000, 256):
//     4 * 900 * 30000 * 256 = 27.6 GFLOP (~28 us at 989 TFLOP/s) against
//     31 MB of traffic (~9 us): operations bound by the tensor-core count;
//   self-attention k/v (1, 1668, 256): 1.5 GFLOP, ~1.6 us, the same.
// Those counts hide the real limits. The 216 M exponentials of the
// cross-attention run on the SFUs, 16 a clock per SM: ~55 us at 1.755 GHz
// on 132 SMs, while the products take 30-45 us even at 60% of the
// tensor-core peak. A fast D is therefore bound by exponentials and by
// occupancy (enough warps to hide each tile's mma -> max -> shuffle -> exp
// -> mma chain), not by the tensor-core instruction: mma.sync m16n8k16 is
// enough, and wgmma's 64-row warpgroup tiles would only cut the number of
// blocks in flight.
//
// Design, two launches:
//   flash_partial_kernel  one block of 4 warps (16 query rows each) per
//     (64-query tile, head, batch, key split). Split s covers the 64-key
//     tiles [s * per, min((s + 1) * per, tiles)); the wrapper's split rule
//     (ops/cuda/cross_attn.py flash_splits) gives about 4 x 132 blocks and
//     never an empty split (at q 900, K 30000: 5 splits of 94 tiles, 600
//     blocks). At d = 32 the registers are capped for 5 resident blocks per
//     SM, so those 600 blocks run as one wave of 660 slots (at 4 per SM,
//     1.14 waves took 17% longer on an H100). Where the TPU kernel carries
//     m / l / acc across a sequential grid, each split carries them across
//     its own tiles and writes them out. K/V tiles stream through a 3-stage
//     cp.async ring; rows past K are zero-filled by the copy (the TPU
//     kernel zeroes them by hand, cross_attn.py:62-75) and their logits
//     masked to -inf. S, P, o and the row statistics stay in registers:
//     S = q k^T and o += P v are mma.sync products on ldmatrix fragments (V
//     transposed on the load); P is rounded to bf16 before P.V as the TPU
//     kernel does. The split writes its unnormalised f32 o, row max m and
//     row sum l to scratch.
//   flash_combine_kernel  m = max_s m_s, out = sum_s e^(m_s - m) o_s /
//     sum_s e^(m_s - m) l_s in bf16, one thread per 8 output channels.
//     Every split holds at least one key, so every m_s is finite and l_s
//     >= 1: no split can turn the sum into 0 / 0.
// Exponentials: p = 2^(s log2e - m log2e) by ex2.approx (one FFMA and one
// MUFU per logit) instead of expf. Against torch.exp(s - m) it differs by
// the SFU's ~2^-22 relative error and the rounding of the prescaled
// argument, about 1e-6 relative at the logit sizes of the main path, far
// below the bf16 rounding of P that follows.
#include "common.cuh"

namespace flash {

constexpr int BQ = 64, BKEY = 64, THREADS = 128, STAGES = 3;

template <int D>
struct Smem {
  static constexpr int LDS = D + 8;                  // skewed rows
  static constexpr int TILE = 64 * LDS;              // elements of a tile
  static constexpr int BYTES = (1 + 2 * STAGES) * TILE * 2;  // Q, K/V rings
};

// rows [row0, row0 + 64) of a (nrows, ld) head slice into a skewed tile;
// rows at or past nrows are zero-filled
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, int row0, int nrows,
                                          int tid) {
  constexpr int LDS = D + 8;
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = tid; c < 64 * CH; c += THREADS) {
    const int r = c / CH, kc = (c - r * CH) * 8;
    const bool ok = (row0 + r) < nrows;
    const bf16* s = ok ? src + (long long)(row0 + r) * ld + kc : src;
    cp_async16(dst + r * LDS + kc, s, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, D == 32 ? 5 : 3)
    flash_partial_kernel(
    const bf16* q, const bf16* k, const bf16* v, float* opart, float* mpart,
    float* lpart, int B, int Q, int K, int heads, int per) {
  constexpr int LDS = Smem<D>::LDS, TILE = Smem<D>::TILE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int qtile = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z % B, split = blockIdx.z / B;
  const int C = heads * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE;             // STAGES tiles
  bf16* Vs = Ks + STAGES * TILE;    // STAGES tiles

  const int kt0 = split * per;
  const int nkt = min(per, (K + BKEY - 1) / BKEY - kt0);   // >= 1
  const int kend = K - kt0 * BKEY;  // keys of the split's range that exist
  const bf16* qb = q + (long long)b * Q * C + h * D;
  const long long kv0 = ((long long)b * K + (long long)kt0 * BKEY) * C + h * D;
  const bf16* kb = k + kv0;
  const bf16* vb = v + kv0;
  const int q0 = qtile * BQ;

  load_rows<D>(Qs, qb, C, q0, Q, tid);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) {
      load_rows<D>(Ks + s * TILE, kb, C, s * BKEY, kend, tid);
      load_rows<D>(Vs + s * TILE, vb, C, s * BKEY, kend, tid);
    }
    cp_async_commit();
  }

  const int a_row = ldsm_a_row(lane), a_col = 8 * ldsm_a_half(lane);
  const int b_row = ldsm_b_row(lane), b_col = 8 * ldsm_b_half(lane);
  const int g = lane >> 2, t = lane & 3;

  unsigned qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;               // this thread's share

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < nkt) {
      load_rows<D>(Ks + (nk % STAGES) * TILE, kb, C, nk * BKEY, kend, tid);
      load_rows<D>(Vs + (nk % STAGES) * TILE, vb, C, nk * BKEY, kend, tid);
    }
    cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + a_row) * LDS + kk * 16 + a_col);
    }
    const bf16* Kt = Ks + (kt % STAGES) * TILE;
    const bf16* Vt = Vs + (kt % STAGES) * TILE;

    // S = q k^T for 16 rows x 64 keys, f32
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        unsigned r[4];
        ldsm_x4(r, Kt + (jj * 16 + b_row) * LDS + kk * 16 + b_col);
        mma16816(s[2 * jj], qf[kk], r[0], r[1]);
        mma16816(s[2 * jj + 1], qf[kk], r[2], r[3]);
      }
    }
    if ((kt + 1) * BKEY > kend) {    // the ragged last tile of the last split
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = kt * BKEY + j * 8 + 2 * t;
        if (key >= kend) s[j][0] = s[j][2] = -INFINITY;
        if (key + 1 >= kend) s[j][1] = s[j][3] = -INFINITY;
      }
    }
    online_softmax_tile<D / 8>(s, m0, m1, l0, l1, o);
    // o += bf16(P) v
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      unsigned pa[4];
      p_fragment(pa, s, kc);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        unsigned r[4];
        ldsm_x4_trans(r, Vt + (kc * 16 + a_row) * LDS + dd * 16 + a_col);
        mma16816(o[2 * dd], pa, r[0], r[1]);
        mma16816(o[2 * dd + 1], pa, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + warp * 16 + g;
  const long long orow = ((long long)split * B + b) * Q;   // + row
  const long long srow = (((long long)split * B + b) * heads + h) * Q;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = h * D + n * 8 + 2 * t;
    if (r0 < Q)
      *reinterpret_cast<float2*>(opart + (orow + r0) * C + col) =
          make_float2(o[n][0], o[n][1]);
    if (r0 + 8 < Q)
      *reinterpret_cast<float2*>(opart + (orow + r0 + 8) * C + col) =
          make_float2(o[n][2], o[n][3]);
  }
  if (t == 0) {
    if (r0 < Q) {
      mpart[srow + r0] = m0;
      lpart[srow + r0] = l0;
    }
    if (r0 + 8 < Q) {
      mpart[srow + r0 + 8] = m1;
      lpart[srow + r0 + 8] = l1;
    }
  }
}

__global__ void __launch_bounds__(256) flash_combine_kernel(
    const float* opart, const float* mpart, const float* lpart, bf16* out,
    int B, int Q, int heads, int D, int splits) {
  const int C = heads * D, cpr = C / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Q * cpr) return;
  const long long bq = idx / cpr;                 // b * Q + row
  const int c = static_cast<int>(idx - bq * cpr) * 8;
  const int b = static_cast<int>(bq / Q);
  const int row = static_cast<int>(bq - (long long)b * Q);
  const int h = c / D;
  const long long sstride = (long long)B * heads * Q;
  const long long s0 = ((long long)b * heads + h) * Q + row;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, mpart[s * sstride + s0]);
  float L = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(mpart[s * sstride + s0] - m);
    L += w * lpart[s * sstride + s0];
    const float4* op = reinterpret_cast<const float4*>(
        opart + ((long long)s * B * Q + bq) * C + c);
    const float4 a = op[0], bb = op[1];
    acc[0] += w * a.x;
    acc[1] += w * a.y;
    acc[2] += w * a.z;
    acc[3] += w * a.w;
    acc[4] += w * bb.x;
    acc[5] += w * bb.y;
    acc[6] += w * bb.z;
    acc[7] += w * bb.w;
  }
  uint4 pk;
  pk.x = pack_bf16(acc[0] / L, acc[1] / L);
  pk.y = pack_bf16(acc[2] / L, acc[3] / L);
  pk.z = pack_bf16(acc[4] / L, acc[5] / L);
  pk.w = pack_bf16(acc[6] / L, acc[7] / L);
  *reinterpret_cast<uint4*>(out + bq * C + c) = pk;
}

template <int D>
static int launch(const bf16* q, const bf16* k, const bf16* v, float* opart,
                  float* mpart, float* lpart, bf16* out, int B, int Q, int K,
                  int heads, int splits, int per, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_partial_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int tiles = (K + BKEY - 1) / BKEY;
  // every split must hold a key: the combine step relies on it
  if (B <= 0 || Q <= 0 || K <= 0 || per <= 0 || splits <= 0 ||
      (splits - 1) * per >= tiles || splits * per < tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Q + BQ - 1) / BQ, heads, B * splits);
  flash_partial_kernel<D><<<grid, THREADS, Smem<D>::BYTES, stream>>>(
      q, k, v, opart, mpart, lpart, B, Q, K, heads, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = (long long)B * Q * heads * D / 8;
  flash_combine_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                         stream>>>(opart, mpart, lpart, out, B, Q, heads, D,
                                   splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

TOC3D_EXPORT int toc3d_flash_attention(const void* q, const void* k,
                                       const void* v, void* opart,
                                       void* mpart, void* lpart, void* out,
                                       int B, int Q, int K, int heads,
                                       int head_dim, int splits, int per,
                                       void* stream) {
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  float* op = static_cast<float*>(opart);
  float* mp = static_cast<float*>(mpart);
  float* lp = static_cast<float*>(lpart);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return flash::launch<32>(qq, kk, vv, op, mp, lp, o, B, Q, K, heads,
                             splits, per, s);
  if (head_dim == 64)
    return flash::launch<64>(qq, kk, vv, op, mp, lp, o, B, Q, K, heads,
                             splits, per, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// resident blocks per SM of the partial kernel (for the record), or
// -(CUDA error)
TOC3D_EXPORT int toc3d_flash_occupancy(int head_dim) {
  int nb = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (head_dim == 32) {
    cudaFuncSetAttribute(flash::flash_partial_kernel<32>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         flash::Smem<32>::BYTES);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, flash::flash_partial_kernel<32>, flash::THREADS,
        flash::Smem<32>::BYTES);
  } else if (head_dim == 64) {
    cudaFuncSetAttribute(flash::flash_partial_kernel<64>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         flash::Smem<64>::BYTES);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, flash::flash_partial_kernel<64>, flash::THREADS,
        flash::Smem<64>::BYTES);
  }
  return e == cudaSuccess ? nb : -static_cast<int>(e);
}
