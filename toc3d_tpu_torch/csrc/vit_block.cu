// EVA-02 ViT block kernels: the full windowed block and the ToC3D
// token-compressed block, each as a short chain of launches of the kernels
// below (toc3d_tpu_torch/ops/cuda/vit_block.py drives the chain), in bf16
// (kernels B, C) and with int8 weight matmuls (kernels B8, C8).
//
// Replaces:
//   toc3d_tpu/ops/pallas/vit_block.py :: fused_full_block (pallas_call :639,
//     bodies _full_block_kernel :476 / _full_block_stripe_kernel :496)
//   toc3d_tpu/ops/pallas/vit_block.py :: fused_compressed_block (pallas_call
//     :906, bodies _compressed_block_kernel :682 /
//     _compressed_block_stripe_kernel :728, build_gather_matrix :795,
//     _rope_rows :662)
//   and their int8 bodies (quant=True in the same two pallas_calls:
//     _actquant :271 over _rowquant :247 / _statquant :259, _qmm :277)
//
// Bound on the H100 at the main-path shape (ViT-L, C = 1024, hidden 2730,
// 6 x 50 x 100 tokens): a full block is ~0.78 TFLOP of matmul per call
// (8C^2 + 6C*hidden per token plus window attention), ~0.8 ms at
// 989 TFLOP/s, against ~0.12 GB of compulsory traffic (x in and out plus
// 25 MB of weights, ~0.04 ms): operations bound. The compressed blocks do
// the same per kept row on (k+1)/n of the tokens and are operations bound
// too (see chip_smoke.py for the per-call counts). With int8 weights the
// seven weight matmuls run at twice the rate (1979 TOP/s) and the window
// attention stays bf16, so B8 and C8 are still operations bound.
//
// Design: the TPU kernel keeps a whole window resident in VMEM and does
// every matmul inside one grid step. On Hopper the per-token matmuls
// (QKV, O-proj, SwiGLU) are batched over ALL tokens of the map in a tiled
// tensor-core GEMM whose epilogue fuses bias, residual and the SwiGLU gate
// (the TMA + wgmma kernel of gemm_sm90.cuh: kernel G in bf16, kernel G8 in
// int8), and only the softmax attention works per (window, head):
//   layernorm_kernel      LN with f32 two-pass statistics over a row held
//                         in registers (one or four warps a row, 16-byte
//                         accesses; optionally adds a residual first and
//                         stores the sum); rows past valid_rows read as
//                         zero, so LN(0) = beta is the row of every
//                         zero-padded edge token. For int8 it writes the
//                         bf16-rounded output quantized to int8 instead,
//                         with a per-row scale (dynamic) or the calibrated
//                         scale of the site (static): the attn_in, mlp_in
//                         and ffn_in sites
//   rowquant_kernel       the same quantization of a bf16 matrix: the
//                         proj_in site (the merged attention output, whole
//                         only after every head has run); the head
//                         decoder's int8 linears quantize their input inside
//                         their own kernel (int8_linear.cu, H8)
//   window_attention_kernel  one (window, head) per block: stages the
//                         window's k/v rows (by window geometry, or dense
//                         for compressed rows) in shared memory with
//                         pairwise RoPE in f32, then softmax(q k^T) v in
//                         two passes over 64-key tiles (row max, then P =
//                         exp(s - max) and P.V) with S, P and o in
//                         registers (note below)
//   gather_merge_kernel   compressed rows: slow tokens by index plus the
//                         representative row = score-weighted mean of the
//                         fast tokens (weights score / sum(score), pads of
//                         -1e6 included, rounded to bf16 like the TPU
//                         kernel's gather matrix); a grid over rows and
//                         (window, channel chunk), 16-byte accesses
//   scatter_update_kernel slow rows back to their tokens; every fast token
//                         becomes x + (raw1 + raw2) of the representative;
//                         one warp per token, 16-byte accesses
// Full blocks skip the zero-pad materialisation: the attention kernel reads
// out-of-image tokens from one extra QKV row computed from LN(0).
//
// int8 quantization, exactly as the TPU kernel: dynamic rows are
// round(x * (127 / a)) with a = max(amax, 1e-6) and scale a * (1/127);
// static rows round(x * (1 / s)); both clipped to +-127, rounding half to
// even (rintf). The divisions are IEEE (no fast math in NVCC_FLAGS).
#include "gemm.cuh"
#include "gemm_sm90.cuh"

// ---------------------------------------------------------------------------
// LayerNorm
// ---------------------------------------------------------------------------
//
// Replaces _ln (toc3d_tpu/ops/pallas/vit_block.py:63) at the LN1, LN2 and
// SwiGLU sub-LN sites of the block bodies, and with an int8 output the
// _actquant (:271) of the attn_in, mlp_in and ffn_in sites that follows it.
//
// Bound: bytes. A row is read once and written once (2 + 2 bytes an element
// in bf16, 2 + 1 and a 4-byte scale in int8; with a residual, the residual
// is read and the sum stored too) against ~10 f32 operations an element, so
// at the main path's 30001 x 1024 LN1 the call cannot take less than 0.0367
// ms at 3.35 TB/s.
//
// Design: the row resident in registers, one warp a row up to 1024 columns
// and four warps a row above (WPR). Thread t of a row holds accesses j = 0 ..
// CH - 1 of VEC bf16 at columns (32 WPR j + t) * VEC, as packed bf16 pairs:
// all of a thread's loads are issued before the first reduction, and
// neighbouring threads read neighbouring 16-byte chunks (VEC 8), or 4-byte
// pairs (VEC 2) where a base or a row stride is not on 16 bytes (the wrapper
// picks VEC). With a residual, bfr(x + res) is made once, in the registers,
// and stored to sum_out from them. The mean, then the centred sum of squares
// (two passes over the registers, as the plain version's two-pass
// statistics), then the output, which replaces the row in the registers as
// bf16: the int8 forms take amax over those bf16 values and quantize them.
// A row's totals are warp shuffles and, across its warps, shared memory
// behind a barrier of the row's threads. Every column below npad is stored
// once, by the thread that loaded it, after the row's reductions (and their
// barriers), so the in-place sub-LN (y == x) reads its whole row first. The
// tail of a width that is not a multiple of VEC (2730 of the sub-LN) is read
// pair by pair below n and zero-filled, so nothing past n is read. The
// instances are compile-time (CH, VEC, WPR): (4, 8, 1) for the main path's
// 1024 columns and (3, 8, 4) for the sub-LN's 2736, measured against one
// warp holding 11 accesses (which spilled, or with 198 registers left one
// block an SM) and two or eight warps a row; (4, 8, 4) and, for 4-byte
// access, (4, 2, 4) and (8, 2, 8) for any other even width up to
// LN_MAX_WIDTH.

struct LnArgs {
  const bf16* x;
  long long ldx;
  const bf16* res;
  long long ldres;
  bf16* sum_out;
  long long ldsum;
  const float* gamma;
  const float* beta;
  bf16* y;             // bf16 output (rows, npad), row stride ldy
  signed char* yq;     // or the int8 output, same stride
  long long ldy;
  float* yscale;       // int8 dynamic: the rows' scales
  const float* sscale; // int8 static: the site's scale
  int rows, valid_rows, n, npad;
  float eps;
};

constexpr int LN_THREADS = 256;   // 8 rows a block

// resident blocks an instance asks ptxas for, from the registers its data
// takes (32-bit registers a thread holds, x and the residual): left free,
// ptxas hoists every access's gamma and beta loads above the reductions
// and uses up to 255 registers, so fewer blocks fit on an SM
constexpr int ln_min_blocks(int data) {
  return data <= 16 ? 4 : data <= 32 ? 3 : 2;
}

// VEC bf16 (VEC / 2 pairs) of row p from column c: one access of 2 * VEC
// bytes where the access lies below n, else pair by pair below n, zero past
// n or for a row past valid_rows
template <int VEC>
__device__ __forceinline__ void ln_load(unsigned (&d)[VEC / 2], const bf16* p,
                                        int c, int n, bool valid) {
  if (valid && c + VEC <= n) {
    if constexpr (VEC == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      d[0] = u.x;
      d[1] = u.y;
      d[2] = u.z;
      d[3] = u.w;
    } else {
      d[0] = *reinterpret_cast<const unsigned*>(p);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i)
      d[i] = valid && c + 2 * i < n
                 ? *reinterpret_cast<const unsigned*>(p + 2 * i) : 0u;
  }
}

// store the VEC bf16 of d to row p from column c, up to column end
template <int VEC>
__device__ __forceinline__ void ln_store(bf16* p, const unsigned (&d)[VEC / 2],
                                         int c, int end) {
  if (c + VEC <= end) {
    if constexpr (VEC == 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(d[0], d[1], d[2], d[3]);
    else
      *reinterpret_cast<unsigned*>(p) = d[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i)
      if (c + 2 * i < end) *reinterpret_cast<unsigned*>(p + 2 * i) = d[i];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the total of v over the row's WPR warps (a sum, or with MAX a max): a
// warp shuffle, then across the warps through the row's shared-memory slots
// and a barrier of the row's 32 * WPR threads (barrier 1 + the row's index
// in the block)
template <int WPR, bool MAX>
__device__ __forceinline__ float row_total(float v, float* slot, int sub,
                                           int lane, int bar) {
  v = MAX ? warp_max(v) : warp_sum(v);
  if constexpr (WPR > 1) {
    if (lane == 0) slot[sub] = v;
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(32 * WPR) : "memory");
    v = slot[0];
#pragma unroll
    for (int w = 1; w < WPR; ++w) v = MAX ? fmaxf(v, slot[w]) : v + slot[w];
  }
  return v;
}

// CH accesses of VEC bf16 a thread, WPR warps a row
template <int CH, int VEC, bool RES, int WPR>
__global__ void __launch_bounds__(
    LN_THREADS, ln_min_blocks(CH * VEC / 2 * (RES ? 2 : 1)))
    layernorm_kernel(const LnArgs a) {
  constexpr int P = VEC / 2;          // bf16 pairs an access
  constexpr int TR = 32 * WPR;        // threads a row
  __shared__ float red[3][LN_THREADS / 32];   // sum, squares, amax
  const int warp = (blockIdx.x * LN_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = warp % WPR;         // the warp's place in its row
  const int t = sub * 32 + lane;      // the thread's place in its row
  const int rib = (threadIdx.x >> 5) / WPR;   // the row's place in the block
  const long long row = warp / WPR;
  if (row >= a.rows) return;          // the row's warps return together
  const bool valid = row < a.valid_rows;
  const int n = a.n;
  unsigned v[CH][P];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = (TR * j + t) * VEC;
    ln_load<VEC>(v[j], a.x + row * a.ldx + c, c, n, valid);
  }
  if constexpr (RES) {
    unsigned r[CH][P];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = (TR * j + t) * VEC;
      ln_load<VEC>(r[j], a.res + row * a.ldres + c, c, n, valid);
    }
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float2 f = unpack_bf16(v[j][i]), g = unpack_bf16(r[j][i]);
        v[j][i] = pack_bf16(f.x + g.x, f.y + g.y);   // bfr(x + res)
      }
  }
  if (a.sum_out && valid) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = (TR * j + t) * VEC;
      if (c < n) ln_store<VEC>(a.sum_out + row * a.ldsum + c, v[j], c, n);
    }
  }
  // f32 statistics, two passes over the registers (zeros past n add
  // nothing to the sum and are left out of the squares)
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float2 f = unpack_bf16(v[j][i]);
      s += f.x + f.y;
    }
  const float mu =
      row_total<WPR, false>(s, red[0] + rib * WPR, sub, lane, 1 + rib) / n;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float2 f = unpack_bf16(v[j][i]);
      const float dx = f.x - mu, dy = f.y - mu;
      if ((TR * j + t) * VEC + 2 * i < n) q += dx * dx + dy * dy;
    }
  const float rstd = rsqrtf(
      row_total<WPR, false>(q, red[1] + rib * WPR, sub, lane, 1 + rib) / n +
      a.eps);
  // the output, rounded to bf16, in place of the row (zero past n)
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = (TR * j + t) * VEC;
    if (VEC == 8 && c + VEC <= n) {
      const float4* g4 = reinterpret_cast<const float4*>(a.gamma + c);
      const float4* b4 = reinterpret_cast<const float4*>(a.beta + c);
      const float4 g[2] = {__ldg(g4), __ldg(g4 + 1)};
      const float4 b[2] = {__ldg(b4), __ldg(b4 + 1)};
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float2 f = unpack_bf16(v[j][i]);
        const float2 gi = i & 1 ? make_float2(g[i >> 1].z, g[i >> 1].w)
                                : make_float2(g[i >> 1].x, g[i >> 1].y);
        const float2 bi = i & 1 ? make_float2(b[i >> 1].z, b[i >> 1].w)
                                : make_float2(b[i >> 1].x, b[i >> 1].y);
        v[j][i] = pack_bf16((f.x - mu) * rstd * gi.x + bi.x,
                            (f.y - mu) * rstd * gi.y + bi.y);
      }
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int ci = c + 2 * i;
        if (ci < n) {
          const float2 f = unpack_bf16(v[j][i]);
          v[j][i] = pack_bf16(
              (f.x - mu) * rstd * __ldg(a.gamma + ci) + __ldg(a.beta + ci),
              (f.y - mu) * rstd * __ldg(a.gamma + ci + 1) +
                  __ldg(a.beta + ci + 1));
        } else {
          v[j][i] = 0u;
        }
      }
    }
  }
  const int npad = a.npad;
  if (a.yq) {
    // int8: quantize the bf16-rounded output (the TPU kernel quantizes the
    // activation-dtype value), amax over the same values
    float amax = 0.f;
    if (!a.sscale) {
#pragma unroll
      for (int j = 0; j < CH; ++j)
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float2 f = unpack_bf16(v[j][i]);
          amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      amax = row_total<WPR, true>(amax, red[2] + rib * WPR, sub, lane,
                                  1 + rib);
    }
    const float inv = quant_inv(a.sscale, amax,
                                a.yscale ? a.yscale + row : nullptr, t);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = (TR * j + t) * VEC;
      if (c >= npad) continue;
      signed char* p = a.yq + row * a.ldy + c;
      if (VEC == 8 && c + VEC <= npad) {
        const unsigned w0 = quant8x2(v[j][0], inv) |
                            quant8x2(v[j][1 % P], inv) << 16;
        const unsigned w1 = quant8x2(v[j][2 % P], inv) |
                            quant8x2(v[j][3 % P], inv) << 16;
        *reinterpret_cast<uint2*>(p) = make_uint2(w0, w1);
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i)
          if (c + 2 * i < npad)
            *reinterpret_cast<unsigned short*>(p + 2 * i) =
                static_cast<unsigned short>(quant8x2(v[j][i], inv));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = (TR * j + t) * VEC;
      if (c < npad) ln_store<VEC>(a.y + row * a.ldy + c, v[j], c, npad);
    }
  }
}

template <int CH, int VEC, int WPR = 1>
static int ln_launch(const LnArgs& a, cudaStream_t stream) {
  constexpr int rpb = LN_THREADS / (32 * WPR);   // rows a block
  const int blocks = (a.rows + rpb - 1) / rpb;
  if (blocks > 0) {
    if (a.res)
      layernorm_kernel<CH, VEC, true, WPR>
          <<<blocks, LN_THREADS, 0, stream>>>(a);
    else
      layernorm_kernel<CH, VEC, false, WPR>
          <<<blocks, LN_THREADS, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// LayerNorm of rows x rows (row stride ldx; rows past valid_rows read as
// zero) over n columns, + res first when given (stored to sum_out when
// given), into y (bf16) or yq (int8, with the rows' scales yscale, or the
// static scale sscale), rows of npad columns (zero past n), row stride ldy;
// vec: 8 (16-byte accesses; every base 16-byte aligned and every row stride
// a multiple of 8 elements) or 2 (4-byte accesses)
TOC3D_EXPORT int toc3d_layernorm(const void* x, int ldx, const void* res,
                                 int ldres, void* sum_out, int ldsum,
                                 const void* gamma, const void* beta, void* y,
                                 int ldy, void* yq, void* yscale,
                                 const void* sscale, int rows, int valid_rows,
                                 int n, int npad, float eps, int vec,
                                 void* stream) {
  LnArgs a;
  a.x = static_cast<const bf16*>(x);
  a.ldx = ldx;
  a.res = static_cast<const bf16*>(res);
  a.ldres = ldres;
  a.sum_out = static_cast<bf16*>(sum_out);
  a.ldsum = ldsum;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.y = static_cast<bf16*>(y);
  a.yq = static_cast<signed char*>(yq);
  a.ldy = ldy;
  a.yscale = static_cast<float*>(yscale);
  a.sscale = static_cast<const float*>(sscale);
  a.rows = rows;
  a.valid_rows = valid_rows;
  a.n = n;
  a.npad = npad;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instance for npad columns: <accesses a thread, elements an access,
  // warps a row>, covering CH * 32 * WPR * VEC columns
  if (vec == 8) {
    if (npad <= 1024) return ln_launch<4, 8, 1>(a, s);
    if (npad <= 3072) return ln_launch<3, 8, 4>(a, s);
    if (npad <= 4096) return ln_launch<4, 8, 4>(a, s);
  } else if (vec == 2) {
    if (npad <= 1024) return ln_launch<4, 2, 4>(a, s);
    if (npad <= 4096) return ln_launch<8, 2, 8>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// row quantization (one warp per row)
// ---------------------------------------------------------------------------

__global__ void rowquant_kernel(const bf16* x, long long ldx, int rows, int n,
                                const float* sscale, signed char* q,
                                long long ldq, float* scale) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const long long row = warp;
  const bf16* xr = x + row * ldx;
  float amax = 0.f;
  if (!sscale) {
    for (int c = lane * 2; c < n; c += 64) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const bf162*>(xr + c));
      amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
    }
    amax = warp_max(amax);
  }
  const float inv = quant_inv(sscale, amax, scale ? scale + row : nullptr,
                              lane);
  for (int c = lane * 2; c < n; c += 64) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const bf162*>(xr + c));
    char2 o;
    o.x = quant8(v.x * inv);
    o.y = quant8(v.y * inv);
    *reinterpret_cast<char2*>(q + row * ldq + c) = o;
  }
}

TOC3D_EXPORT int toc3d_rowquant(const void* x, int ldx, int rows, int n,
                                const void* sscale, void* q, int ldq,
                                void* scale, void* stream) {
  const int threads = 256;
  const int blocks = (rows + (threads / 32) - 1) / (threads / 32);
  if (blocks > 0)
    rowquant_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), ldx, rows, n,
        static_cast<const float*>(sscale), static_cast<signed char*>(q), ldq,
        static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// GEMM (gemm_sm90.cuh: G bf16, G8 int8; gemm.cuh: the mma.sync oracle)
// ---------------------------------------------------------------------------

// bf16 x bf16 -> f32 GEMM on the TMA + wgmma kernel (kernel G)
TOC3D_EXPORT int toc3d_gemm(const void* A, int lda, const void* B, int ldb,
                            const void* bias, const void* res, int ldr,
                            void* C, int ldc, int M, int N, int K, int out_f32,
                            int gate, void* stream) {
  gemm::Args a;
  a.A = A;
  a.lda = lda;
  a.B = B;
  a.ldb = ldb;
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const bf16*>(res);
  a.ldr = ldr;
  a.C = C;
  a.ldc = ldc;
  a.M = M;
  a.N = N;
  a.K = K;
  a.out_f32 = out_f32;
  a.gate = gate;
  return gemm90::launch<bf16>(a, static_cast<cudaStream_t>(stream));
}

static gemm::Args s8_args(const void* A, int lda, const void* xs, int xs_row,
                          const void* B, int ldb, const void* ws,
                          const void* bias, const void* res, int ldr, void* C,
                          int ldc, int M, int N, int K, int out_f32, int gate,
                          int head) {
  gemm::Args a;
  a.A = A;
  a.lda = lda;
  a.B = B;
  a.ldb = ldb;
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const bf16*>(res);
  a.ldr = ldr;
  a.C = C;
  a.ldc = ldc;
  a.M = M;
  a.N = N;
  a.K = K;
  a.out_f32 = out_f32;
  a.gate = gate;
  a.xs = static_cast<const float*>(xs);
  a.xs_row = xs_row;
  a.ws = static_cast<const float*>(ws);
  a.head = head;
  return a;
}

// int8 x int8 -> int32 GEMM on gemm.cuh's mma.sync tile (on no main path:
// the oracle of G8 and, with head, of H8), dequantized by xs (per row, or one
// static scale when xs_row is 0) and ws (per output channel) before the
// epilogue
TOC3D_EXPORT int toc3d_gemm_s8(const void* A, int lda, const void* xs,
                               int xs_row, const void* B, int ldb,
                               const void* ws, const void* bias,
                               const void* res, int ldr, void* C, int ldc,
                               int M, int N, int K, int out_f32, int gate,
                               int head, void* stream) {
  return gemm::launch(
      s8_args(A, lda, xs, xs_row, B, ldb, ws, bias, res, ldr, C, ldc, M, N, K,
              out_f32, gate, head),
      static_cast<cudaStream_t>(stream));
}

// the same GEMM on the TMA + wgmma kernel (kernel G8, the weight matmuls of
// B8 and C8), with the blocks' epilogues (no head form); ldc is the output's
// row stride in elements
TOC3D_EXPORT int toc3d_gemm_s8_sm90(const void* A, int lda, const void* xs,
                                    int xs_row, const void* B, int ldb,
                                    const void* ws, const void* bias,
                                    const void* res, int ldr, void* C,
                                    int ldc, int M, int N, int K, int out_f32,
                                    int gate, void* stream) {
  return gemm90::launch<int8_t>(
      s8_args(A, lda, xs, xs_row, B, ldb, ws, bias, res, ldr, C, ldc, M, N, K,
              out_f32, gate, 0),
      static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// window attention
// ---------------------------------------------------------------------------

struct WinGeom {
  int image;  // 1: rows by window geometry on a (B, H, W) map; 0: dense
  int H, W, ws, nwh, nww;
  long long pad_row;  // image mode: the row holding LN(0)'s projection
};

__device__ __forceinline__ long long token_row(int w, int t, int H, int W,
                                               int ws, int nwh, int nww) {
  const int per = nwh * nww;
  const int b = w / per, rem = w - b * per;
  const int wi = rem / nww, wj = rem - wi * nww;
  const int r = wi * ws + t / ws, c = wj * ws + t % ws;
  if (r >= H || c >= W) return -1;
  return ((long long)b * H + r) * W + c;
}

__device__ __forceinline__ long long attn_row(const WinGeom& g, int w, int n,
                                              int t) {
  if (!g.image) return (long long)w * n + t;
  long long r = token_row(w, t, g.H, g.W, g.ws, g.nwh, g.nww);
  return r < 0 ? g.pad_row : r;
}

// element offset of 16-byte chunk ch of row r in a (rows, D) bf16 tile whose
// chunks are XOR-swizzled by row: the 8 rows that one ldmatrix phase reads
// land on 8 distinct 16-byte bank groups, with no padding
template <int D>
__device__ __forceinline__ int swz(int r, int ch) {
  constexpr int CH = D / 8;   // chunks per row: 4 (two rows per 128 B) or 8
  return r * D + ((ch ^ ((CH == 8 ? r : r >> 1) & (CH - 1))) << 3);
}

// pairwise rotate-half RoPE of one pair (a, b) -> (-b, a), in f32
__device__ __forceinline__ void rope2(float& a, float& b, float c0, float c1,
                                      float s0, float s1) {
  const float na = a * c0 + (-b) * s0;
  const float nb = b * c1 + a * s1;
  a = na;
  b = nb;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ uint4 pack8(const float4& a, const float4& b) {
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

// Window attention of one (head, window) per block, softmax(q k^T) v over
// the window's n tokens (or a compressed window's kr rows).
//
// Bound: operations. At ws 16 (B) it is 4 n^2 C = 45 GFLOP a call over the
// 168 windows (~45 us at 989 TFLOP/s) and 176 M exponentials (~50 us on
// the SFUs), against the 369 MB f32 qkv read once (~110 us at 3.35 TB/s):
// the read of qkv bounds it at the main-path shapes.
//
// Design (FlashAttention's register-resident tiles, on a window that fits
// on chip): the block stages the window's K and V once, as bf16 in shared
// memory: 16-byte chunks of 8 values, read as two float4 loads of the f32
// qkv rows, K rotated (RoPE) in f32 on the way; rows are XOR-swizzled, not
// padded, so K/V of a ws 20 window at d = 64 take 100 KB and two blocks fit
// on an SM. Each warp then owns 16 query rows at a time: it builds its q
// fragments straight from the f32 rows (RoPE in f32; a quad of lanes reads
// 32 contiguous bytes of a row, whole sectors, and the tables in float2
// pairs) and walks the keys in 64-key
// tiles: S = q k^T and o += bf16(P) v are mma.sync m16n8k16 products on
// ldmatrix fragments (V transposed on the load), and S, P, o and the row
// statistics stay in registers, never in shared memory. The block has
// ceil(tiles / rounds) warps for rounds = ceil(tiles / 8), so 13 query
// tiles (kr = 201) run as 7 + 6 on 7 warps and 25 (n = 400) as 7 + 7 + 7
// + 4. Rows past n are zero in shared memory and their logits -inf.
//
// Two passes over the keys, not one: pass 1 takes each row's max, pass 2
// forms P = exp(s - max) with expf, at the plain version's rounding points.
// A one-pass online softmax (running max, as flash_partial_kernel) stayed
// inside the attention-delta bound at every main-path shape, but rounds P
// at the running max, so most attention outputs moved by a last bf16 bit;
// B8 and C8 quantize that output (proj_in) and the MLP's inputs to int8,
// where a last-bit move flips whole int8 steps, and their block outputs
// then exceeded the 2^-6 mean bound (B8 ws 16 static on an H100: 0.0179
// against 0.0131). The second pass recomputes q k^T (one more mma.sync
// per P.V one) and keeps S in registers all the same.
//
// Image mode reads the rows of each window by geometry and points
// out-of-image tokens at the LN(0) row (pad_row); their outputs are not
// stored.

// S = q k^T for 16 query rows x the 64 keys from key0, logits of keys past
// n at -inf (keys past npad are not read)
template <int D>
__device__ __forceinline__ void window_scores(float (&s)[8][4],
                                              unsigned (&qf)[D / 16][4],
                                              const bf16* Ks, int key0, int n,
                                              int npad, int lane) {
  const int b_row = ldsm_b_row(lane), b_half = ldsm_b_half(lane);
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (key0 + jj * 16 < npad) {
        unsigned r[4];
        ldsm_x4(r, Ks + swz<D>(key0 + jj * 16 + b_row, kk * 2 + b_half));
        mma16816(s[2 * jj], qf[kk], r[0], r[1]);
        mma16816(s[2 * jj + 1], qf[kk], r[2], r[3]);
      }
    }
  if (key0 + 64 > n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = key0 + j * 8 + 2 * t;
      if (key >= n) s[j][0] = s[j][2] = -INFINITY;
      if (key + 1 >= n) s[j][1] = s[j][3] = -INFINITY;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256, 2) window_attention_kernel(
    const float* qkv, const int* pos, const float* cosT, const float* sinT,
    bf16* out, int n, int npad, int heads, WinGeom g) {
  constexpr int CH = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = heads * D;
  const int h = blockIdx.x, w = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + npad * D;
  int* rowid = reinterpret_cast<int*>(Vs + npad * D);   // qkv row, -1 past n
  int* prow = rowid + npad;                            // RoPE table row

  for (int r = tid; r < npad; r += nthreads) {
    rowid[r] = r < n ? static_cast<int>(attn_row(g, w, n, r)) : -1;
    prow[r] = (r < n && pos) ? pos[(long long)w * n + r] : r;
  }
  __syncthreads();
  for (int idx = tid; idx < npad * CH; idx += nthreads) {
    const int r = idx / CH, ch = idx - r * CH;
    const int R = rowid[r];
    uint4 kq = make_uint4(0u, 0u, 0u, 0u), vq = kq;
    if (R >= 0) {
      const float* base = qkv + (long long)R * 3 * C + C + h * D + ch * 8;
      float4 k0 = ld4(base), k1 = ld4(base + 4);
      if (cosT) {
        const long long tr = (long long)prow[r] * D + ch * 8;
        const float4 c0 = ld4(cosT + tr), c1 = ld4(cosT + tr + 4);
        const float4 s0 = ld4(sinT + tr), s1 = ld4(sinT + tr + 4);
        rope2(k0.x, k0.y, c0.x, c0.y, s0.x, s0.y);
        rope2(k0.z, k0.w, c0.z, c0.w, s0.z, s0.w);
        rope2(k1.x, k1.y, c1.x, c1.y, s1.x, s1.y);
        rope2(k1.z, k1.w, c1.z, c1.w, s1.z, s1.w);
      }
      kq = pack8(k0, k1);
      vq = pack8(ld4(base + C), ld4(base + C + 4));
    }
    *reinterpret_cast<uint4*>(Ks + swz<D>(r, ch)) = kq;
    *reinterpret_cast<uint4*>(Vs + swz<D>(r, ch)) = vq;
  }
  __syncthreads();

  const int a_row = ldsm_a_row(lane), a_half = ldsm_a_half(lane);
  const int gq = lane >> 2, t = lane & 3;
  const int nqt = npad / 16, nkt = (npad + 63) / 64;
  for (int qt = warp; qt < nqt; qt += nwarps) {
    // q fragments: rows gq and gq + 8, columns (2t, 2t + 1) and
    // (2t + 8, 2t + 9) of each 16-column chunk (the m16n8k16 A layout)
    unsigned qf[D / 16][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = qt * 16 + gq + 8 * rr;
      const int R = rowid[r];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int col = kk * 16 + hf * 8 + 2 * t;
          float2 x = make_float2(0.f, 0.f);
          if (R >= 0) {
            x = *reinterpret_cast<const float2*>(qkv + (long long)R * 3 * C +
                                                 h * D + col);
            if (cosT) {
              const long long tr = (long long)prow[r] * D + col;
              const float2 c = *reinterpret_cast<const float2*>(cosT + tr);
              const float2 sn = *reinterpret_cast<const float2*>(sinT + tr);
              rope2(x.x, x.y, c.x, c.y, sn.x, sn.y);
            }
          }
          qf[kk][rr + 2 * hf] = pack_bf16(x.x, x.y);
        }
    }

    // pass 1: the row maxima over all keys
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int kt = 0; kt < nkt; ++kt) {
      float s[8][4];
      window_scores<D>(s, qf, Ks, kt * 64, n, npad, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    // pass 2: p = exp(s - max) in f32, l = sum p, o += bf16(p) v
    float o[D / 8][4];
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nn][e] = 0.f;
    float l0 = 0.f, l1 = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      const int key0 = kt * 64;
      float s[8][4];
      window_scores<D>(s, qf, Ks, key0, n, npad, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = expf(s[j][0] - m0);
        s[j][1] = expf(s[j][1] - m0);
        s[j][2] = expf(s[j][2] - m1);
        s[j][3] = expf(s[j][3] - m1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if (key0 + kc * 16 < npad) {
          unsigned pa[4];
          p_fragment(pa, s, kc);
#pragma unroll
          for (int dd = 0; dd < D / 16; ++dd) {
            unsigned r[4];
            ldsm_x4_trans(r, Vs + swz<D>(key0 + kc * 16 + a_row,
                                         dd * 2 + a_half));
            mma16816(o[2 * dd], pa, r[0], r[1]);
            mma16816(o[2 * dd + 1], pa, r[2], r[3]);
          }
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = qt * 16 + gq + 8 * rr;
      const int R = rowid[r];
      if (R < 0 || (g.image && R == g.pad_row)) continue;
      const float l = rr ? l1 : l0;
      bf16* dst = out + (long long)R * C + h * D + 2 * t;
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn)
        *reinterpret_cast<bf162*>(dst + nn * 8) = __floats2bfloat162_rn(
            o[nn][2 * rr] / l, o[nn][2 * rr + 1] / l);
    }
  }
}

// the launch shape of a window of n rows: threads, dynamic shared bytes
template <int D>
static void window_attention_shape(int n, int* threads, int* smem) {
  const int npad = (n + 15) / 16 * 16;
  const int tiles = npad / 16;
  const int rounds = (tiles + 7) / 8;
  *threads = 32 * ((tiles + rounds - 1) / rounds);
  *smem = npad * (4 * D + 8);   // K, V bf16; row and RoPE indices
}

template <int D>
static int set_window_attention_smem() {
  static bool attr_set = false;
  if (attr_set) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      window_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      227 * 1024);
  if (e != cudaSuccess) return static_cast<int>(e);
  attr_set = true;
  return 0;
}

template <int D>
static int launch_window_attention(const float* qkv, const int* pos,
                                   const float* cosT, const float* sinT,
                                   bf16* out, int nw, int n, int heads,
                                   const WinGeom& g, cudaStream_t stream) {
  if (int e = set_window_attention_smem<D>()) return e;
  if (nw <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  int threads, smem;
  window_attention_shape<D>(n, &threads, &smem);
  dim3 grid(heads, nw);
  window_attention_kernel<D><<<grid, threads, smem, stream>>>(
      qkv, pos, cosT, sinT, out, n, (n + 15) / 16 * 16, heads, g);
  return static_cast<int>(cudaGetLastError());
}

TOC3D_EXPORT int toc3d_window_attention(const void* qkv, const void* pos,
                                        const void* cosT, const void* sinT,
                                        void* out, int nw, int n, int heads,
                                        int head_dim, int image, int B, int H,
                                        int W, int ws, void* stream) {
  WinGeom g;
  g.image = image;
  g.H = H;
  g.W = W;
  g.ws = ws;
  g.nwh = ws > 0 ? (H + ws - 1) / ws : 0;
  g.nww = ws > 0 ? (W + ws - 1) / ws : 0;
  g.pad_row = (long long)B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qkv);
  const int* p = static_cast<const int*>(pos);
  const float* c = static_cast<const float*>(cosT);
  const float* sn = static_cast<const float*>(sinT);
  bf16* o = static_cast<bf16*>(out);
  if (head_dim == 64)
    return launch_window_attention<64>(q, p, c, sn, o, nw, n, heads, g, s);
  if (head_dim == 32)
    return launch_window_attention<32>(q, p, c, sn, o, nw, n, heads, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
static int window_attention_occupancy(int n) {
  if (int e = set_window_attention_smem<D>()) return -e;
  int threads, smem, nb = 0;
  window_attention_shape<D>(n, &threads, &smem);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, window_attention_kernel<D>, threads, smem);
  return e == cudaSuccess ? nb : -static_cast<int>(e);
}

// resident blocks per SM of the window attention for windows of n rows (for
// the record), or -(CUDA error)
TOC3D_EXPORT int toc3d_window_attention_occupancy(int n, int head_dim) {
  if (head_dim == 64) return window_attention_occupancy<64>(n);
  if (head_dim == 32) return window_attention_occupancy<32>(n);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// compressed-block gather / merge and scatter / update
// ---------------------------------------------------------------------------
//
// Bound: bytes. At ws 16, ratio .5 the gather reads the 61 MB map (slow rows
// and, for the representative rows, the fast ones) and writes the 44 MB of
// gathered rows; the scatter reads ~120 MB (s1, raw2, the fast tokens of x)
// and writes the 61 MB map: ~0.03 and ~0.05 ms at 3.35 TB/s.
//
// Design: a grid over rows, not windows. One warp per row turns the
// window-local index into a token row once (the window geometry's integer
// divisions, once per row, not per element) and moves the row in 16-byte
// chunks, 8 bf16 per lane. The representative row of a window is reduced
// by blocks over (window, 64-channel chunk): the block forms the weights
// bf16(score / bf16(sum score)) of the window's fast tokens once (the -1e6
// pads included, the f32 sum rounded to bf16 as gather.py:40-47 and
// _gather_rows_plain do) and their token rows in shared memory, then its 32
// x 8 threads split the fast tokens 32 ways and the channels 8 ways (16
// bytes each) and sum the 32 partial rows in shared memory.

__device__ __forceinline__ void bf16x8(uint4 v, float* f) {
  const bf162* p = reinterpret_cast<const bf162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 to_bf16x8(const float* f) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

constexpr int REP_CH = 64;   // channels per representative-row block

__global__ void __launch_bounds__(256) gather_merge_kernel(
    const bf16* x, const int* slow_idx, const int* fast_idx,
    const float* fast_score, bf16* xs, int H, int W, int C, int ws, int nwh,
    int nww, int nw, int k, int nf, int has_rep, int slow_blocks) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kr = k + has_rep, nch = C / 8;
  if (static_cast<int>(blockIdx.x) < slow_blocks) {
    // slow rows: row = w * k + i
    const long long row = (long long)blockIdx.x * 8 + warp;
    if (row >= (long long)nw * k) return;
    const int w = static_cast<int>(row / k);
    const int i = static_cast<int>(row - (long long)w * k);
    const long long src = token_row(w, slow_idx[row], H, W, ws, nwh, nww);
    uint4* dst = reinterpret_cast<uint4*>(xs + ((long long)w * kr + i) * C);
    const uint4* s = reinterpret_cast<const uint4*>(x + src * C);
    for (int c = lane; c < nch; c += 32)
      dst[c] = src >= 0 ? s[c] : make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  // representative row of window w, channels [c0, c0 + REP_CH)
  extern __shared__ __align__(16) float rep_smem[];
  float* red = rep_smem;                         // 32 x REP_CH partial sums
  float* wgt = red + 32 * REP_CH;                // nf weights
  int* src = reinterpret_cast<int*>(wgt + nf);   // nf token rows (-1: pad)
  __shared__ float part[8];
  __shared__ __align__(16) bf16 row_out[REP_CH];
  const int chunks = (C + REP_CH - 1) / REP_CH;
  const int rb = blockIdx.x - slow_blocks;
  const int w = rb / chunks, c0 = (rb - w * chunks) * REP_CH;
  const float* fs = fast_score + (long long)w * nf;
  float d = 0.f;
  for (int j = tid; j < nf; j += 256) d += fs[j];
  d = warp_sum(d);
  if (lane == 0) part[warp] = d;
  __syncthreads();
  float denom = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) denom += part[i];
  denom = bfr(denom);
  for (int j = tid; j < nf; j += 256) {
    wgt[j] = bfr(fs[j] / denom);
    src[j] = static_cast<int>(token_row(w, fast_idx[(long long)w * nf + j],
                                        H, W, ws, nwh, nww));
  }
  __syncthreads();
  const int cg = tid & 7, jl = tid >> 3;
  const int c = c0 + cg * 8;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  if (c < C) {
    for (int j = jl; j < nf; j += 32) {
      const int sr = src[j];
      if (sr < 0) continue;
      float v[8];
      bf16x8(*reinterpret_cast<const uint4*>(x + (long long)sr * C + c), v);
      const float wj = wgt[j];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += wj * v[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[jl * REP_CH + cg * 8 + e] = acc[e];
  __syncthreads();
  if (tid < REP_CH) {
    float sum = 0.f;
    for (int j = 0; j < 32; ++j) sum += red[j * REP_CH + tid];
    row_out[tid] = __float2bfloat16(sum);
  }
  __syncthreads();
  if (tid < REP_CH / 8 && c0 + tid * 8 < C)
    *reinterpret_cast<uint4*>(xs + ((long long)w * kr + k) * C + c0 +
                              tid * 8) =
        reinterpret_cast<const uint4*>(row_out)[tid];
}

// one warp per window token (row = w * n + t): t < k is slow row t, the rest
// fast token t - k
__global__ void __launch_bounds__(256) scatter_update_kernel(
    const bf16* x, const bf16* s1, const bf16* raw1, const bf16* raw2,
    const int* slow_idx, const int* fast_idx, bf16* out, int H, int W, int C,
    int ws, int nwh, int nww, int nw, int k, int nf, int has_rep) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = k + nf, kr = k + has_rep, nch = C / 8;
  const long long row = (long long)blockIdx.x * 8 + warp;
  if (row >= (long long)nw * n) return;
  const int w = static_cast<int>(row / n);
  const int t = static_cast<int>(row - (long long)w * n);
  const bool slow = t < k;
  const int local = slow ? slow_idx[(long long)w * k + t]
                         : fast_idx[(long long)w * nf + (t - k)];
  const long long dst = token_row(w, local, H, W, ws, nwh, nww);
  if (dst < 0) return;
  uint4* o = reinterpret_cast<uint4*>(out + dst * C);
  if (slow) {
    // y = bf16(s1 + raw2)
    const long long sr = ((long long)w * kr + t) * C;
    const uint4* a = reinterpret_cast<const uint4*>(s1 + sr);
    const uint4* b = reinterpret_cast<const uint4*>(raw2 + sr);
    for (int c = lane; c < nch; c += 32) {
      float fa[8], fb[8];
      bf16x8(a[c], fa);
      bf16x8(b[c], fb);
#pragma unroll
      for (int e = 0; e < 8; ++e) fa[e] += fb[e];
      o[c] = to_bf16x8(fa);
    }
    return;
  }
  // x + bf16(raw1 + raw2) of the representative row, or x unchanged
  const uint4* xv = reinterpret_cast<const uint4*>(x + dst * C);
  const long long rr = ((long long)w * kr + k) * C;
  const uint4* a = reinterpret_cast<const uint4*>(raw1 + rr);
  const uint4* b = reinterpret_cast<const uint4*>(raw2 + rr);
  for (int c = lane; c < nch; c += 32) {
    if (!has_rep) {
      o[c] = xv[c];
      continue;
    }
    float fx[8], fa[8], fb[8];
    bf16x8(xv[c], fx);
    bf16x8(a[c], fa);
    bf16x8(b[c], fb);
#pragma unroll
    for (int e = 0; e < 8; ++e) fx[e] += bfr(fa[e] + fb[e]);
    o[c] = to_bf16x8(fx);
  }
}

TOC3D_EXPORT int toc3d_gather_merge(const void* x, const void* slow_idx,
                                    const void* fast_idx,
                                    const void* fast_score, void* xs, int nw,
                                    int H, int W, int C, int ws, int k, int nf,
                                    int has_rep, void* stream) {
  const int nwh = (H + ws - 1) / ws, nww = (W + ws - 1) / ws;
  if (C % 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long slow_blocks = ((long long)nw * k + 7) / 8;
  const long long rep_blocks =
      has_rep ? (long long)nw * ((C + REP_CH - 1) / REP_CH) : 0;
  const int smem = has_rep ? (32 * REP_CH + 2 * nf) * 4 : 0;
  if (slow_blocks + rep_blocks > 0)
    gather_merge_kernel<<<static_cast<unsigned>(slow_blocks + rep_blocks), 256,
                          smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const int*>(slow_idx),
        static_cast<const int*>(fast_idx),
        static_cast<const float*>(fast_score), static_cast<bf16*>(xs), H, W, C,
        ws, nwh, nww, nw, k, nf, has_rep, static_cast<int>(slow_blocks));
  return static_cast<int>(cudaGetLastError());
}

TOC3D_EXPORT int toc3d_scatter_update(const void* x, const void* s1,
                                      const void* raw1, const void* raw2,
                                      const void* slow_idx,
                                      const void* fast_idx, void* out, int nw,
                                      int H, int W, int C, int ws, int k,
                                      int nf, int has_rep, void* stream) {
  const int nwh = (H + ws - 1) / ws, nww = (W + ws - 1) / ws;
  if (C % 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = ((long long)nw * (k + nf) + 7) / 8;
  if (blocks > 0)
    scatter_update_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(s1),
        static_cast<const bf16*>(raw1), static_cast<const bf16*>(raw2),
        static_cast<const int*>(slow_idx), static_cast<const int*>(fast_idx),
        static_cast<bf16*>(out), H, W, C, ws, nwh, nww, nw, k, nf, has_rep);
  return static_cast<int>(cudaGetLastError());
}
