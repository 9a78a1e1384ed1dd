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
//   window_attention_kernel  a persistent block an SM over the (window,
//                         head) items: producer warps copy each item's bf16
//                         q/k/v rows (by window geometry, or dense for
//                         compressed rows; RoPE already applied by the QKV
//                         GEMM's epilogue) as 64-row tiles into a ring in
//                         shared memory; consumer warpgroups run
//                         softmax(q k^T) v on them
//                         with wgmma, S, P and o in registers, in one pass
//                         (online softmax, bf16 blocks) or two (row max,
//                         then P = exp(s - max); int8 blocks) (note below)
//   gather_merge_kernel   compressed rows: slow tokens by index plus the
//                         representative row = score-weighted mean of the
//                         fast tokens (weights score / sum(score), pads of
//                         -1e6 included, rounded to bf16 like the TPU
//                         kernel's gather matrix); a grid over rows and
//                         (window, channel chunk), 16-byte accesses
//   scatter_update_kernel slow rows back to their tokens; every fast token
//                         becomes x + (raw1 + raw2) of the representative;
//                         one warp per token, 16-byte accesses
// The QKV GEMM hands the attention bf16 q / k / v with RoPE applied in f32
// before the rounding (gemm_sm90.cuh OUT_QKV). Full blocks skip the zero-pad
// materialisation: where windows pass the map's edge, the QKV GEMM runs ws^2
// more rows of LN(0), one rotated at each window place, and the attention
// kernel reads an out-of-image token at place t from the t-th of them.
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

// the QKV epilogue's fields of a (gemm_sm90.cuh OUT_QKV): RoPE tables cos_t
// / sin_t (positions x rope_d f32, or null), rotated columns rope_cols, and
// each row's table row: pos (int32 a row), else the (B, map_h, map_w) map
// of map_rows rows in windows of side win, then one row a window place
static void qkv_args(gemm::Args& a, const void* cos_t, const void* sin_t,
                     const void* pos, int rope_d, int rope_cols, int map_h,
                     int map_w, int win, int map_rows) {
  a.cos_t = static_cast<const float*>(cos_t);
  a.sin_t = static_cast<const float*>(sin_t);
  a.pos = static_cast<const int*>(pos);
  a.rope_d = rope_d;
  a.rope_cols = rope_cols;
  a.map_h = map_h;
  a.map_w = map_w;
  a.win = win;
  a.map_rows = map_rows;
}

// kernel G with the QKV epilogue: bf16 (M, N) q / k / v, RoPE applied
TOC3D_EXPORT int toc3d_gemm_qkv(const void* A, int lda, const void* B,
                                int ldb, const void* bias, void* C, int ldc,
                                int M, int N, int K, const void* cos_t,
                                const void* sin_t, const void* pos,
                                int rope_d, int rope_cols, int map_h,
                                int map_w, int win, int map_rows,
                                void* stream) {
  gemm::Args a;
  a.A = A;
  a.lda = lda;
  a.B = B;
  a.ldb = ldb;
  a.bias = static_cast<const float*>(bias);
  a.res = nullptr;
  a.ldr = 0;
  a.C = C;
  a.ldc = ldc;
  a.M = M;
  a.N = N;
  a.K = K;
  a.out_f32 = 0;
  a.gate = 0;
  qkv_args(a, cos_t, sin_t, pos, rope_d, rope_cols, map_h, map_w, win,
           map_rows);
  return gemm90::launch_qkv<bf16>(a, static_cast<cudaStream_t>(stream));
}

// kernel G8 with the QKV epilogue (dequantized as toc3d_gemm_s8_sm90)
TOC3D_EXPORT int toc3d_gemm_s8_sm90_qkv(
    const void* A, int lda, const void* xs, int xs_row, const void* B,
    int ldb, const void* ws, const void* bias, void* C, int ldc, int M, int N,
    int K, const void* cos_t, const void* sin_t, const void* pos, int rope_d,
    int rope_cols, int map_h, int map_w, int win, int map_rows,
    void* stream) {
  gemm::Args a = s8_args(A, lda, xs, xs_row, B, ldb, ws, bias, nullptr, 0, C,
                         ldc, M, N, K, 0, 0, 0);
  qkv_args(a, cos_t, sin_t, pos, rope_d, rope_cols, map_h, map_w, win,
           map_rows);
  return gemm90::launch_qkv<int8_t>(a, static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// window attention
// ---------------------------------------------------------------------------

struct WinGeom {
  int image;  // 1: rows by window geometry on a (B, H, W) map; 0: dense
  int H, W, ws, nwh, nww;
  long long pad_row;  // image mode: the first of the ws^2 rows of LN(0)'s
                      // projection (row pad_row + t: at window place t)
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

// the qkv rows of one window: row t of the window (t < n) is a token of the
// map by geometry, or LN(0)'s row at place t where that token lies outside
// the image (image mode), or dense row w n + t
struct WinRows {
  long long base;  // image: the map row of the window's (0, 0) token
  int r0, c0;      // image: that token's map row and column
  __device__ __forceinline__ WinRows(const WinGeom& g, int w, int n) {
    if (g.image) {
      const int per = g.nwh * g.nww;
      const int b = w / per, rem = w - b * per;
      const int wi = rem / g.nww;
      r0 = wi * g.ws;
      c0 = (rem - wi * g.nww) * g.ws;
      base = ((long long)b * g.H + r0) * g.W + c0;
    } else {
      r0 = c0 = 0;
      base = (long long)w * n;
    }
  }
  __device__ __forceinline__ long long row(const WinGeom& g, int t) const {
    if (!g.image) return base + t;
    const int dr = t / g.ws, dc = t - dr * g.ws;
    if (r0 + dr >= g.H || c0 + dc >= g.W) return g.pad_row + t;
    return base + (long long)dr * g.W + dc;
  }
};

// element offset of 16-byte chunk ch of row r in a (rows, D) bf16 tile whose
// chunks are XOR-swizzled by row (wgmma's 128-byte swizzle at d = 64, the
// 64-byte one at d = 32): the 8 rows that one ldmatrix phase reads land on
// 8 distinct 16-byte bank groups, with no padding
template <int D>
__device__ __forceinline__ int swz(int r, int ch) {
  constexpr int CH = D / 8;   // chunks per row: 4 (two rows per 128 B) or 8
  return r * D + ((ch ^ ((CH == 8 ? r : r >> 1) & (CH - 1))) << 3);
}

// Window attention of one (window, head) item at a time, softmax(q k^T) v
// over the window's n tokens (or a compressed window's kr rows), as two
// bodies of one source: the one-pass body (ONE_PASS, the bf16 blocks B and
// C) and the two-pass body (the int8 blocks B8 and C8). The wrapper picks
// the body from the weight pack.
//
// Bound. At ws 16 (B) a call is 4 n^2 C = 45 GFLOP over the 168 windows
// (~45 us at 989 TFLOP/s) and 176 M exponentials (~50 us on the SFUs),
// against the 184 MB bf16 q / k / v read once (~55 us at 3.35 TB/s) and the
// 61 MB bf16 output: at B the products and exponentials bound it, at the
// compressed blocks' few rows a window mostly the read.
//
// Design (a persistent grid, warp-specialized, FlashAttention's
// register-resident tiles): one block of 16 warps on each SM walks the
// (window, head) items blockIdx.x, + gridDim.x, ... (the heads of a window
// are neighbouring items, so the blocks in flight read neighbouring 128-byte
// pieces of the same qkv rows). A ring of 64-row slots in shared memory
// (9 slots of 24 KB at d = 64, 16 of 12 KB at d = 32), each slot holding
// the bf16 Q, K and V of 64 rows of one item in the 128-byte (d = 64) or
// 64-byte (d = 32) XOR swizzle, with a full and an empty mbarrier each:
//   producer, one warpgroup (setmaxnreg to 40 registers): for each of an
//     item's ceil(n / 64) tiles, once the slot is empty, copies the q, k
//     and v head rows of the tile's 64 rows from global memory into the
//     slot with 16-byte cp.async (rows past n zero-filled), up to three
//     tiles in flight; when a tile's copies have landed, fences them for
//     the async proxy that wgmma reads through, and each warp arrives on
//     the slot's full barrier.
//   consumer, three warpgroups (setmaxnreg to 152 registers): at d = 64, the
//     items' 64-row query tiles in one round robin over the warpgroups;
//     S = q k^T by wgmma m64n64k16 from the Q and K slots (both K-major),
//     o += bf16(P) v by wgmma with P from registers and v transposed, S, P,
//     o and the row statistics in registers (the accumulator is mma.sync's
//     m16n8 layout, which is the A fragment of P.V). At d = 32 the twelve
//     warps take 16-row query tiles in one round robin and run mma.sync
//     m16n8k16 on ldmatrix fragments (no main path runs d = 32). A warp
//     leaves an item by waiting for each of its slots to be full (so that
//     it never arrives on an empty barrier ahead of the producer's phase)
//     and arriving on each empty barrier; a slot is refilled when all 12
//     have left.
// The whole window is resident while its query tiles run (a query tile
// walks every key tile), so the ring holds one ws 20 window (7 slots) and
// two more slots, or two ws 16 windows (4 slots each) and one more. Why
// wgmma, and 64-row query tiles: with mma.sync on eight warps the
// consumers alone took 0.34 ms at B ws 16 and bounded the kernel; wgmma's
// asynchronous products and operands read straight from the ring took them
// to 0.20 ms. Its 64-row tiles pad a window's last query tile (400 rows:
// 448; 77: 128). Until the QKV epilogue took RoPE over, eight producer
// warps read f32 q / k / v and the tables and rotated them, and that read
// bounded the kernel at every main-path shape; copying bf16 needs one
// warpgroup, and a third consumer warpgroup at the same 152 registers took
// the one-pass calls 11% and the two-pass ones 13% faster over the
// frame's eight call shapes (H100, CUDA events, outputs bit for bit).
//
// The one-pass body keeps a running row max and sum (FlashAttention-2's
// rescale of o) with p = 2^(s log2e - m log2e) by ex2.approx (the max
// subtraction and the scale one FFMA; online_softmax_tile, as kernel D),
// and multiplies by 1 / l at the end. P is rounded to bf16 at the running
// max for P.V, so most outputs move by a last bf16 bit against the two-pass
// form, inside the attention-delta bound at every main-path shape
// (ops/cuda/vit_block.py holds its plain twin). The two-pass body keeps the
// rounding points of the int8 blocks: pass 1 takes each row's max over all
// keys, pass 2 forms P = exp(s - max) with expf at that max, and o / l is
// an IEEE divide. B8 and C8 quantize the attention output (proj_in) and the
// MLP's inputs to int8, where a last-bit move flips whole int8 steps: with
// the one-pass form their block outputs exceeded the 2^-6 mean bound (B8
// ws 16 static on an H100: 0.0179 against 0.0131). The two bodies share
// the load path, and wgmma's sums equal mma.sync's, so the int8 body's
// values are the earlier kernel's, bit for bit (checked on an H100 at the
// main-path shapes).
//
// Measured (an H100 80GB HBM3 at 700 W, CUDA events, against the earlier
// kernel, which read f32 q / k / v and rotated them, in the same process):
// one-pass B ws 16 0.193 ms (0.264), B ws 20 0.313 (0.396), C ws 16 .5
// 0.069 (0.132), C ws 20 .5 0.093 (0.141), C ws 16 .3 0.057 (0.092);
// two-pass 0.316 (0.353), 0.452 (0.549), 0.086 (0.147), 0.158 (0.192),
// 0.086 (0.124). The QKV epilogue that took the rotation over costs G
// 0.3242 against 0.3169 ms at B's rows, and G8 0.2352 against 0.2078.
//
// Image mode reads the rows of each window by geometry and points
// out-of-image tokens at LN(0)'s rows (pad_row + place); their outputs are
// not stored. Keys past n are -inf; their rows are zero in the ring.

constexpr int WA_TILE = 64;       // rows a slot holds (the key tile)
constexpr int WA_CONSUMERS = 12;  // warps: three warpgroups
constexpr int WA_PRODUCERS = 4;   // warps: one warpgroup
// registers a thread of each role keeps after setmaxnreg: 128 x 40 + 384 x
// 152 = 63488 of the SM's 65536
constexpr int WA_PRODUCER_REGS = 40, WA_CONSUMER_REGS = 152;
constexpr int WA_THREADS = 32 * (WA_CONSUMERS + WA_PRODUCERS);

template <int D>
struct WaRing {
  static constexpr int SLOTS = D == 64 ? 9 : 16;
  static constexpr int MAT = WA_TILE * D;      // bf16 elements of a tile
  static constexpr int SLOT = 3 * MAT;         // Q, K, V
  static constexpr int BYTES = SLOTS * SLOT * 2 + 2 * SLOTS * 8 + 1024;
};

// the logits of keys past n at -inf (key0: the window's index of the
// tile's first key; t: the thread's column pair in the m16n8 layout)
__device__ __forceinline__ void mask_keys(float (&s)[8][4], int key0, int n,
                                          int t) {
  if (key0 + 64 > n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = key0 + j * 8 + 2 * t;
      if (key >= n) s[j][0] = s[j][2] = -INFINITY;
      if (key + 1 >= n) s[j][1] = s[j][3] = -INFINITY;
    }
  }
}

// d = 32 (mma.sync): S = q k^T for 16 query rows x the 64 keys of tile Kt,
// whose first key is key key0 of the window, keys past n masked (16-key
// chunks at or past npad are not read)
template <int D>
__device__ __forceinline__ void window_scores(float (&s)[8][4],
                                              unsigned (&qf)[D / 16][4],
                                              const bf16* Kt, int key0, int n,
                                              int npad, int lane) {
  const int b_row = ldsm_b_row(lane), b_half = ldsm_b_half(lane);
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
        ldsm_x4(r, Kt + swz<D>(jj * 16 + b_row, kk * 2 + b_half));
        mma16816(s[2 * jj], qf[kk], r[0], r[1]);
        mma16816(s[2 * jj + 1], qf[kk], r[2], r[3]);
      }
    }
  mask_keys(s, key0, n, lane & 3);
}

// d = 32: o += bf16(P) v over the 64 keys of tile Vt (key0 as above)
template <int D>
__device__ __forceinline__ void window_pv(float (&o)[D / 8][4],
                                          float (&s)[8][4], const bf16* Vt,
                                          int key0, int npad, int lane) {
  const int a_row = ldsm_a_row(lane), a_half = ldsm_a_half(lane);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    if (key0 + kc * 16 < npad) {
      unsigned pa[4];
      p_fragment(pa, s, kc);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        unsigned r[4];
        ldsm_x4_trans(r, Vt + swz<D>(kc * 16 + a_row, dd * 2 + a_half));
        mma16816(o[2 * dd], pa, r[0], r[1]);
        mma16816(o[2 * dd + 1], pa, r[2], r[3]);
      }
    }
  }
}

// the producer warps' part: thread p (0 .. 127) owns 16-byte chunk ch of
// the rows r0, r0 + RPP, ... of each tile (a pass: one such row) and copies
// it from q, k and v into the slot's three swizzled tiles with cp.async
// (rows past n as zeros: a copy of 0 bytes zero-fills). The copies of a
// tile go out once its slot is empty, and the slot is handed to the
// consumers `lag` tiles later, when the thread's copies of it have landed,
// so that lag + 1 tiles are in flight. lag is at most WA_LAG and leaves a
// window's T tiles and the copies ahead of them room in the ring (T + lag
// <= SLOTS): a consumer that waits on a tile of its window then never waits
// on copies that wait for a slot it holds.
constexpr int WA_LAG = 2;

// wait for all but the newest lag groups of this thread's copies
__device__ __forceinline__ void cp_async_wait_lag(int lag) {
  if (lag >= 2)
    cp_async_wait<2>();
  else if (lag == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

template <int D>
__device__ __forceinline__ void window_produce(const bf16* qkv, int n,
                                               int heads, int items,
                                               const WinGeom& g, bf16* ring,
                                               uint64_t* full,
                                               uint64_t* empty, int p) {
  using R = WaRing<D>;
  constexpr int CH = D / 8;                      // 16-byte chunks of a head
  constexpr int RPP = WA_PRODUCERS * 32 / CH;    // rows a pass covers
  constexpr int PASSES = WA_TILE / RPP;
  static_assert(PASSES * RPP == WA_TILE, "whole passes a tile");
  const int C = heads * D;
  const int ch = p % CH, r0 = p / CH;
  const int T = (n + WA_TILE - 1) / WA_TILE;
  const int tiles = ((items - 1 - blockIdx.x) / gridDim.x + 1) * T;
  const int lag = WA_LAG < R::SLOTS - T ? WA_LAG : R::SLOTS - T;
  // the slot of tile u is full once every producer warp has arrived
  auto hand_over = [&](int u) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if ((p & 31) == 0) gemm90::mbar_arrive(&full[u % R::SLOTS]);
  };
  int i = 0, j = 0;   // the block's item and its tile
  for (int tp = 0; tp < tiles; ++tp) {
    const int it = blockIdx.x + i * gridDim.x;
    const int w = it / heads, h = it - w * heads;
    const WinRows rows(g, w, n);
    const int slot = tp % R::SLOTS;
    bf16* Qs = ring + slot * R::SLOT;
    gemm90::mbar_wait(&empty[slot], ((tp / R::SLOTS) & 1) ^ 1);
#pragma unroll
    for (int e = 0; e < PASSES; ++e) {
      const int r = e * RPP + r0, tok = j * WA_TILE + r;
      const bool on = tok < n;
      const bf16* src =
          qkv + (on ? rows.row(g, tok) * 3 * C + h * D + ch * 8 : 0);
      const int o = swz<D>(r, ch);
      cp_async16(Qs + o, src, on);
      cp_async16(Qs + R::MAT + o, src + C, on);
      cp_async16(Qs + 2 * R::MAT + o, src + 2 * C, on);
    }
    cp_async_commit();
    if (tp >= lag) {
      // the ring's copies are generic-proxy writes that wgmma reads through
      // the async proxy
      cp_async_wait_lag(lag);
      hand_over(tp - lag);
    }
    if (++j == T) {
      j = 0;
      ++i;
    }
  }
  cp_async_wait<0>();
  for (int u = tiles > lag ? tiles - lag : 0; u < tiles; ++u) hand_over(u);
}

// a consumer warp's side of the ring: ready(i, j) waits for tile j of the
// block's i-th item to be full and returns its slot; leave(upto, lane)
// releases the items before upto, each after waiting for its slots to be
// full, so that no arrival on an empty barrier runs ahead of the producer
template <int D>
struct WaView {
  const bf16* ring;
  uint64_t* full;
  uint64_t* empty;
  int T;          // slots an item takes
  int left = 0;   // items this warp has left
  __device__ __forceinline__ const bf16* ready(int i, int j) const {
    const int u = i * T + j, slot = u % WaRing<D>::SLOTS;
    gemm90::mbar_wait(&full[slot], (u / WaRing<D>::SLOTS) & 1);
    return ring + slot * WaRing<D>::SLOT;
  }
  __device__ __forceinline__ void leave(int upto, int lane) {
    for (; left < upto; ++left)
      for (int j = 0; j < T; ++j) {
        ready(left, j);
        __syncwarp();
        if (lane == 0)
          gemm90::mbar_arrive(&empty[(left * T + j) % WaRing<D>::SLOTS]);
      }
  }
};

// o / l of the thread's two rows r0 and r0 + 8 of a window, in bf16, to
// their qkv rows (out-of-image and past-n rows are not stored); the
// two-pass body divides (IEEE), the one-pass body multiplies by 1 / l
template <int D, bool ONE_PASS>
__device__ __forceinline__ void window_store(bf16* out, float (&o)[D / 8][4],
                                             float l0, float l1, int r0,
                                             int n, int w, int h, int C,
                                             const WinGeom& g, int t) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const WinRows rows(g, w, n);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    if (r >= n) continue;
    const long long Rw = rows.row(g, r);
    if (g.image && Rw >= g.pad_row) continue;
    const float l = rr ? l1 : l0, inv = 1.f / l;
    bf16* dst = out + Rw * C + h * D + 2 * t;
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
      *reinterpret_cast<bf162*>(dst + nn * 8) =
          ONE_PASS ? __floats2bfloat162_rn(o[nn][2 * rr] * inv,
                                           o[nn][2 * rr + 1] * inv)
                   : __floats2bfloat162_rn(o[nn][2 * rr] / l,
                                           o[nn][2 * rr + 1] / l);
  }
}

// the two-pass body's first pass over one tile of logits: the row maxima
__device__ __forceinline__ void row_max(float (&s)[8][4], float& m0,
                                        float& m1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
}

// the two-pass body's second pass over one tile: p = exp(s - max) in f32
// at the final max, l += p
__device__ __forceinline__ void exp_at_max(float (&s)[8][4], float m0,
                                           float m1, float& l0, float& l1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = expf(s[j][0] - m0);
    s[j][1] = expf(s[j][1] - m0);
    s[j][2] = expf(s[j][2] - m1);
    s[j][3] = expf(s[j][3] - m1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
}

__device__ __forceinline__ void quad_max(float& m0, float& m1) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
}

// the consumer at d = 32 (mma.sync): warp c takes the block's 16-row query
// tiles c, c + 12, ... in order over its items
template <int D, bool ONE_PASS>
__device__ __forceinline__ void window_consume_mma(bf16* out, int n,
                                                   int heads, int items,
                                                   const WinGeom& g,
                                                   WaView<D>& v, int warp,
                                                   int lane) {
  using R = WaRing<D>;
  const int C = heads * D, T = v.T;
  const int nqt = (n + 15) / 16, npad = nqt * 16;
  const int mine = (items - 1 - blockIdx.x) / gridDim.x + 1;
  const int a_row = ldsm_a_row(lane), a_half = ldsm_a_half(lane);
  const int gq = lane >> 2, t = lane & 3;
  for (int gt = warp; gt < mine * nqt; gt += WA_CONSUMERS) {
    const int i = gt / nqt, qt = gt - i * nqt;
    v.leave(i, lane);
    const int it = blockIdx.x + i * gridDim.x;
    const int w = it / heads, h = it - w * heads;
    unsigned qf[D / 16][4];
    {
      const bf16* Qs = v.ready(i, qt >> 2);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], Qs + swz<D>((qt & 3) * 16 + a_row, kk * 2 + a_half));
    }
    float o[D / 8][4];
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nn][e] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    if constexpr (ONE_PASS) {
      for (int kt = 0; kt < T; ++kt) {
        const bf16* Ks = v.ready(i, kt) + R::MAT;
        float s[8][4];
        window_scores<D>(s, qf, Ks, kt * 64, n, npad, lane);
        online_softmax_tile<D / 8>(s, m0, m1, l0, l1, o);
        window_pv<D>(o, s, Ks + R::MAT, kt * 64, npad, lane);
      }
    } else {
      for (int kt = 0; kt < T; ++kt) {
        float s[8][4];
        window_scores<D>(s, qf, v.ready(i, kt) + R::MAT, kt * 64, n, npad,
                         lane);
        row_max(s, m0, m1);
      }
      quad_max(m0, m1);
      for (int kt = 0; kt < T; ++kt) {
        const bf16* Ks = v.ready(i, kt) + R::MAT;
        float s[8][4];
        window_scores<D>(s, qf, Ks, kt * 64, n, npad, lane);
        exp_at_max(s, m0, m1, l0, l1);
        window_pv<D>(o, s, Ks + R::MAT, kt * 64, npad, lane);
      }
    }
    window_store<D, ONE_PASS>(out, o, l0, l1, qt * 16 + gq, n, w, h, C, g,
                              t);
  }
  v.leave(mine, lane);
}

// wgmma m64n64k16, f32 (+)= bf16 x bf16, for the window attention at d = 64:
// d is a warp's m16n8 accumulator layout over its 16 rows of the 64 (d[j]:
// columns 8j .. 8j + 7), as mma.sync's. wa_wgmma_ss: A and B from shared
// memory, both K-major (q k^T); wa_wgmma_rs: A from registers (the m16n8k16
// A fragment of the warp's rows: P) and B transposed, MN-major (v)
#define WA_WGMMA_D                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define WA_WGMMA_ACC \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
  "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
  "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
  "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
  "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
  "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

__device__ __forceinline__ void wa_wgmma_ss(float (&d)[8][4], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WA_WGMMA_D
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WA_WGMMA_ACC
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wa_wgmma_rs(float (&d)[8][4],
                                            const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WA_WGMMA_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WA_WGMMA_ACC
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef WA_WGMMA_ACC
#undef WA_WGMMA_D

// issue S = q k^T for a warpgroup's 64 query rows (the Q tile at
// descriptor dq) x the 64 keys of tile Kt, as one wgmma group
__device__ __forceinline__ void wg_qk(float (&s)[8][4], uint64_t dq,
                                      const bf16* Kt) {
  const uint64_t dk = gemm90::sw128_desc(Kt);
  gemm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)   // 16 columns a step: 32 bytes, 2 units
    wa_wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
  gemm90::wgmma_commit();
}

// S = q k^T of tile Kt, waited for, keys past n masked
__device__ __forceinline__ void wg_scores(float (&s)[8][4], uint64_t dq,
                                          const bf16* Kt, int key0, int n,
                                          int t) {
  wg_qk(s, dq, Kt);
  gemm90::wgmma_wait<0>();
  gemm90::fence_acc(reinterpret_cast<float(&)[32]>(s));
  mask_keys(s, key0, n, t);
}

// issue o += bf16(P) v over the 64 keys of tile Vt as one wgmma group: P
// from registers (pa, which must live until the group completes), v
// transposed (16 keys a step: two 8-row groups, 2048 bytes, 128 units)
__device__ __forceinline__ void wg_pv(float (&o)[8][4], float (&s)[8][4],
                                      unsigned (&pa)[4][4], const bf16* Vt) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) p_fragment(pa[kc], s, kc);
  const uint64_t dv = gemm90::sw128_desc(Vt);
  gemm90::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) wa_wgmma_rs(o, pa[kc], dv + 128 * kc);
  gemm90::wgmma_commit();
}

// the consumer at d = 64 (wgmma): warpgroup c (warps 4c .. 4c + 3) takes
// the block's 64-row query tiles c, c + 3, ... in order over its items;
// warp 4c + q holds rows 16q .. 16q + 15 of a tile
template <bool ONE_PASS>
__device__ __forceinline__ void window_consume_wgmma(bf16* out, int n,
                                                     int heads, int items,
                                                     const WinGeom& g,
                                                     WaView<64>& v, int warp,
                                                     int lane) {
  using R = WaRing<64>;
  constexpr int GROUPS = WA_CONSUMERS / 4;
  const int C = heads * 64, T = v.T;
  const int mine = (items - 1 - blockIdx.x) / gridDim.x + 1;
  const int wg = warp >> 2, wq = warp & 3, gq = lane >> 2, t = lane & 3;
  for (int gm = wg; gm < mine * T; gm += GROUPS) {
    const int i = gm / T, mt = gm - i * T;
    v.leave(i, lane);
    const int it = blockIdx.x + i * gridDim.x;
    const int w = it / heads, h = it - w * heads;
    const uint64_t dq = gemm90::sw128_desc(v.ready(i, mt));
    float o[8][4];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nn][e] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    unsigned pa[4][4];
    float s[8][4];
    if constexpr (!ONE_PASS) {
      // the first pass two tiles to a wait
      float s2[8][4];
      for (int kt = 0; kt < T; kt += 2) {
        const bool two = kt + 1 < T;
        wg_qk(s, dq, v.ready(i, kt) + R::MAT);
        if (two) wg_qk(s2, dq, v.ready(i, kt + 1) + R::MAT);
        gemm90::wgmma_wait<0>();
        gemm90::fence_acc(reinterpret_cast<float(&)[32]>(s));
        gemm90::fence_acc(reinterpret_cast<float(&)[32]>(s2));
        mask_keys(s, kt * 64, n, t);
        row_max(s, m0, m1);
        if (two) {
          mask_keys(s2, kt * 64 + 64, n, t);
          row_max(s2, m0, m1);
        }
      }
      quad_max(m0, m1);
    }
    for (int kt = 0; kt < T; ++kt) {
      const bf16* Ks = v.ready(i, kt) + R::MAT;
      wg_scores(s, dq, Ks, kt * 64, n, t);
      if constexpr (ONE_PASS)
        online_softmax_tile<8>(s, m0, m1, l0, l1, o);
      else
        exp_at_max(s, m0, m1, l0, l1);
      wg_pv(o, s, pa, Ks + R::MAT);
      gemm90::wgmma_wait<0>();
      gemm90::fence_acc(reinterpret_cast<float(&)[32]>(o));
    }
    window_store<64, ONE_PASS>(out, o, l0, l1, mt * 64 + wq * 16 + gq, n, w,
                               h, C, g, t);
  }
  v.leave(mine, lane);
}

template <int D, bool ONE_PASS>
__global__ void __launch_bounds__(WA_THREADS, 1) window_attention_kernel(
    const bf16* qkv, bf16* out, int n, int heads, int items, WinGeom g) {
  using R = WaRing<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the ring on a 1024-byte boundary: the 128-byte swizzle of wgmma's
  // operands repeats every 8 rows of 128 bytes
  unsigned char* base =
      smem_raw + ((1024 - (gemm90::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + R::SLOTS * R::SLOT * 2);
  uint64_t* empty = full + R::SLOTS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::SLOTS; ++s) {
      gemm90::mbar_init(&full[s], WA_PRODUCERS);   // a lane 0 a warp
      gemm90::mbar_init(&empty[s], WA_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= WA_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        WA_PRODUCER_REGS));
    window_produce<D>(qkv, n, heads, items, g, ring, full, empty,
                      threadIdx.x - 32 * WA_CONSUMERS);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      WA_CONSUMER_REGS));
  WaView<D> v{ring, full, empty, (n + WA_TILE - 1) / WA_TILE};
  if constexpr (D == 64)
    window_consume_wgmma<ONE_PASS>(out, n, heads, items, g, v, warp, lane);
  else
    window_consume_mma<D, ONE_PASS>(out, n, heads, items, g, v, warp, lane);
}

template <int D, bool ONE_PASS>
static int window_attention_blocks_per_sm() {
  static int nb = 0;
  if (nb) return nb;
  cudaError_t e = cudaFuncSetAttribute(
      window_attention_kernel<D, ONE_PASS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, WaRing<D>::BYTES);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int v = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &v, window_attention_kernel<D, ONE_PASS>, WA_THREADS, WaRing<D>::BYTES);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (v < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  nb = v;
  return nb;
}

template <int D, bool ONE_PASS>
static int launch_window_attention(const bf16* qkv, bf16* out, int nw, int n,
                                   int heads, const WinGeom& g,
                                   cudaStream_t stream) {
  static int sms = 0;
  const int nb = window_attention_blocks_per_sm<D, ONE_PASS>();
  if (nb < 0) return -nb;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (nw <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  // a window's tiles must all fit in the ring at once
  if ((n + WA_TILE - 1) / WA_TILE > WaRing<D>::SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = nw * heads;
  const int grid = items < sms * nb ? items : sms * nb;
  window_attention_kernel<D, ONE_PASS>
      <<<grid, WA_THREADS, WaRing<D>::BYTES, stream>>>(qkv, out, n, heads,
                                                        items, g);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
static int launch_window_attention(int one_pass, const bf16* qkv, bf16* out,
                                   int nw, int n, int heads, const WinGeom& g,
                                   cudaStream_t stream) {
  return one_pass ? launch_window_attention<D, true>(qkv, out, nw, n, heads,
                                                     g, stream)
                  : launch_window_attention<D, false>(qkv, out, nw, n, heads,
                                                      g, stream);
}

// qkv: the bf16 (rows, 3 heads head_dim) q / k / v of the QKV epilogue,
// RoPE applied; in image mode rows B H W .. B H W + ws^2 - 1 hold LN(0)'s
// projection at each window place (needed only where windows pass the
// map's edge). one_pass: 1 for the bf16 blocks' body, 0 for the int8
// blocks'
TOC3D_EXPORT int toc3d_window_attention(const void* qkv, void* out, int nw,
                                        int n, int heads, int head_dim,
                                        int image, int B, int H, int W,
                                        int ws, int one_pass, void* stream) {
  WinGeom g;
  g.image = image;
  g.H = H;
  g.W = W;
  g.ws = ws;
  g.nwh = ws > 0 ? (H + ws - 1) / ws : 0;
  g.nww = ws > 0 ? (W + ws - 1) / ws : 0;
  g.pad_row = (long long)B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  if (head_dim == 64)
    return launch_window_attention<64>(one_pass, q, o, nw, n, heads, g, s);
  if (head_dim == 32)
    return launch_window_attention<32>(one_pass, q, o, nw, n, heads, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// resident blocks per SM of a body of the window attention (for the record;
// the ring's size does not depend on n), or -(CUDA error)
TOC3D_EXPORT int toc3d_window_attention_occupancy(int head_dim,
                                                  int one_pass) {
  if (head_dim == 64)
    return one_pass ? window_attention_blocks_per_sm<64, true>()
                    : window_attention_blocks_per_sm<64, false>();
  if (head_dim == 32)
    return one_pass ? window_attention_blocks_per_sm<32, true>()
                    : window_attention_blocks_per_sm<32, false>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

// the ring slots of the window attention at head_dim: a window of n rows
// launches if ceil(n / 64) <= slots
TOC3D_EXPORT int toc3d_window_attention_slots(int head_dim) {
  if (head_dim == 64) return WaRing<64>::SLOTS;
  if (head_dim == 32) return WaRing<32>::SLOTS;
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
