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
// tensor-core GEMM (gemm.cuh) whose epilogue fuses bias, residual and the
// SwiGLU gate, and only the softmax attention works per (window, head):
//   layernorm_kernel      LN with f32 two-pass statistics (optionally adds
//                         a residual first and stores the sum); rows past
//                         valid_rows read as zero, so LN(0) = beta is the
//                         row of every zero-padded edge token. For int8 it
//                         writes the bf16-rounded output quantized to int8
//                         instead, with a per-row scale (dynamic) or the
//                         calibrated scale of the site (static): the
//                         attn_in, mlp_in and ffn_in sites
//   rowquant_kernel       the same quantization of a bf16 matrix: the
//                         proj_in site (the merged attention output, whole
//                         only after every head has run) and the inputs of
//                         the head decoder's int8 linears
//   window_attention_kernel  one (window, head) per block: loads the
//                         window's q/k/v rows (by window geometry, or dense
//                         for compressed rows), applies pairwise RoPE in
//                         f32, then softmax(q k^T) v with WMMA in two passes
//                         (row max, then exp/sum and P.V) so P is
//                         exp(s - max) exactly as the TPU kernel forms it
//   gather_merge_kernel   compressed rows: slow tokens by index plus the
//                         representative row = score-weighted mean of the
//                         fast tokens (weights score / sum(score), pads of
//                         -1e6 included, rounded to bf16 like the TPU
//                         kernel's gather matrix)
//   scatter_update_kernel slow rows back to their tokens; every fast token
//                         becomes x + (raw1 + raw2) of the representative
// Full blocks skip the zero-pad materialisation: the attention kernel reads
// out-of-image tokens from one extra QKV row computed from LN(0).
//
// int8 quantization, exactly as the TPU kernel: dynamic rows are
// round(x * (127 / a)) with a = max(amax, 1e-6) and scale a * (1/127);
// static rows round(x * (1 / s)); both clipped to +-127, rounding half to
// even (rintf). The divisions are IEEE (no fast math in NVCC_FLAGS).
#include "gemm.cuh"

// ---------------------------------------------------------------------------
// LayerNorm
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 ln_load(const bf16* x, long long ldx,
                                          const bf16* res, long long ldres,
                                          long long row, int c, bool valid) {
  if (!valid) return make_float2(0.f, 0.f);
  float2 a = __bfloat1622float2(
      *reinterpret_cast<const bf162*>(x + row * ldx + c));
  if (res) {
    float2 r = __bfloat1622float2(
        *reinterpret_cast<const bf162*>(res + row * ldres + c));
    a.x = bfr(a.x + r.x);
    a.y = bfr(a.y + r.y);
  }
  return a;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ signed char quant8(float v) {
  return static_cast<signed char>(
      static_cast<int>(fminf(fmaxf(rintf(v), -127.f), 127.f)));
}

// the multiplier that quantizes a row: 1 / s for a static scale s, else
// 127 / max(amax, 1e-6) (the row's scale a * (1/127) goes to *scale_out)
__device__ __forceinline__ float quant_inv(const float* sscale, float amax,
                                           float* scale_out, int lane) {
  if (sscale) return 1.0f / sscale[0];
  const float a = fmaxf(amax, 1e-6f);
  if (lane == 0) *scale_out = a * (1.0f / 127.0f);
  return 127.0f / a;
}

__global__ void layernorm_kernel(const bf16* x, long long ldx, const bf16* res,
                                 long long ldres, bf16* sum_out,
                                 long long ldsum, const float* gamma,
                                 const float* beta, bf16* y, long long ldy,
                                 signed char* yq, float* yscale,
                                 const float* sscale, int rows,
                                 int valid_rows, int n, int npad, float eps) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const long long row = warp;
  const bool valid = row < valid_rows;
  float s = 0.f;
  for (int c = lane * 2; c < n; c += 64) {
    float2 v = ln_load(x, ldx, res, ldres, row, c, valid);
    s += v.x + v.y;
  }
  const float mu = warp_sum(s) / n;
  float q = 0.f;
  for (int c = lane * 2; c < n; c += 64) {
    float2 v = ln_load(x, ldx, res, ldres, row, c, valid);
    const float dx = v.x - mu, dy = v.y - mu;
    q += dx * dx + dy * dy;
  }
  const float rstd = rsqrtf(warp_sum(q) / n + eps);
  float inv = 0.f;
  if (yq) {
    // int8 output: quantize the LN output as rounded to bf16 (the TPU
    // kernel quantizes the activation-dtype value), amax over those values
    float amax = 0.f;
    if (!sscale) {
      for (int c = lane * 2; c < n; c += 64) {
        float2 v = ln_load(x, ldx, res, ldres, row, c, valid);
        amax = fmaxf(amax, fabsf(bfr((v.x - mu) * rstd * gamma[c] + beta[c])));
        amax = fmaxf(amax, fabsf(bfr((v.y - mu) * rstd * gamma[c + 1] +
                                     beta[c + 1])));
      }
      amax = warp_max(amax);
    }
    inv = quant_inv(sscale, amax, yscale ? yscale + row : nullptr, lane);
  }
  for (int c = lane * 2; c < npad; c += 64) {
    float o0 = 0.f, o1 = 0.f;
    if (c < n) {
      float2 v = ln_load(x, ldx, res, ldres, row, c, valid);
      if (sum_out && valid)
        *reinterpret_cast<bf162*>(sum_out + row * ldsum + c) =
            __floats2bfloat162_rn(v.x, v.y);
      o0 = (v.x - mu) * rstd * gamma[c] + beta[c];
      o1 = (v.y - mu) * rstd * gamma[c + 1] + beta[c + 1];
    }
    if (yq) {
      char2 o;
      o.x = c < n ? quant8(bfr(o0) * inv) : 0;
      o.y = c < n ? quant8(bfr(o1) * inv) : 0;
      *reinterpret_cast<char2*>(yq + row * ldy + c) = o;
    } else {
      *reinterpret_cast<bf162*>(y + row * ldy + c) =
          __floats2bfloat162_rn(o0, o1);
    }
  }
}

TOC3D_EXPORT int toc3d_layernorm(const void* x, int ldx, const void* res,
                                 int ldres, void* sum_out, int ldsum,
                                 const void* gamma, const void* beta, void* y,
                                 int ldy, void* yq, void* yscale,
                                 const void* sscale, int rows, int valid_rows,
                                 int n, int npad, float eps, void* stream) {
  const int threads = 256;
  const int blocks = (rows + (threads / 32) - 1) / (threads / 32);
  if (blocks > 0)
    layernorm_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(res), ldres,
        static_cast<bf16*>(sum_out), ldsum, static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<bf16*>(y), ldy,
        static_cast<signed char*>(yq), static_cast<float*>(yscale),
        static_cast<const float*>(sscale), rows, valid_rows, n, npad, eps);
  return static_cast<int>(cudaGetLastError());
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
// GEMM (see gemm.cuh)
// ---------------------------------------------------------------------------

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
  a.pH = a.pW = a.pgh = a.pgw = a.ps = 0;
  return gemm::launch<false>(a, static_cast<cudaStream_t>(stream));
}

// int8 x int8 -> int32 GEMM, dequantized by xs (per row, or one static
// scale when xs_row is 0) and ws (per output channel) before the epilogue
TOC3D_EXPORT int toc3d_gemm_s8(const void* A, int lda, const void* xs,
                               int xs_row, const void* B, int ldb,
                               const void* ws, const void* bias,
                               const void* res, int ldr, void* C, int ldc,
                               int M, int N, int K, int out_f32, int gate,
                               int head, void* stream) {
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
  a.pH = a.pW = a.pgh = a.pgw = a.ps = 0;
  a.xs = static_cast<const float*>(xs);
  a.xs_row = xs_row;
  a.ws = static_cast<const float*>(ws);
  a.head = head;
  return gemm::launch<false, int8_t>(a, static_cast<cudaStream_t>(stream));
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

template <int D>
__global__ void __launch_bounds__(256) window_attention_kernel(
    const float* qkv, const int* pos, const float* cosT, const float* sinT,
    bf16* out, int n, int npad, int heads, WinGeom g) {
  constexpr int LDS = D + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = heads * D;
  const int h = blockIdx.x, w = blockIdx.y;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + npad * LDS;
  bf16* Vs = Ks + npad * LDS;
  float* Sall = reinterpret_cast<float*>(smem_raw + 3 * npad * LDS * 2);
  bf16* Pall = reinterpret_cast<bf16*>(Sall + 8 * 256);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* S = Sall + warp * 256;
  bf16* P = Pall + warp * 256;

  for (int idx = threadIdx.x; idx < npad * (D / 2); idx += blockDim.x) {
    const int t = idx / (D / 2);
    const int p2 = (idx - t * (D / 2)) * 2;
    float q0 = 0.f, q1 = 0.f, k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    if (t < n) {
      const long long row = attn_row(g, w, n, t);
      const float* base = qkv + row * 3 * C + h * D + p2;
      q0 = base[0];
      q1 = base[1];
      k0 = base[C];
      k1 = base[C + 1];
      v0 = base[2 * C];
      v1 = base[2 * C + 1];
      if (cosT) {
        const int ps = pos ? pos[(long long)w * n + t] : t;
        const float* cr = cosT + (long long)ps * D + p2;
        const float* sr = sinT + (long long)ps * D + p2;
        // pairwise rotate-half: (a, b) -> (-b, a)
        const float nq0 = q0 * cr[0] + (-q1) * sr[0];
        const float nq1 = q1 * cr[1] + q0 * sr[1];
        const float nk0 = k0 * cr[0] + (-k1) * sr[0];
        const float nk1 = k1 * cr[1] + k0 * sr[1];
        q0 = nq0;
        q1 = nq1;
        k0 = nk0;
        k1 = nk1;
      }
    }
    *reinterpret_cast<bf162*>(Qs + t * LDS + p2) = __floats2bfloat162_rn(q0, q1);
    *reinterpret_cast<bf162*>(Ks + t * LDS + p2) = __floats2bfloat162_rn(k0, k1);
    *reinterpret_cast<bf162*>(Vs + t * LDS + p2) = __floats2bfloat162_rn(v0, v1);
  }
  __syncthreads();

  const int nt = npad / 16;
  const int r = lane >> 1, half = lane & 1;
  for (int qt = warp; qt < nt; qt += 8) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16];
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd)
      wmma::load_matrix_sync(qf[dd], Qs + qt * 16 * LDS + dd * 16, LDS);

    // pass 1: row max over the valid keys
    float m = TOC3D_NEG_INF;
    for (int kt = 0; kt < nt; ++kt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + kt * 16 * LDS + dd * 16, LDS);
        wmma::mma_sync(s, qf[dd], kf, s);
      }
      wmma::store_matrix_sync(S, s, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int key = kt * 16 + half * 8 + e;
        if (key < n) m = fmaxf(m, S[r * 16 + half * 8 + e]);
      }
      __syncwarp();
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

    // pass 2: p = exp(s - m), l = sum p (f32), o = bf16(p) . v
    float l = 0.f;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[D / 16];
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) wmma::fill_fragment(o[dd], 0.f);
    for (int kt = 0; kt < nt; ++kt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + kt * 16 * LDS + dd * 16, LDS);
        wmma::mma_sync(s, qf[dd], kf, s);
      }
      wmma::store_matrix_sync(S, s, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int key = kt * 16 + half * 8 + e;
        const float p = key < n ? expf(S[r * 16 + half * 8 + e] - m) : 0.f;
        l += p;
        P[r * 16 + half * 8 + e] = __float2bfloat16(p);
      }
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, P, 16);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kt * 16 * LDS + dd * 16, LDS);
        wmma::mma_sync(o[dd], pf, vf, o[dd]);
      }
      __syncwarp();
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);

    const int t = qt * 16 + r;
    long long row = -1;
    if (t < n) {
      row = attn_row(g, w, n, t);
      if (g.image && row == g.pad_row) row = -1;
    }
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      wmma::store_matrix_sync(S, o[dd], 16, wmma::mem_row_major);
      __syncwarp();
      if (row >= 0) {
        bf16* dst = out + row * C + h * D + dd * 16 + half * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = __float2bfloat16(S[r * 16 + half * 8 + e] / l);
      }
      __syncwarp();
    }
  }
}

template <int D>
static int launch_window_attention(const float* qkv, const int* pos,
                                   const float* cosT, const float* sinT,
                                   bf16* out, int nw, int n, int heads,
                                   const WinGeom& g, cudaStream_t stream) {
  const int npad = (n + 15) / 16 * 16;
  const int smem = 3 * npad * (D + 8) * 2 + 8 * 256 * 4 + 8 * 256 * 2;
  cudaError_t e = cudaFuncSetAttribute(
      window_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nw <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid(heads, nw);
  window_attention_kernel<D><<<grid, 256, smem, stream>>>(
      qkv, pos, cosT, sinT, out, n, npad, heads, g);
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

// ---------------------------------------------------------------------------
// compressed-block gather / merge and scatter / update
// ---------------------------------------------------------------------------

__global__ void gather_merge_kernel(const bf16* x, const int* slow_idx,
                                    const int* fast_idx,
                                    const float* fast_score, bf16* xs, int H,
                                    int W, int C, int ws, int nwh, int nww,
                                    int k, int nf, int has_rep) {
  const int w = blockIdx.x;
  const int kr = k + has_rep;
  const int c2n = C / 2;
  for (int idx = threadIdx.x; idx < k * c2n; idx += blockDim.x) {
    const int i = idx / c2n;
    const int c = (idx - i * c2n) * 2;
    const long long src =
        token_row(w, slow_idx[(long long)w * k + i], H, W, ws, nwh, nww);
    bf162 v = __floats2bfloat162_rn(0.f, 0.f);
    if (src >= 0) v = *reinterpret_cast<const bf162*>(x + src * C + c);
    *reinterpret_cast<bf162*>(xs + ((long long)w * kr + i) * C + c) = v;
  }
  if (!has_rep) return;
  // every thread forms the same denominator in the same order
  float denom = 0.f;
  for (int j = 0; j < nf; ++j) denom += fast_score[(long long)w * nf + j];
  denom = bfr(denom);
  for (int c = threadIdx.x * 2; c < C; c += blockDim.x * 2) {
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < nf; ++j) {
      const long long src =
          token_row(w, fast_idx[(long long)w * nf + j], H, W, ws, nwh, nww);
      if (src < 0) continue;
      const float wg = bfr(fast_score[(long long)w * nf + j] / denom);
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const bf162*>(x + src * C + c));
      a0 += wg * v.x;
      a1 += wg * v.y;
    }
    *reinterpret_cast<bf162*>(xs + ((long long)w * kr + k) * C + c) =
        __floats2bfloat162_rn(a0, a1);
  }
}

__global__ void scatter_update_kernel(const bf16* x, const bf16* s1,
                                      const bf16* raw1, const bf16* raw2,
                                      const int* slow_idx, const int* fast_idx,
                                      bf16* out, int H, int W, int C, int ws,
                                      int nwh, int nww, int k, int nf,
                                      int has_rep) {
  const int w = blockIdx.x;
  const int kr = k + has_rep;
  const int c2n = C / 2;
  for (int idx = threadIdx.x; idx < k * c2n; idx += blockDim.x) {
    const int i = idx / c2n;
    const int c = (idx - i * c2n) * 2;
    const long long dst =
        token_row(w, slow_idx[(long long)w * k + i], H, W, ws, nwh, nww);
    if (dst < 0) continue;
    const long long srow = ((long long)w * kr + i) * C + c;
    const float2 a = __bfloat1622float2(*reinterpret_cast<const bf162*>(s1 + srow));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const bf162*>(raw2 + srow));
    *reinterpret_cast<bf162*>(out + dst * C + c) =
        __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
  }
  for (int idx = threadIdx.x; idx < nf * c2n; idx += blockDim.x) {
    const int j = idx / c2n;
    const int c = (idx - j * c2n) * 2;
    const long long dst =
        token_row(w, fast_idx[(long long)w * nf + j], H, W, ws, nwh, nww);
    if (dst < 0) continue;
    float d0 = 0.f, d1 = 0.f;
    if (has_rep) {
      const long long rrow = ((long long)w * kr + k) * C + c;
      const float2 a = __bfloat1622float2(*reinterpret_cast<const bf162*>(raw1 + rrow));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const bf162*>(raw2 + rrow));
      d0 = bfr(a.x + b.x);
      d1 = bfr(a.y + b.y);
    }
    const float2 v = __bfloat1622float2(*reinterpret_cast<const bf162*>(x + dst * C + c));
    *reinterpret_cast<bf162*>(out + dst * C + c) =
        __floats2bfloat162_rn(v.x + d0, v.y + d1);
  }
}

TOC3D_EXPORT int toc3d_gather_merge(const void* x, const void* slow_idx,
                                    const void* fast_idx,
                                    const void* fast_score, void* xs, int nw,
                                    int H, int W, int C, int ws, int k, int nf,
                                    int has_rep, void* stream) {
  const int nwh = (H + ws - 1) / ws, nww = (W + ws - 1) / ws;
  if (nw > 0)
    gather_merge_kernel<<<nw, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const int*>(slow_idx),
        static_cast<const int*>(fast_idx),
        static_cast<const float*>(fast_score), static_cast<bf16*>(xs), H, W, C,
        ws, nwh, nww, k, nf, has_rep);
  return static_cast<int>(cudaGetLastError());
}

TOC3D_EXPORT int toc3d_scatter_update(const void* x, const void* s1,
                                      const void* raw1, const void* raw2,
                                      const void* slow_idx,
                                      const void* fast_idx, void* out, int nw,
                                      int H, int W, int C, int ws, int k,
                                      int nf, int has_rep, void* stream) {
  const int nwh = (H + ws - 1) / ws, nww = (W + ws - 1) / ws;
  if (nw > 0)
    scatter_update_kernel<<<nw, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(s1),
        static_cast<const bf16*>(raw1), static_cast<const bf16*>(raw2),
        static_cast<const int*>(slow_idx), static_cast<const int*>(fast_idx),
        static_cast<bf16*>(out), H, W, C, ws, nwh, nww, k, nf, has_rep);
  return static_cast<int>(cudaGetLastError());
}
