// Patch embedding: the 16x16 stride-16 3->C convolution as an explicit
// im2col copy and one GEMM on kernel G's TMA + wgmma body.
//
// Replaces: toc3d_tpu/ops/pallas/patch_embed.py :: patchify_matmul
//   (pallas_call at :87, body _patchify_kernel :35), which does the same
//   product as 16 accumulating (rows*w, 48) @ (48, C) matmuls per grid step.
//
// Bound on the H100 at the main-path shape (6 x 800 x 1600 x 3 bf16 image,
// C = 1024): 2 * 30000 * 768 * 1024 = 47.2 GFLOP (~48 us at 989 TFLOP/s)
// against ~108 MB of compulsory traffic (~32 us at 3.35 TB/s): operations
// bound.
//
// Design: a patch's K = ps*ps*3 = 768 entries are ps runs of ps*3 = 48
// contiguous bf16 in the channel-last image, and a run (96 bytes) is not a
// whole 128-byte swizzle row of kernel G's K tile, so the runs cannot be its
// TMA boxes. Two launches instead:
//   patch_im2col_kernel  copies the image into the (B*h*w, K) patch matrix
//                        in (row, col, channel) K order, 16-byte loads and
//                        stores; each thread moves one 16-byte chunk of
//                        IM2COL_ROWS image rows, reading whole image rows
//                        contiguously (46 MB in and out at the main path,
//                        >= 0.028 ms at 3.35 TB/s);
//   gemm_sm90_kernel     kernel G (gemm_sm90.cuh) at M = B*h*w, N = C,
//                        K = 768, with the bias epilogue and bf16 out,
//                        written straight into (B, h, w, C).
// The weight is the conv kernel reordered to (C, ps, ps, 3) = (C, K) so that
// its K order matches (ops/cuda/patch_embed.pack_patch_weight).
#include "gemm_sm90.cuh"

constexpr int IM2COL_THREADS = 256;
constexpr int IM2COL_ROWS = 4;   // image rows a thread copies a chunk of

// image (nimg, H, W, 3) -> cols (nimg * H/ps * W/ps, ps * ps * 3); block
// (x, y) moves chunks x * IM2COL_THREADS + tid of image rows y *
// IM2COL_ROWS ... + IM2COL_ROWS - 1 (rows counted over all images)
__global__ void __launch_bounds__(IM2COL_THREADS)
    patch_im2col_kernel(const bf16* __restrict__ x, bf16* __restrict__ cols,
                        int nimg, int H, int W, int ps) {
  const int row_chunks = W * 3 / 8;   // 16-byte chunks of an image row
  const int q = blockIdx.x * IM2COL_THREADS + threadIdx.x;
  if (q >= row_chunks) return;
  const int run = ps * 3 / 8;         // chunks of one patch row
  const int j = q / run, wq = q - j * run;
  const int gh = H / ps, gw = W / ps;
  const long long K = (long long)ps * ps * 3;
  uint4 v[IM2COL_ROWS];
  long long dst[IM2COL_ROWS];
  const int y0 = blockIdx.y * IM2COL_ROWS;
#pragma unroll
  for (int p = 0; p < IM2COL_ROWS; ++p) {
    const int y = y0 + p;             // image row over all images
    dst[p] = -1;
    if (y >= nimg * H) continue;
    const int b = y / H, yy = y - b * H;
    const int i = yy / ps, r = yy - i * ps;
    v[p] = *reinterpret_cast<const uint4*>(x + ((long long)y * W * 3) +
                                           (long long)q * 8);
    dst[p] = ((long long)(b * gh + i) * gw + j) * K + (long long)r * ps * 3 +
             wq * 8;
  }
#pragma unroll
  for (int p = 0; p < IM2COL_ROWS; ++p)
    if (dst[p] >= 0) *reinterpret_cast<uint4*>(cols + dst[p]) = v[p];
}

static int im2col(const void* x, void* cols, int nimg, int H, int W, int ps,
                  cudaStream_t stream) {
  const int row_chunks = W * 3 / 8;
  const dim3 grid((row_chunks + IM2COL_THREADS - 1) / IM2COL_THREADS,
                  (nimg * H + IM2COL_ROWS - 1) / IM2COL_ROWS);
  if (grid.x > 0 && grid.y > 0)
    patch_im2col_kernel<<<grid, IM2COL_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(cols), nimg, H, W,
        ps);
  return static_cast<int>(cudaGetLastError());
}

// the im2col launch alone (to time it apart from the product)
TOC3D_EXPORT int toc3d_patch_im2col(const void* x, void* cols, int nimg,
                                    int H, int W, int ps, void* stream) {
  return im2col(x, cols, nimg, H, W, ps, static_cast<cudaStream_t>(stream));
}

// kernel A: im2col into cols (nimg * H/ps * W/ps, ps*ps*3), then out =
// bf16(cols @ w^T + b), out (nimg, H/ps, W/ps, C)
TOC3D_EXPORT int toc3d_patchify(const void* x, const void* w, const void* b,
                                void* cols, void* out, int nimg, int H, int W,
                                int ps, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int e = im2col(x, cols, nimg, H, W, ps, s)) return e;
  gemm::Args a;
  a.A = cols;
  a.lda = (long long)ps * ps * 3;
  a.B = w;
  a.ldb = a.lda;
  a.bias = static_cast<const float*>(b);
  a.res = nullptr;
  a.ldr = 0;
  a.C = out;
  a.ldc = C;
  a.M = nimg * (H / ps) * (W / ps);
  a.N = C;
  a.K = ps * ps * 3;
  a.out_f32 = 0;
  a.gate = 0;
  return gemm90::launch_mode<gemm90::OUT_BF16, bf16>(a, s);
}
