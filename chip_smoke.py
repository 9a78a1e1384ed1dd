"""Smoke run of the PyTorch / CUDA port (toc3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0):
  1. device: needs torch.cuda; prints the nvidia-smi name / power limit line;
  2. build: compiles every kernel of the main path from toc3d_tpu_torch/csrc
     (one nvcc per source, in parallel) into build/kernels/;
  3. check: each kernel (A patch embed: im2col and kernel G's product, B
     full block, C compressed block at each block shape of the frame
     (block_shapes: B at ws 16 and 20, C at each ratio at both), D split-K
     flash attention, G the bf16 TMA + wgmma GEMM of B and C alone at its
     four GEMMs for B's 30001 rows and C's largest row count, 21504) on
     the card at the main-path shapes of ToC3D_faster_1600, in bf16,
     against its plain PyTorch version, and the attention deltas of B and C
     alone; G8, G's int8 form behind B8 and C8, at the same eight shapes
     with dynamic and static scales, bit for bit against the mma.sync s8
     tile at all four epilogues and against its plain version
     (check_gemms); the LayerNorm of B, C, B8 and C8 alone at each call
     site of each block shape (ln_sites: LN1, LN2, the SwiGLU sub-LN) in
     bf16, int8 dynamic and int8 static, and the window attention and row
     quantization alone;
  4. time: each kernel, its plain version and a PyTorch yardstick
     (library_ms) with CUDA events, beside the bound for the same work (C
     and its yardstick both route the tokens inside the timed call; G's
     yardstick is F.linear, the bare cuBLAS product, G8's torch._int_mm;
     G8 is timed beside the mma.sync s8 tile too; A's two launches are
     also timed apart; the LayerNorm's yardstick is F.layer_norm where one
     call computes the site, the window attention's SDPA on windowed
     q / k / v; per-frame bounds of the LayerNorm, window attention and
     row quantization families);
  5. main path: ToC3D_faster_1600 at full width (6 views, 1600x800, batch 1,
     uint8 frames built on the host in pinned memory, seeded random
     weights) streamed for 6 frames with prev_exists 0, 1, 1, 1, 1, 1
     through make_infer_fn, the frame as captured CUDA graphs; checks
     finite outputs and that every kernel launched its per-frame count (A
     1, B 6, C 18, D 12, G 96 = 4 per block, LN 72 = 3 per block, int8
     kernels and G8 0, replays included); the same frames streamed
     eagerly (infer_step) must give the same boxes, scores, labels,
     validity and bank bit for bit, frame by frame; prints both streams'
     steady ms/frame, peak memory and the host's synchronisations and
     copies in a steady frame (torch.profiler), and the weight-key check's
     host cost; then the `tiny` preset in bf16 against the plain path on
     the CPU as a small-input agreement check;
  6. int8: the int8 blocks B8 (ws 16, 20) and C8 (the six main-path
     shapes), dynamic and with static scales (check_block), and the head's
     int8 linear H8, checked and timed as in 3-4; the int8 main path
     (backbone and decoder quant 'int8') streamed for 6 frames with
     per-row (dynamic) activation scales, then calibrated on 2 frames and
     streamed again with static scales, each captured and eager as in 5
     and checking A 1, B8 6, C8 18, D 12, H8 60, G8 96, LN 72 and bf16
     B / C / G 0 per frame; the tiny int8 small-input agreement, dynamic
     and static;
  7. the other presets: their kernel shapes (phase_preset_shapes), each
     derived from the preset's config as the main path's are and not
     already held by it: A at 800x320 at both widths; every (width, map,
     window size, ratio) block shape of the nine full-width presets as B /
     C in bf16 and B8 / C8 dynamic and static (ViT-L at 20 x 50 and
     1600x800's ratio .7, ViT-B at width 768 with 12 heads and hidden
     2048); G / G8 at each width's GEMMs for each map's B rows and largest
     C rows; the LayerNorm at every call site of those blocks; D with
     6000 keys; checked and timed as in 3-4;
     their paths (phase_presets), each with the counts set to 0 just before
     it and read just after, captured against eager bit for bit:
     stream_petr_eva_vit_l_1600 (the plain backbone) for 6 frames in bf16
     (A 1, B 24, C 0, D 12, G 96, LN 72, no selector run) and int8
     dynamic (B8 24, G8 96, H8 60, B / C / G 0), ToC3D_fast and
     ToC3D_vit_b_faster at 800x320 for 3 frames (A 1, B 6 / 3, C 18 / 9,
     D 12, G 96 / 48, LN 72 / 36); eval_mask 'gumbel' on the tiny preset
     (phase_gumbel): captured equal to eager from one mask_seed, two
     replays on one state and frame different, the global generator
     untouched; the tiny small-input agreement with the plain backbone
     (the card and the CPU's own bf16 stream each against an f32 run: the
     card's distance at most 1.25 times the CPU's);
  8. report: a {"kernels": [...]} JSON line, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.
The kernels' plain versions compute in f32 (TF32 off for matmuls and
convolutions).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3

# kernel tolerance on the card, bf16 kernel vs its plain version on the same
# inputs: max |err| <= 2^-5 * max |plain| and mean |err| <= 2^-6 * mean
# |plain| (bf16 keeps 8 bits; accumulation order flips the last bit of
# intermediate bf16 activations, and a flip can pass through LN / softmax)
TOL_MAX_REL = 2.0 ** -5
TOL_MEAN_REL = 2.0 ** -6
# kernel G's f32 output against its plain version: the sums' order only
TOL_F32_REL = 1e-5


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_us(fn, calls: int = 500) -> float:
    """Wall microseconds per call of fn, a launch too small to keep the
    card busy: the host's share of a call (checks, tensor maps, launch)."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def bound_int8(ops8: float, flops: float, nbytes: float):
    """The bound of work split between int8 (ops8) and bf16 (flops)
    tensor-core products."""
    t_ops = (ops8 / PEAK_INT8_OPS + flops / PEAK_BF16_FLOPS) * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def compare(name, out, ref, scale=1.0):
    """Check out against ref with the kernel tolerance times scale."""
    err = (out.float() - ref.float()).abs()
    mx, mean = err.max().item(), err.mean().item()
    tmax = scale * TOL_MAX_REL * ref.float().abs().max().item()
    tmean = scale * TOL_MEAN_REL * ref.float().abs().mean().item()
    ok = math.isfinite(mx) and mx <= tmax and mean <= tmean
    log(f"check {name}: max_abs {mx:.6g} (tol {tmax:.6g}) "
        f"mean_abs {mean:.6g} (tol {tmean:.6g}) "
        f"{'ok' if ok else 'FAIL'}")
    return ok, mx


# ---------------------------------------------------------------------------
# PyTorch yardsticks (library_ms): the same function from cuBLAS bf16
# matmuls, cuDNN convolution and scaled_dot_product_attention. Timed here
# only; the port never calls them.
# ---------------------------------------------------------------------------

def _lib_rows_block(wts, rows, heads, cos, sin):
    """rows (W, n, C) bf16 -> (raw1, s1, raw2) with library calls; cos/sin
    (W or 1, n, d) f32 or None."""
    import torch
    import torch.nn.functional as F
    from toc3d_tpu_torch.ops.rope import rotate_half
    nw, n, c = rows.shape
    d = c // heads
    dt = rows.dtype
    hid = F.layer_norm(rows, (c,), wts.ln1w.to(dt), wts.ln1b.to(dt), 1e-6)
    qkv = F.linear(hid, wts.wqkv, wts.bqkv.to(dt)).reshape(nw, n, 3, heads, d)
    q, k, v = qkv.unbind(2)
    if cos is not None:
        cc, ss = cos[:, :, None], sin[:, :, None]
        q = (q.float() * cc + rotate_half(q.float()) * ss).to(dt)
        k = (k.float() * cc + rotate_half(k.float()) * ss).to(dt)
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), scale=1.0)
    raw1 = F.linear(o.transpose(1, 2).reshape(nw, n, c), wts.wo,
                    wts.bo.to(dt))
    s1 = rows + raw1
    h2 = F.layer_norm(s1, (c,), wts.ln2w.to(dt), wts.ln2b.to(dt), 1e-6)
    ab = F.linear(h2, wts.w12, wts.b12.to(dt))
    hh = wts.hidden
    g = F.silu(ab[..., 0:2 * hh:2]) * ab[..., 1:2 * hh:2]
    g = F.layer_norm(g, (hh,), wts.flw.to(dt), wts.flb.to(dt), 1e-6)
    raw2 = F.linear(g, wts.w3[:, :hh], wts.b3.to(dt))
    return raw1, s1, raw2


def _lib_qmm(a, w, s, b):
    """One int8 weight matmul from torch._int_mm: a (..., K) quantized per
    row with torch ops, w (N, K) int8, channel scales s, f32 bias b."""
    import torch
    k = a.shape[-1]
    a2 = a.reshape(-1, k).float()
    amax = a2.abs().amax(-1, keepdim=True).clamp_min(1e-6)
    q = torch.round(a2 * (127.0 / amax)).clamp(-127, 127).to(torch.int8)
    y = torch._int_mm(q, w.t()).float() * (amax / 127.0) * s + b
    return y.reshape(*a.shape[:-1], w.shape[0])


def _lib_rows_block_int8(wts, rows, heads, cos, sin):
    """_lib_rows_block with the seven weight matmuls as torch._int_mm."""
    import torch.nn.functional as F
    from toc3d_tpu_torch.ops.rope import rotate_half
    nw, n, c = rows.shape
    d = c // heads
    dt = rows.dtype
    hid = F.layer_norm(rows, (c,), wts.ln1w.to(dt), wts.ln1b.to(dt), 1e-6)
    qkv = _lib_qmm(hid, wts.wqkv, wts.sqkv, wts.bqkv).reshape(nw, n, 3,
                                                              heads, d)
    q, k, v = qkv.unbind(2)
    if cos is not None:
        cc, ss = cos[:, :, None], sin[:, :, None]
        q = q * cc + rotate_half(q) * ss
        k = k * cc + rotate_half(k) * ss
    q, k, v = (t.to(dt).transpose(1, 2) for t in (q, k, v))
    o = F.scaled_dot_product_attention(q, k, v, scale=1.0)
    raw1 = _lib_qmm(o.transpose(1, 2).reshape(nw, n, c), wts.wo, wts.so,
                    wts.bo).to(dt)
    s1 = rows + raw1
    h2 = F.layer_norm(s1, (c,), wts.ln2w.to(dt), wts.ln2b.to(dt), 1e-6)
    ab = _lib_qmm(h2, wts.w12, wts.s12, wts.b12)
    hh, hp = wts.hidden, wts.w3.shape[1]
    g = (F.silu(ab[..., 0:2 * hh:2]) * ab[..., 1:2 * hh:2]).to(dt)
    g = F.layer_norm(g, (hh,), wts.flw.to(dt), wts.flb.to(dt), 1e-6)
    raw2 = _lib_qmm(F.pad(g, (0, hp - hh)), wts.w3, wts.s3, wts.b3).to(dt)
    return raw1, s1, raw2


def lib_full_block(wts, x, heads, ws, rope, rows_fn=_lib_rows_block):
    from toc3d_tpu_torch.ops.window import window_partition, window_unpartition
    b, h, w, c = x.shape
    xw, padded = window_partition(x, ws)
    nw, n = xw.shape[0], ws * ws
    cos, sin = (None, None) if rope is None else (rope[0][:n][None],
                                                  rope[1][:n][None])
    raw1, s1, raw2 = rows_fn(wts, xw.reshape(nw, n, c), heads, cos, sin)
    y = (s1 + raw2).reshape(nw, ws, ws, c)
    return window_unpartition(y, ws, padded, (h, w))


def lib_compressed_block(wts, x, plan, heads, ws, rope,
                         rows_fn=_lib_rows_block):
    import torch
    from toc3d_tpu_torch.ops.window import window_partition, window_unpartition
    b, h, w, c = x.shape
    xw, padded = window_partition(x, ws)
    nw, n = xw.shape[0], ws * ws
    xw = xw.reshape(nw, n, c)
    gat = lambda idx: torch.gather(xw, 1, idx[..., None].expand(-1, -1, c))
    slow, fast = gat(plan.slow_idx), gat(plan.fast_idx)
    fs = plan.fast_score.to(x.dtype)
    wgt = fs / fs.sum(dim=1, keepdim=True)
    rep = torch.bmm(wgt[:, None, :], fast)
    rows = torch.cat([slow, rep], 1)
    pos = torch.cat([plan.slow_idx,
                     torch.full_like(plan.slow_idx[:, :1], plan.k)], 1)
    raw1, s1, raw2 = rows_fn(wts, rows, heads, rope[0][pos], rope[1][pos])
    y = s1 + raw2
    k = plan.k
    fast = fast + (raw1[:, k:k + 1] + raw2[:, k:k + 1])
    out = torch.zeros_like(xw)
    out.scatter_(1, plan.slow_idx[..., None].expand(-1, -1, c), y[:, :k])
    out.scatter_(1, plan.fast_idx[..., None].expand(-1, -1, c), fast)
    return window_unpartition(out.reshape(nw, ws, ws, c), ws, padded, (h, w))


# ---------------------------------------------------------------------------
# work counts for the bounds
# ---------------------------------------------------------------------------

def block_weight_bytes(c, hid):
    return (3 * c * c + c * c + 2 * hid * c + hid * c) * 2 + (8 * c + 3 * hid) * 4


def full_block_work(b, h, w, c, hid, ws, d=64):
    """(flops, bytes) of one B call; d: the head dim (the RoPE tables' width
    is d)."""
    nwh, nww = -(-h // ws), -(-w // ws)
    nw, n, m = b * nwh * nww, ws * ws, b * h * w
    flops = 2 * m * c * (4 * c + 3 * hid) + 4 * nw * n * n * c
    nbytes = 2 * m * c * 2 + block_weight_bytes(c, hid) + 2 * n * d * 4
    return flops, nbytes


def compressed_block_work(b, h, w, c, hid, ws, k, has_rep, d=64):
    nwh, nww = -(-h // ws), -(-w // ws)
    nw, n, m = b * nwh * nww, ws * ws, b * h * w
    kr = k + int(has_rep)
    rows = nw * kr
    flops = (2 * rows * c * (4 * c + 3 * hid) + 4 * nw * kr * kr * c
             + 2 * nw * (n - k) * c * int(has_rep))
    nbytes = (2 * m * c * 2 + m * 2 + block_weight_bytes(c, hid)
              + 2 * n * d * 4)
    return flops, nbytes


def block_weight_bytes_int8(c, hid):
    """int8 matrices, f32 channel scales, f32 biases and LN vectors."""
    return (4 * c * c + 3 * hid * c) + (4 * c + 3 * hid) * 4 \
        + (8 * c + 3 * hid) * 4


def full_block_work_int8(b, h, w, c, hid, ws, d=64):
    """(int8 ops, bf16 flops, bytes) of one B8 call."""
    nwh, nww = -(-h // ws), -(-w // ws)
    nw, n, m = b * nwh * nww, ws * ws, b * h * w
    nbytes = (2 * m * c * 2 + block_weight_bytes_int8(c, hid)
              + 2 * n * d * 4)
    return 2 * m * c * (4 * c + 3 * hid), 4 * nw * n * n * c, nbytes


def compressed_block_work_int8(b, h, w, c, hid, ws, k, has_rep, d=64):
    """(int8 ops, bf16 flops, bytes) of one C8 call."""
    nwh, nww = -(-h // ws), -(-w // ws)
    nw, n, m = b * nwh * nww, ws * ws, b * h * w
    kr = k + int(has_rep)
    rows = nw * kr
    flops = 4 * nw * kr * kr * c + 2 * nw * (n - k) * c * int(has_rep)
    nbytes = (2 * m * c * 2 + m * 2 + block_weight_bytes_int8(c, hid)
              + 2 * n * d * 4)
    return 2 * rows * c * (4 * c + 3 * hid), flops, nbytes


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from toc3d_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    times = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in times.items())})")
    for name in times:
        logf = build.BUILD_DIR / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    log(f"  ptxas {name}: {line.strip()}")
    # window attention at d = 64 for every window size of the main path
    # (B: 256, 400 rows; C: kr = k + 1 at ratios .5 / .4 / .3)
    occ = {n: build.occupancy("vit_block", "toc3d_window_attention_occupancy",
                              n, 64)
           for n in (256, 400, 128, 103, 77, 201, 161, 121)}
    log(f"resident blocks per SM: window attention (d 64) by rows {occ}; "
        f"flash partial (d 32) "
        f"{build.occupancy('cross_attn', 'toc3d_flash_occupancy', 32)}")


def keep_row(results, key, entry, name, source, replaces, **extra):
    """The first entry of a kernel is its row of the kernels line; the
    row's max_abs_err is the largest over every shape checked."""
    if key not in results:
        results[key] = dict(name=name, route="cuda", source=source,
                            replaces=replaces, **extra, **entry)
    results[key]["max_abs_err"] = max(results[key]["max_abs_err"],
                                      entry["max_abs_err"])


BLOCK_ROWS = {
    "B": ("fused_full_block", "toc3d_tpu/ops/pallas/vit_block.py:602"),
    "C": ("fused_compressed_block", "toc3d_tpu/ops/pallas/vit_block.py:819"),
    "B8": ("fused_full_block_int8", "toc3d_tpu/ops/pallas/vit_block.py:602"),
    "C8": ("fused_compressed_block_int8",
           "toc3d_tpu/ops/pallas/vit_block.py:819")}


def phase_kernels(model, results):
    """Check and time every kernel at its main-path shapes."""
    import torch
    from toc3d_tpu_torch.models.eva_vit import make_rope_tables, rope_tensors
    from toc3d_tpu_torch.ops.cuda import patch_embed, vit_block
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    cfg = model.cfg.backbone
    c = cfg.embed_dim
    bf = torch.bfloat16
    ok_all = True
    win, glb = make_rope_tables(cfg)
    rope = {cfg.window_size: rope_tensors(win, dev),
            cfg.global_window_size: rope_tensors(glb, dev)}

    # A: patch embed, normalized 6 x 800 x 1600 image
    x_img = torch.randn(6, 800, 1600, 3, device=dev, generator=g).to(bf)
    wmat, bias = patch_embed.pack_patch_weight(
        model.img_backbone.patch_embed.proj, bf)
    out = patch_embed.patchify_matmul(x_img, wmat, bias, 16)
    ref = patch_embed.patchify_plain(x_img, wmat, bias, 16)
    ok, err = compare("A patchify (6,800,1600,3)->(6,50,100,1024)", out, ref)
    ok_all &= ok
    conv = model.img_backbone.patch_embed.proj
    xin = x_img.permute(0, 3, 1, 2)
    wconv = conv.weight.to(bf)
    bconv = conv.bias.to(bf)
    m = 6 * 50 * 100
    b_ms, b_by = bound(2 * m * 768 * c,
                       x_img.numel() * 2 + wmat.numel() * 2 + m * c * 2)
    results["A"] = dict(
        name="patchify_matmul", route="cuda",
        source="toc3d_tpu_torch/csrc/patch_embed.cu",
        replaces="toc3d_tpu/ops/pallas/patch_embed.py:60",
        shape="x (6,800,1600,3) bf16 -> (6,50,100,1024)",
        max_abs_err=err,
        ms=cuda_time(lambda: patch_embed.patchify_matmul(x_img, wmat, bias,
                                                          16), 20),
        plain_ms=cuda_time(lambda: patch_embed.patchify_plain(
            x_img, wmat, bias, 16), 5),
        library_ms=cuda_time(lambda: torch.nn.functional.conv2d(
            xin, wconv, bconv, stride=16), 20),
        bound_ms=b_ms, bound_by=b_by)
    # its two launches apart: the im2col copy (its plain version is the
    # patch matrix exactly), and kernel G's product on that matrix (the
    # same kernel body, from the block kernels' library)
    cols = patch_embed.patch_im2col(x_img, 16)
    same = torch.equal(cols, patch_embed.patch_im2col_plain(x_img, 16))
    ok_all &= same
    out2 = out.view(m, c)
    results["A"].update(
        im2col_ms=cuda_time(lambda: patch_embed.patch_im2col(x_img, 16), 20),
        im2col_bound_ms=2 * cols.numel() * 2 / PEAK_BYTES * 1e3,
        gemm_ms=cuda_time(lambda: vit_block.gemm_bf16(cols, wmat, bias,
                                                      out=out2), 20),
        im2col_equal_to_plain=same)
    log(f"time A: {json.dumps(results['A'])}")
    del x_img, xin, out, ref, cols, out2

    # B at ws 16 and ws 20, C at every ratio segment at both window sizes
    x = (torch.randn(6, 50, 100, c, device=dev, generator=g) * 0.5).to(bf)
    scores = torch.randn(6, 5000, device=dev, generator=g).to(bf)
    for i, ws, ratio in block_shapes(cfg):
        key = "B" if ratio is None else "C"
        tag = f"{key} ws{ws}" + ("" if ratio is None else f" r{ratio}")
        ok, entry = check_block(tag, model.img_backbone.blocks[i], x, cfg,
                                ws, rope[ws], scores, ratio, reps=10)
        ok_all &= ok
        keep_row(results, key, entry, BLOCK_ROWS[key][0],
                 "toc3d_tpu_torch/csrc/vit_block.cu", BLOCK_ROWS[key][1])
    del x, scores

    # D: decoder cross-attention (K = 30000) and self-attention (K = 1668)
    for kv in (30000, 1668):
        ok, entry = check_flash(kv, g)
        ok_all &= ok
        keep_row(results, "D", entry, "flash_attention_core",
                 "toc3d_tpu_torch/csrc/cross_attn.cu",
                 "toc3d_tpu/ops/pallas/cross_attn.py:118")
    ok_g = phase_gemm(results, g)
    ok_r = phase_rows(model, results)
    return ok_g and ok_r and ok_all


def check_flash(kv, g, reps=20):
    """Kernel D on q (1,900,256) against k/v (1,kv,256), 8 heads, against
    its plain version, timed beside SDPA and the bound. Returns
    (ok, entry)."""
    import torch
    from toc3d_tpu_torch.ops.cuda import cross_attn
    dev = torch.device("cuda")
    bf = torch.bfloat16
    hd = 8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q = (torch.randn(1, 900, 256, device=dev, generator=g)
         * (3 * 32 ** -0.5)).to(bf)
    k = torch.randn(1, kv, 256, device=dev, generator=g).to(bf)
    v = torch.randn(1, kv, 256, device=dev, generator=g).to(bf)
    splits, per = cross_attn.flash_splits(900, kv, hd, 1, sms)
    blocks = -(-900 // cross_attn.QUERY_TILE) * hd * splits
    ok, err = compare(f"D flash q (1,900,256) k/v (1,{kv},256), {splits} "
                      f"splits of {per} key tiles, {blocks} blocks on {sms} "
                      f"SMs", cross_attn.flash_attention_core(q, k, v, hd),
                      cross_attn.flash_attention_plain(q, k, v, hd))
    sh = lambda t: t.reshape(1, -1, hd, 32).transpose(1, 2)
    b_ms, b_by = bound(4 * 900 * kv * 256, (900 * 2 + kv * 2) * 256 * 2)
    entry = dict(
        shape=f"q (1,900,256) k/v (1,{kv},256) bf16, 8 heads",
        max_abs_err=err,
        ms=cuda_time(lambda: cross_attn.flash_attention_core(q, k, v, hd),
                     reps),
        plain_ms=cuda_time(lambda: cross_attn.flash_attention_plain(
            q, k, v, hd), 3),
        library_ms=cuda_time(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                sh(q), sh(k), sh(v), scale=1.0), reps),
        bound_ms=b_ms, bound_by=b_by)
    log(f"time D kv{kv}: {json.dumps(entry)}")
    return ok, entry


def check_patch_embed(h, w, c, g):
    """Kernel A on a (6, h, w, 3) image to width c with a fresh stride-16
    convolution, against its plain version, timed beside F.conv2d and the
    bound. Returns ok."""
    import torch
    from toc3d_tpu_torch.ops.cuda import patch_embed
    dev = torch.device("cuda")
    bf = torch.bfloat16
    x_img = torch.randn(6, h, w, 3, device=dev, generator=g).to(bf)
    conv = torch.nn.Conv2d(3, c, 16, stride=16).to(dev)
    wmat, bias = patch_embed.pack_patch_weight(conv, bf)
    shape = f"(6,{h},{w},3)->(6,{h // 16},{w // 16},{c})"
    ok, err = compare(f"A patchify {shape}",
                      patch_embed.patchify_matmul(x_img, wmat, bias, 16),
                      patch_embed.patchify_plain(x_img, wmat, bias, 16))
    m = 6 * (h // 16) * (w // 16)
    b_ms, b_by = bound(2 * m * 768 * c, x_img.numel() * 2
                       + wmat.numel() * 2 + m * c * 2)
    xin, wc, bc = x_img.permute(0, 3, 1, 2), conv.weight.to(bf), \
        conv.bias.to(bf)
    log(f"time A {shape}: " + json.dumps(dict(
        shape=f"x {shape} bf16", max_abs_err=err,
        ms=cuda_time(lambda: patch_embed.patchify_matmul(
            x_img, wmat, bias, 16), 20),
        plain_ms=cuda_time(lambda: patch_embed.patchify_plain(
            x_img, wmat, bias, 16), 3),
        library_ms=cuda_time(lambda: torch.nn.functional.conv2d(
            xin, wc, bc, stride=16), 20),
        bound_ms=b_ms, bound_by=b_by)))
    return ok


def gemm_shapes(c, hid):
    """Kernel G's four GEMMs of a block of width c and SwiGLU hidden width
    hid (padded to a multiple of 16): {name: (N, K, epilogue)}."""
    hp = -(-hid // 16) * 16
    return {"qkv": (3 * c, c, "f32"), "o": (c, c, "res"),
            "gate": (2 * hp, c, "gate"), "w3": (c, hp, "res")}


def check_gemms(tag, m, shapes, g, reps=20, on_entry=None):
    """Kernels G and G8 alone at ``shapes`` ({name: (N, K, epilogue)}) for
    m rows. G against gemm_bf16_plain (f32 out within TOL_F32_REL, bf16
    within the kernel bounds). G8 on int8 operands over their whole range,
    with per-row (dynamic) and one static activation scale: each of the
    four epilogues bit for bit the mma.sync s8 tile's (gemm_s8), and the
    shape's own epilogue its plain version (f32 exactly, bf16 within the
    kernel bounds). Each timed beside its bound, its plain version and
    F.linear / torch._int_mm on the same operands (the bare product; G8
    beside the mma.sync tile too). on_entry(kernel, name, mode, entry) sees
    each timing entry. Returns (ok, largest G error, largest G8 error)."""
    import torch
    import torch.nn.functional as F
    from toc3d_tpu_torch.ops.cuda import int8, vit_block
    dev = torch.device("cuda")
    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ok_all, g_err, g8_err = True, 0.0, 0.0
    epilogues = {"f32": dict(out_f32=True), "res": {}, "gate": dict(gate=True),
                 "bf16": {}}
    for name, (n, k, epi) in shapes.items():
        # the persistent grid: min(tiles, SMs) blocks of 128 x 256 tiles
        tiles = -(-m // 128) * -(-n // 256)
        grid = min(tiles, sms)
        out_bytes = m * (n // 2 * 2 if epi == "gate" else
                         n * (4 if epi == "f32" else 2))
        a = torch.randn(m, k, device=dev, generator=g).to(bf)
        w = (torch.randn(n, k, device=dev, generator=g) * k ** -0.5).to(bf)
        res = torch.randn(m, n, device=dev, generator=g).to(bf)
        bias = torch.randn(n, device=dev, generator=g) * 0.1
        kw = dict(bias=bias, res=res if epi == "res" else None,
                  out_f32=epi == "f32", gate=epi == "gate")
        out = vit_block.gemm_bf16(a, w, **kw)
        ref = vit_block.gemm_bf16_plain(a, w, **kw)
        gtag = (f"G {tag} {name} ({m},{k}) x ({n},{k}) {epi}, {grid} blocks "
                f"x {-(-tiles // grid)} tiles")
        if epi == "f32":
            err = (out - ref).abs().max().item()
            tol = TOL_F32_REL * ref.abs().max().item()
            ok = math.isfinite(err) and err <= tol
            log(f"check {gtag}: max_abs {err:.6g} (tol {tol:.6g}) "
                f"{'ok' if ok else 'FAIL'}")
        else:
            ok, err = compare(gtag, out, ref)
        ok_all &= ok
        g_err = max(g_err, err)
        b_ms, b_by = bound(2 * m * n * k, (m + n) * k * 2 + n * 4 + out_bytes
                           + (m * n * 2 if epi == "res" else 0))
        entry = dict(
            shape=f"{name}: a ({m},{k}) bf16, w ({n},{k}), {epi}",
            max_abs_err=err,
            ms=cuda_time(lambda: vit_block.gemm_bf16(a, w, out=out, **kw),
                         reps),
            plain_ms=cuda_time(lambda: vit_block.gemm_bf16_plain(a, w, **kw),
                               1, warmup=1),
            library_ms=cuda_time(lambda: F.linear(a, w), reps),
            bound_ms=b_ms, bound_by=b_by)
        log(f"time G {tag} {name} m{m}: {json.dumps(entry)}")
        if on_entry is not None:
            on_entry("G", name, None, entry)
        del a, w, out, ref
        aq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                           dtype=torch.int8)
        ws = torch.rand(n, device=dev, generator=g) * 1e-4 + 1e-5
        for mode in ("dynamic", "static"):
            xs = (torch.rand(m if mode == "dynamic" else 1, device=dev,
                             generator=g) * 0.01 + 1e-3)
            same = []
            for e, ekw in epilogues.items():
                ekw = dict(ekw, res=res if e == "res" else None)
                out = int8.gemm_s8_sm90(aq, xs, wq, ws, bias, **ekw)
                same.append(torch.equal(
                    out, int8.gemm_s8(aq, xs, wq, ws, bias, **ekw)))
                del out
            kw8 = dict(epilogues[epi], res=res if epi == "res" else None)
            out = int8.gemm_s8_sm90(aq, xs, wq, ws, bias, **kw8)
            ref = int8.gemm_s8_plain(aq, xs, wq, ws, bias, **kw8)
            gtag = (f"G8 {tag} {name} ({m},{k}) x ({n},{k}) {epi} {mode}, "
                    f"bit-equal to mma.sync at f32/res/gate/bf16 {same}")
            if epi == "f32":
                err = (out - ref).abs().max().item()
                ok = torch.equal(out, ref)
                log(f"check {gtag}: max_abs {err:.6g} (equal to plain: "
                    f"{ok}) {'ok' if ok and all(same) else 'FAIL'}")
            else:
                ok, err = compare(gtag, out, ref)
            ok_all &= ok and all(same)
            g8_err = max(g8_err, err)
            b_ms, b_by = bound_int8(
                2 * m * n * k, 0,
                (m + n) * k + n * 8 + xs.numel() * 4 + out_bytes
                + (m * n * 2 if epi == "res" else 0))
            entry = dict(
                shape=f"{name}: a ({m},{k}) int8, w ({n},{k}), {epi}, "
                      f"{mode}",
                max_abs_err=err,
                ms=cuda_time(lambda: int8.gemm_s8_sm90(
                    aq, xs, wq, ws, bias, out=out, **kw8), reps),
                mma_sync_ms=cuda_time(lambda: int8.gemm_s8(
                    aq, xs, wq, ws, bias, out=out, **kw8), reps),
                plain_ms=cuda_time(lambda: int8.gemm_s8_plain(
                    aq, xs, wq, ws, bias, **kw8), 1, warmup=1),
                library_ms=cuda_time(lambda: torch._int_mm(aq, wq.t()),
                                     reps),
                bound_ms=b_ms, bound_by=b_by, tiles=tiles)
            log(f"time G8 {tag} {name} m{m} {mode}: {json.dumps(entry)}")
            if on_entry is not None:
                on_entry("G8", name, mode, entry)
            del out, ref
        del aq, wq, res
    return ok_all, g_err, g8_err


def phase_gemm(results, g):
    """Kernels G and G8 alone (check_gemms) at the four GEMMs of a block
    for B's 30001 rows and C's largest row count (21504, ws 16 ratio .5);
    then the main loop's rate, G8's beside G's, and each one's host cost
    per call."""
    import torch
    from toc3d_tpu_torch.ops.cuda import int8, vit_block
    dev = torch.device("cuda")
    bf = torch.bfloat16
    ok_all, g_err, g8_err = True, 0.0, 0.0
    for m in (30001, 21504):
        def on_entry(kernel, name, mode, entry, m=m):
            if name != "gate" or m != 30001 or mode == "static":
                return
            if kernel == "G":
                results["G"] = dict(
                    name="gemm_bf16", route="cuda",
                    source="toc3d_tpu_torch/csrc/gemm_sm90.cuh",
                    replaces="toc3d_tpu/ops/pallas/vit_block.py:163",
                    stands_in_for="toc3d_tpu/ops/pallas/vit_block.py:113-116"
                                  ", 150, 163-164, 176 (the bf16 jnp.dot "
                                  "products of _attention and _swiglu in "
                                  "_full_block_kernel and "
                                  "_compressed_block_kernel)", **entry)
            else:
                results["G8"] = dict(
                    name="gemm_s8_sm90", route="cuda",
                    source="toc3d_tpu_torch/csrc/gemm_sm90.cuh",
                    replaces="toc3d_tpu/ops/pallas/vit_block.py:277",
                    stands_in_for="toc3d_tpu/ops/pallas/vit_block.py:"
                                  "277-284 (_qmm, fed by _actquant :271, "
                                  "in the int8 bodies of the "
                                  "pallas_calls :639 and :906)", **entry)
        ok, eg, e8 = check_gemms("ViT-L", m, gemm_shapes(1024, 2730), g,
                                 on_entry=on_entry)
        ok_all &= ok
        g_err, g8_err = max(g_err, eg), max(g8_err, e8)
    results["G"]["max_abs_err"] = g_err
    results["G8"]["max_abs_err"] = g8_err
    # the host's share of a call (checks, three tensor-map encodes, the
    # launch): wall time per call of a GEMM too small to keep the card busy
    a = torch.randn(128, 64, device=dev, generator=g).to(bf)
    w = torch.randn(256, 64, device=dev, generator=g).to(bf)
    bias = torch.zeros(256, device=dev)
    out = torch.empty(128, 256, device=dev, dtype=bf)
    us = host_us(lambda: vit_block.gemm_bf16(a, w, bias, out=out))
    log(f"G host cost: {us:.2f} us per call (a (128,64) x w (256,64), 500 "
        f"calls)")
    # the main loop's rate without the epilogue: the K slope of a bf16-out
    # GEMM of 30001 x 5472 from K 1024 to 3072, G8 beside G (a stage is the
    # same 48 KB in both: if the main loop waited on L2, not on the tensor
    # cores, G8's rate would be G's in operations per second, not twice it)
    rate = {}
    for key in ("G8", "G"):
        t = []
        for k in (1024, 3072):
            if key == "G8":
                aq = torch.randint(-127, 128, (30001, k), device=dev,
                                   generator=g, dtype=torch.int8)
                wq = torch.randint(-127, 128, (5472, k), device=dev,
                                   generator=g, dtype=torch.int8)
                xs = torch.rand(30001, device=dev, generator=g) * 0.01
                ws = torch.rand(5472, device=dev, generator=g) * 1e-4
                t.append(cuda_time(lambda: int8.gemm_s8_sm90(aq, xs, wq, ws),
                                   20))
            else:
                a = torch.randn(30001, k, device=dev, generator=g).to(bf)
                w = (torch.randn(5472, k, device=dev, generator=g)
                     * 0.03).to(bf)
                t.append(cuda_time(lambda: vit_block.gemm_bf16(a, w), 20))
        rate[key] = 2 * 30001 * 5472 * 2048 / ((t[1] - t[0]) * 1e-3)
        peak = PEAK_INT8_OPS if key == "G8" else PEAK_BF16_FLOPS
        log(f"{key} main loop (K slope, 30001 x 5472, bf16 out): "
            f"{t[0]:.5f} ms at K 1024, {t[1]:.5f} at K 3072: "
            f"{rate[key] / 1e12:.1f} T op/s, {rate[key] / peak:.1%} of its "
            f"peak")
    # the host's share of a call, as for G
    aq = torch.zeros(128, 128, device=dev, dtype=torch.int8)
    wq = torch.zeros(256, 128, device=dev, dtype=torch.int8)
    xs, ws = torch.ones(128, device=dev), torch.ones(256, device=dev)
    us = host_us(lambda: int8.gemm_s8_sm90(aq, xs, wq, ws, bias, out=out))
    log(f"G8 host cost: {us:.2f} us per call (a (128,128) x w (256,128) "
        f"int8, 500 calls)")
    return ok_all


def frame_blocks(cfg):
    """(window size, token ratio or None for a full block) of each block of
    the backbone (a plain EVA-02 backbone: every block full), in order."""
    out, ratio = [], None
    ploc = getattr(cfg, "pruning_loc", ())
    for i in range(cfg.depth):
        if i in ploc:
            ratio = cfg.token_ratio[ploc.index(i)]
        ws = cfg.global_window_size if i in cfg.global_attn_indexes \
            else cfg.window_size
        out.append((ws, ratio))
    return out


def block_shapes(cfg):
    """(first block, window size, ratio or None) of each distinct block
    shape of the backbone, in the order the frame first runs them."""
    first = {}
    for i, shape in enumerate(frame_blocks(cfg)):
        first.setdefault(shape, i)
    return [(i,) + shape for shape, i in first.items()]


def block_rows(cfg, ws, ratio, b=6, h=50, w=100):
    """(windows, rows a window, rows of the block's matmuls) on a (b, h, w)
    patch map (the main path's by default): B's tokens, or C's k kept rows
    plus the representative row a window."""
    from toc3d_tpu_torch.models.token_select import keep_count
    nw = b * -(-h // ws) * -(-w // ws)
    if ratio is None:
        return nw, ws * ws, b * h * w
    kr = keep_count(ws * ws, ratio, n_rep=1, mxu_align=cfg.mxu_align_k) + 1
    return nw, kr, nw * kr


def ln_sites(cfg, b=6, h=50, w=100):
    """The LayerNorm call sites of every block shape of the backbone on a
    (b, h, w) patch map: {name: (x rows, output rows, n, npad, residual)}.
    B: LN1 with its LN(0) row, LN2, the SwiGLU sub-LN on the gate output's
    npad columns (hid of them the hidden width, in place in bf16); C at
    each (ws, ratio) on its k + 1 rows a window: LN1, LN2 that adds the
    attention delta and stores the sum, the sub-LN."""
    c = cfg.embed_dim
    hid = int(c * cfg.mlp_ratio)
    hp = -(-hid // 16) * 16
    sites = {}
    for ws, r in frame_blocks(cfg):
        rows = block_rows(cfg, ws, r, b, h, w)[2]
        kind = "B" if r is None else f"C ws{ws} r{r}"
        sites[f"LN1 {kind}"] = (rows, rows + (r is None), c, c, False)
        sites[f"LN2 {kind}"] = (rows, rows, c, c, r is not None)
        sites[f"sub-LN {kind}"] = (rows, rows, hid, hp, False)
    return sites


def ln_bytes(xr, rows, n, npad, res, mode):
    """The bytes a LayerNorm call must move: x's xr rows (and the residual's,
    and the stored sum) over n columns, the weight and bias, and the
    (rows, npad) output: bf16, or int8 with the rows' f32 scales (dynamic)
    or not (static)."""
    nbytes = xr * n * 2 * (3 if res else 1) + n * 8
    per_row = {"bf16": npad * 2, "dynamic": npad + 4, "static": npad}[mode]
    return nbytes + rows * per_row


def check_ln_sites(sites, g, results=None):
    """The LayerNorm of B, C, B8 and C8 alone at each site of ``sites``
    ({name: (x rows, output rows, n, npad, residual)}) in bf16 against its
    plain version (the kernel bounds) and quantizing, dynamic and static,
    within one int8 step (mean <= 1e-2, scales within 2^-7); each timed
    beside its bound, its plain version and, for a site that one call
    computes, F.layer_norm. With ``results``, the bf16 sub-LN of B is the
    LN row of the kernels line. Returns (ok, largest bf16 error)."""
    import torch
    import torch.nn.functional as F
    from toc3d_tpu_torch.ops.cuda import vit_block
    dev = torch.device("cuda")
    bf = torch.bfloat16
    ok_all = True
    ln_err = 0.0
    for site, (xr, rows, n, npad, res) in sites.items():
        x = (torch.randn(xr, npad, device=dev, generator=g) * 0.7
             + 0.1).to(bf)
        x[:, n:] = 0
        r = (torch.randn(xr, npad, device=dev, generator=g) * 0.3).to(bf) \
            if res else None
        wgt = 1 + 0.1 * torch.randn(n, device=dev, generator=g)
        bias = 0.1 * torch.randn(n, device=dev, generator=g)
        in_place = site.startswith("sub-LN")
        ref = vit_block.layernorm_plain(x, wgt, bias, r, rows, n)
        scale = (ref.float().abs().max() / 127.0).reshape(1)
        for mode in ("bf16", "dynamic", "static"):
            tag = f"LN {site} ({xr} -> {rows} rows, {n} of {npad}) {mode}"
            if mode == "bf16":
                xt = x.clone()
                s = torch.empty_like(x) if res else None
                out = vit_block.layernorm(xt, wgt, bias, r, rows, n, s,
                                          xt if in_place else None)
                ok, err = compare(tag + (" in place" if in_place else ""),
                                  out, ref)
                if res:
                    same = torch.equal(s, (x.float() + r.float()).to(bf))
                    log(f"check {tag}: stored sum equal to the bf16 sum "
                        f"{same}")
                    ok &= same
                ln_err = max(ln_err, err)
                run = lambda: vit_block.layernorm(
                    xt, wgt, bias, r, rows, n, s, xt if in_place else None)
                plain = lambda: vit_block.layernorm_plain(x, wgt, bias, r,
                                                          rows, n)
                lib = None
                if not res:
                    xl = x[:, :n].contiguous()
                    wl, bl = wgt.to(bf), bias.to(bf)
                    lib = lambda: F.layer_norm(xl, (n,), wl, bl, 1e-6)
            else:
                sc = None if mode == "dynamic" else scale
                q, qs = vit_block.layernorm_int8(x, wgt, bias, sc, r, rows, n)
                qr, qsr = vit_block.layernorm_int8_plain(x, wgt, bias, sc, r,
                                                         rows, n)
                d = (q.int() - qr.int()).abs()
                err = d.max().item()
                srel = ((qs - qsr.reshape(qs.shape)).abs()
                        / qsr.reshape(qs.shape).abs()).max().item()
                ok = err <= 1 and d.float().mean().item() <= 1e-2 \
                    and srel <= 2 ** -7
                log(f"check {tag}: max step {err} mean step "
                    f"{d.float().mean().item():.6g} (tol 1, 1e-2) scales "
                    f"rel {srel:.6g} (tol 2^-7) {'ok' if ok else 'FAIL'}")
                run = lambda: vit_block.layernorm_int8(x, wgt, bias, sc, r,
                                                       rows, n)
                plain = lambda: vit_block.layernorm_int8_plain(
                    x, wgt, bias, sc, r, rows, n)
                lib = None
            ok_all &= ok
            b_ms, b_by = bound(0, ln_bytes(xr, rows, n, npad, res, mode))
            entry = dict(shape=f"{site}: x ({xr},{npad}) bf16 -> {rows} "
                               f"rows, {n} columns, {mode}",
                         max_abs_err=err, ms=cuda_time(run, 50),
                         plain_ms=cuda_time(plain, 3),
                         library_ms=None if lib is None else cuda_time(lib,
                                                                       50),
                         bound_ms=b_ms, bound_by=b_by)
            log(f"time {tag}: {json.dumps(entry)}")
            if site == "sub-LN B" and mode == "bf16" and results is not None:
                results["LN"] = dict(
                    name="layernorm", route="cuda",
                    source="toc3d_tpu_torch/csrc/vit_block.cu",
                    replaces="toc3d_tpu/ops/pallas/vit_block.py:63", **entry)
    return ok_all, ln_err


def phase_rows(model, results):
    """The row kernels alone at the main path's shapes. The LayerNorm of B,
    C, B8 and C8 at each call site of every block shape (ln_sites: LN1 of
    B with its LN(0) row, LN1 of C, LN2 of B, LN2 of C that adds the
    attention delta and stores the sum, the SwiGLU sub-LN in place on the
    gate output's 2736 columns, 2730 of them the hidden width) in bf16
    against its plain version (the kernel bounds), and quantizing,
    dynamic and static, within one int8 step (mean <= 1e-2, scales within
    2^-7); each timed beside its bound, its plain version and, for a site
    that one call computes, F.layer_norm. Then the window attention of B
    and C and the row quantization of B8 / C8's proj_in site and of H8,
    timed beside their bounds (SDPA on windowed q / k / v for the
    attention), and the per-frame bounds of the three families."""
    import torch
    import torch.nn.functional as F
    from toc3d_tpu_torch.models.eva_vit import make_rope_tables, rope_tensors
    from toc3d_tpu_torch.ops.cuda import int8, vit_block
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    cfg = model.cfg.backbone
    c, heads = cfg.embed_dim, cfg.num_heads
    hid = int(c * cfg.mlp_ratio)
    hp = -(-hid // 16) * 16
    bf = torch.bfloat16
    ok_all = True
    _, _, rows_c = block_rows(cfg, cfg.window_size, cfg.token_ratio[0])
    ln_ok, ln_err = check_ln_sites(ln_sites(cfg), g, results)
    ok_all &= ln_ok
    results["LN"]["max_abs_err"] = ln_err

    # per-frame bounds: three LayerNorms a block, one window attention, and
    # in int8 one row quantization (proj_in) a block
    blocks = [block_rows(cfg, ws, r) + (ws, r) for ws, r in
              frame_blocks(cfg)]
    for mode in ("bf16", "dynamic", "static"):
        total = 0.0
        for nw, n, rows, ws, r in blocks:
            full = r is None
            total += (ln_bytes(rows, rows + full, c, c, False, mode)
                      + ln_bytes(rows, rows, c, c, not full, mode)
                      + ln_bytes(rows, rows, hid, hp, False, mode))
        log(f"LayerNorm family bound per frame, {mode}: "
            f"{total / PEAK_BYTES * 1e3:.5f} ms ({total / 1e9:.4f} GB, "
            f"{3 * len(blocks)} launches)")
    wa_ms = {"bytes": 0.0, "operations": 0.0}
    rq_ms = 0.0
    for nw, n, rows, ws, r in blocks:
        wa_ms["bytes"] += ((rows + (r is None)) * 3 * c * 4 + rows * c * 2
                           + ws * ws * (c // heads) * 8) / PEAK_BYTES * 1e3
        wa_ms["operations"] += 4 * nw * n * n * c / PEAK_BF16_FLOPS * 1e3
        rq_ms += rows * (c * 3 + 4) / PEAK_BYTES * 1e3
    log(f"window attention family bound per frame: bytes "
        f"{wa_ms['bytes']:.5f} ms, operations {wa_ms['operations']:.5f} ms "
        f"(24 launches); row quantization of the blocks' proj_in sites per "
        f"int8 frame: {rq_ms:.5f} ms (24 launches, dynamic)")

    # window attention alone: B at ws 16 / 20, C at ws 16 / 20 ratio .5
    win, glb = make_rope_tables(cfg)
    rope = {cfg.window_size: rope_tensors(win, dev),
            cfg.global_window_size: rope_tensors(glb, dev)}
    d = c // heads
    scores = torch.randn(6, 5000, device=dev, generator=g).to(bf)
    for ws, ratio in ((cfg.window_size, None), (cfg.global_window_size, None),
                      (cfg.window_size, cfg.token_ratio[0]),
                      (cfg.global_window_size, cfg.token_ratio[0])):
        nw, n, rows = block_rows(cfg, ws, ratio)
        image = ratio is None
        qkv = torch.randn(rows + image, 3 * c, device=dev, generator=g) * 0.3
        out = torch.empty(rows, c, dtype=bf, device=dev)
        cos, sin = (t[:ws * ws].float().contiguous() for t in rope[ws])
        pos = None
        if not image:
            plan = vit_block.compress_plan(scores, 6, 50, 100, ws, ratio,
                                           True, cfg.mxu_align_k)
            pos = torch.cat([plan.slow_idx, torch.full_like(
                plan.slow_idx[:, :1], plan.k)], 1).to(torch.int32)
            pos = pos.contiguous()
        run = lambda: vit_block.window_attention_launch(
            qkv, out, (6, 50, 100), ws, nw, n, heads, image, pos, cos, sin)
        qs, ks, vs = (torch.randn(nw, heads, n, d, device=dev,
                                  generator=g).to(bf) for _ in range(3))
        b_ms, b_by = bound(4 * nw * n * n * c,
                           (rows + image) * 3 * c * 4 + rows * c * 2
                           + ws * ws * d * 4 * 2)
        entry = dict(shape=f"{'B' if image else 'C'} ws {ws}"
                           f"{'' if image else f', ratio {ratio}'}: {nw} "
                           f"windows x {n} rows, qkv ({rows + image},"
                           f"{3 * c}) f32 -> ({rows},{c}) bf16",
                     ms=cuda_time(run, 20),
                     library_ms=cuda_time(
                         lambda: F.scaled_dot_product_attention(
                             qs, ks, vs, scale=1.0), 20),
                     bound_ms=b_ms, bound_by=b_by)
        log(f"time window attention: {json.dumps(entry)}")
        del qkv, out, qs, ks, vs

    # row quantization alone: the proj_in site of B8 / C8 and H8's largest
    # input (the decoder's 30000 image tokens of width 256)
    for rows, n in ((30000, c), (rows_c, c), (30000, 256)):
        x = torch.randn(rows, n, device=dev, generator=g).to(bf)
        for mode in ("dynamic", "static"):
            sc = None if mode == "dynamic" else torch.full(
                (1,), 0.03, device=dev)
            q, qs = int8.row_quant(x, sc)
            qr, qsr = (int8.rowquant(x) if sc is None
                       else int8.statquant(x, sc))
            ok = torch.equal(q, qr) and torch.equal(qs.reshape(-1),
                                                    qsr.reshape(-1))
            ok_all &= ok
            b_ms, b_by = bound(0, rows * n * 3 + (rows * 4 if sc is None
                                                  else 4))
            entry = dict(shape=f"x ({rows},{n}) bf16 -> int8, {mode}",
                         ms=cuda_time(lambda: int8.row_quant(x, sc), 50),
                         plain_ms=cuda_time(
                             lambda: int8.rowquant(x) if sc is None
                             else int8.statquant(x, sc), 3),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by,
                         equal_to_plain=ok)
            log(f"time row quantization: {json.dumps(entry)}")
    return ok_all


def phase_kernels_int8(model, results):
    """Check and time B8 and C8 at every main-path shape, with per-row
    (dynamic) activation scales and with static site scales (calibrated on
    the same input by the plain probes of ops/int8_calib), and the head's
    int8 linear H8 at its largest main-path shape."""
    import torch
    from toc3d_tpu_torch.layers import quantize_linear
    from toc3d_tpu_torch.models.eva_vit import make_rope_tables, rope_tensors
    from toc3d_tpu_torch.ops.cuda import int8
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    cfg = model.cfg.backbone
    bf = torch.bfloat16
    win, glb = make_rope_tables(cfg)
    rope = {cfg.window_size: rope_tensors(win, dev),
            cfg.global_window_size: rope_tensors(glb, dev)}
    x = (torch.randn(6, 50, 100, cfg.embed_dim, device=dev, generator=g)
         * 0.5).to(bf)
    scores = torch.randn(6, 5000, device=dev, generator=g).to(bf)
    ok_all = True
    for i, ws, ratio in block_shapes(cfg):
        key = "B8" if ratio is None else "C8"
        for mode in ("dynamic", "static"):
            tag = (f"{key} ws{ws}" + ("" if ratio is None else f" r{ratio}")
                   + f" {mode}")
            ok, entry = check_block(tag, model.img_backbone.blocks[i], x, cfg,
                                    ws, rope[ws], scores, ratio, mode,
                                    reps=10)
            ok_all &= ok
            keep_row(results, key, entry, BLOCK_ROWS[key][0],
                     "toc3d_tpu_torch/csrc/vit_block.cu", BLOCK_ROWS[key][1])
    del x, scores

    # H8: the decoder's cross-attention key projection, 6 x 50 x 100 image
    # tokens of width 256 (the largest of the head's int8 linears)
    xk = torch.randn(1, 30000, 256, device=dev, generator=g).to(bf)
    lin = model.pts_bbox_head.transformer.decoder.layers[0].attentions[1]
    w = lin.attn.in_proj_weight
    p = quantize_linear(w[256:512], lin.attn.in_proj_bias[256:512])
    ok, err = compare("H8 int8 linear (1,30000,256)->256",
                      int8.int8_linear(xk, p), int8.int8_linear_plain(xk, p))
    ok_all &= ok
    m = 30000
    b_ms, b_by = bound_int8(2 * m * 256 * 256, 0,
                            m * 256 * 2 * 2 + 256 * 256 + 256 * 8)
    results["H8"] = dict(
        name="int8_linear", route="cuda",
        source="toc3d_tpu_torch/csrc/vit_block.cu",
        replaces="toc3d_tpu/layers.py:110",
        shape="x (1,30000,256) bf16 -> 256, int8 weights",
        max_abs_err=err, ms=cuda_time(lambda: int8.int8_linear(xk, p), 20),
        plain_ms=cuda_time(lambda: int8.int8_linear_plain(xk, p), 5),
        library_ms=cuda_time(lambda: _lib_qmm(xk, p.w, p.scale, p.bias), 20),
        bound_ms=b_ms, bound_by=b_by)
    log(f"time H8: {json.dumps(results['H8'])}")
    return ok_all


def check_block(tag, blk, x, cfg, ws, rope, scores=None, ratio=None,
                mode="bf16", reps=5):
    """One B / C / B8 / C8 call of a block of the backbone ``cfg`` (ratio
    None: the full block; mode 'dynamic' / 'static': the int8 form, static
    with the site scales that the plain probes of ops/int8_calib calibrate
    on the same input) and its attention delta against the plain versions,
    timed beside the library yardstick and the bound. C and its yardstick
    both route the tokens (compress_plan) inside the timed call; the plan's
    own time and the yardstick with the plan made beforehand are logged
    beside. Returns (ok, entry)."""
    from toc3d_tpu_torch.models.eva_vit import set_act_scales
    from toc3d_tpu_torch.ops import int8_calib
    from toc3d_tpu_torch.ops.cuda import vit_block
    b, h, w, c = x.shape
    heads = cfg.num_heads
    d = c // heads
    hid = blk.mlp.w1.out_features
    int8_ = mode != "bf16"
    if mode == "static":
        amax = (int8_calib.full_block_site_amax(blk, x, heads, ws, rope)
                if ratio is None else int8_calib.compressed_block_site_amax(
                    blk, x, scores, cfg, ws, ratio, rope))
        set_act_scales(blk, (amax.float() / 127.0).tolist())
    wts = (vit_block.pack_block_weights_int8 if int8_ else
           vit_block.pack_block_weights)(blk, heads, x.dtype)
    rows_fn = _lib_rows_block_int8 if int8_ else _lib_rows_block
    plan, extra = None, {}
    shape = f"x ({b},{h},{w},{c}) bf16, {heads} heads, ws {ws}"
    if ratio is None:
        fn = vit_block.fused_full_block_int8 if int8_ \
            else vit_block.fused_full_block
        run = lambda: fn(blk, x, heads, ws, rope)
        plain = lambda: vit_block.full_block_plain(wts, x, heads, ws, rope)
        lib = lambda: lib_full_block(wts, x, heads, ws, rope, rows_fn)
        work = (full_block_work_int8 if int8_ else full_block_work)(
            b, h, w, c, hid, ws, d)
    else:
        fn = vit_block.fused_compressed_block_int8 if int8_ \
            else vit_block.fused_compressed_block
        make_plan = lambda: vit_block.compress_plan(
            scores, b, h, w, ws, ratio, cfg.use_represent_tokens,
            cfg.mxu_align_k)
        plan = make_plan()
        run = lambda: fn(blk, x, scores, heads, ws, ratio, rope,
                         cfg.use_represent_tokens, cfg.rope_acc,
                         cfg.mxu_align_k)
        plain = lambda: vit_block.compressed_block_plain(wts, x, plan, heads,
                                                         ws, rope)
        lib = lambda: lib_compressed_block(wts, x, make_plan(), heads, ws,
                                           rope, rows_fn)
        work = (compressed_block_work_int8 if int8_ else
                compressed_block_work)(b, h, w, c, hid, ws, plan.k,
                                       plan.has_rep, d)
        shape += f", ratio {ratio}, k {plan.k}"
        extra = dict(
            library_ms_plan_outside=cuda_time(lambda: lib_compressed_block(
                wts, x, plan, heads, ws, rope, rows_fn), reps),
            plan_ms=cuda_time(make_plan, reps))
    if int8_:
        shape += ", " + vit_block.is_quantized(wts)
    ok, err = compare(tag, run(), plain())
    ok &= compare(f"{tag} attention delta",
                  vit_block.attention_delta(blk, x, heads, ws, rope, plan,
                                            int8=int8_),
                  vit_block.attention_delta_plain(wts, x, heads, ws, rope,
                                                  plan))[0]
    b_ms, b_by = bound_int8(*work) if int8_ else bound(*work)
    entry = dict(shape=shape, max_abs_err=err, ms=cuda_time(run, reps),
                 plain_ms=cuda_time(plain, 1, warmup=1),
                 library_ms=cuda_time(lib, reps), bound_ms=b_ms,
                 bound_by=b_by, **extra)
    log(f"time {tag}: {json.dumps(entry)}")
    if mode == "static":
        set_act_scales(blk, None)
    return ok, entry


# ---------------------------------------------------------------------------
# the other presets' kernel shapes
# ---------------------------------------------------------------------------

def _block_model(c, heads, hid, seed):
    """One EVA-02 block of width c on the card, weights as build_detector
    draws them (trunc. normal 0.02 matrices), LN weights near 1."""
    import torch
    from toc3d_tpu_torch.models.eva_vit import Block, EVAViTConfig
    blk = Block(EVAViTConfig(embed_dim=c, num_heads=heads,
                             mlp_ratio=hid / c))
    assert blk.mlp.w1.out_features == hid
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g)
                    * (0.02 if p.dim() > 1 else 0.1))
            if name.endswith(("norm1.weight", "norm2.weight",
                              "ffn_ln.weight")):
                p.add_(1.0)
    return blk.cuda()


def preset_shapes(main="ToC3D_faster_1600"):
    """The kernel shapes of every full-width preset, derived from its
    config as the main path's are (frame_blocks, block_rows, ln_sites), less
    those of ``main``, which phases 3-4 and 6 hold: {"A": {(h, w, c)}, "D":
    {keys}, "blocks": {(c, heads, hid, h, w, ws, ratio): (preset, backbone
    config)}, "gemm": {(c, hid): {rows}}, "ln": {site: name}}. A block's
    GEMMs run at B's tokens plus the LN(0) row, or at C's rows; G and G8
    alone are held at each map's B rows and its largest C rows."""
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.configs.presets import PRESETS

    def of(name):
        cfg = get_config(name)
        bcfg = cfg.backbone
        p = bcfg.patch_size
        h, w = cfg.pad_shape[0] // p, cfg.pad_shape[1] // p
        c, heads = bcfg.embed_dim, bcfg.num_heads
        hid = int(c * bcfg.mlp_ratio)
        out = {"A": {(h * p, w * p, c)}, "D": {6 * h * w}, "blocks": {},
               "gemm": {}, "ln": {}}
        c_rows = 0
        for ws, r in frame_blocks(bcfg):
            out["blocks"].setdefault((c, heads, hid, h, w, ws, r),
                                     (name, bcfg))
            rows = block_rows(bcfg, ws, r, 6, h, w)[2]
            if r is None:
                out["gemm"].setdefault((c, hid), set()).add(rows + 1)
            else:
                c_rows = max(c_rows, rows)
        if c_rows:
            out["gemm"][(c, hid)].add(c_rows)
        for site, args in ln_sites(bcfg, 6, h, w).items():
            out["ln"].setdefault(args, f"{site} ({c}-wide, {h}x{w})")
        return out

    done = of(main)
    todo = {"A": set(), "D": set(), "blocks": {}, "gemm": {}, "ln": {}}
    for name in PRESETS:
        if name in ("tiny", main):
            continue
        s = of(name)
        todo["A"] |= s["A"] - done["A"]
        todo["D"] |= s["D"] - done["D"]
        for key in ("blocks", "ln"):
            for k, v in s[key].items():
                if k not in done[key]:
                    todo[key].setdefault(k, v)
        for k, rows in s["gemm"].items():
            todo["gemm"].setdefault(k, set()).update(
                rows - done["gemm"].get(k, set()))
    return todo


def phase_preset_shapes():
    """Every kernel shape of the other presets (preset_shapes), each
    against its plain version on the card and timed beside its library
    yardstick and bound, as phases 3-4 and 6 hold the main path's: A at
    each (image, width); B / C in bf16 and B8 / C8 dynamic and static at
    each (width, map, window size, ratio) a preset runs; G and G8 alone at
    each width's GEMMs; the LayerNorm at each call site (check_ln_sites);
    D at each map's keys. Returns ok."""
    import torch
    from toc3d_tpu_torch.models.eva_vit import make_rope_tables, rope_tensors
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    ok_all = True
    todo = preset_shapes()
    log(f"other presets' kernel shapes: A {sorted(todo['A'])}; "
        f"{len(todo['blocks'])} block shapes (width, heads, hidden, map, ws, "
        f"ratio) {sorted(todo['blocks'], key=str)}; G / G8 rows "
        f"{ {k: sorted(v) for k, v in todo['gemm'].items()} }; "
        f"{len(todo['ln'])} LayerNorm sites; D keys {sorted(todo['D'])}")
    for h, w, c in sorted(todo["A"]):
        ok_all &= check_patch_embed(h, w, c, g)

    models, maps = {}, {}
    for key in sorted(todo["blocks"], key=str):
        c, heads, hid, h, w, ws, ratio = key
        name, cfg = todo["blocks"][key]
        blk = models.get((c, heads, hid))
        if blk is None:
            blk = models[(c, heads, hid)] = _block_model(c, heads, hid, c)
        if (c, h, w) not in maps:
            maps.clear()
            maps[(c, h, w)] = (
                (torch.randn(6, h, w, c, device=dev, generator=g)
                 * 0.5).to(bf),
                torch.randn(6, h * w, device=dev, generator=g).to(bf))
        x, scores = maps[(c, h, w)]
        win, glb = make_rope_tables(cfg)
        rope = rope_tensors(win if ws == cfg.window_size else glb, dev)
        kind = "B" if ratio is None else "C"
        for mode in ("bf16", "dynamic", "static"):
            tag = (f"{kind}{'' if mode == 'bf16' else '8'} {name} "
                   f"({c},{h}x{w}) ws{ws}"
                   + ("" if ratio is None else f" r{ratio}")
                   + ("" if mode == "bf16" else f" {mode}"))
            ok_all &= check_block(tag, blk, x, cfg, ws, rope, scores, ratio,
                                  mode)[0]
    del models, maps

    for (c, hid), rows in sorted(todo["gemm"].items()):
        for m in sorted(rows):
            ok_all &= check_gemms(f"{c}-wide", m, gemm_shapes(c, hid), g,
                                  reps=10)[0]
    ok_all &= check_ln_sites({v: k for k, v in todo["ln"].items()}, g)[0]
    for kv in sorted(todo["D"]):
        ok_all &= check_flash(kv, g)[0]
    return ok_all


KERNELS = ("A", "B", "C", "D", "B8", "C8", "H8", "G", "G8", "LN")


def counters():
    """The launch-counting wrapper of each kernel, in KERNELS order (G:
    vit_block._gemm, under gemm_bf16 and every bf16 matmul of B and C, not
    A's product; G8: int8.gemm_s8_sm90, every weight matmul of B8 and C8;
    LN: vit_block.layernorm, every launch of the LayerNorm kernel, three a
    block)."""
    from toc3d_tpu_torch.ops.cuda import counted_wrappers
    return counted_wrappers()


def host_frames(seed: int, n: int = 6, pad_shape=(800, 1600)):
    """n frames of the synthetic stream (prev_exists 0, then 1) at
    ``pad_shape``, built on the host and held in pinned memory, as a server
    holds them."""
    import torch
    from toc3d_tpu_torch.models.detector import synthetic_frame
    g = torch.Generator().manual_seed(seed)
    h, w = pad_shape
    return [{k: v.pin_memory() for k, v in
             synthetic_frame(g, t, height=h, width=w, device="cpu").items()}
            for t in range(n)]


def host_calls(fn) -> dict:
    """Run fn once under torch.profiler; count the host's stream, event and
    device synchronisations inside it (CUDA runtime calls) and the copies
    to and from the host it queued (device memcpy records)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("frame"):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    win = next(e.time_range for e in events if e.name == "frame")
    counts = {"syncs": 0, "DtoH": 0, "HtoD pageable": 0, "HtoD pinned": 0,
              "pageable from": sorted({e.name for e in events if any(
                  "Pageable" in k.name for k in e.kernels)})}
    for ev in events:
        name = ev.name
        if name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                    "cudaEventSynchronize"):
            counts["syncs"] += win.start <= ev.time_range.start <= win.end
        elif "DtoH" in name:
            counts["DtoH"] += 1
        elif "HtoD" in name:
            counts["HtoD pinned" if "Pinned" in name
                   else "HtoD pageable"] += 1
    return counts


def _stream(infer, state, frames):
    """Each frame through infer, timed on the host clock up to a
    synchronisation; returns (state, per-frame outputs, frame ms)."""
    import torch
    times, outs = [], []
    for frame in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, det = infer(state, frame)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append((state, det))
    return state, outs, times


def phase_main_path(model, results, label="bf16",
                    per_frame=(1, 6, 18, 12, 0, 0, 0, 96, 0, 72),
                    record=("A", "B", "C", "D", "G", "LN"),
                    name="ToC3D_faster_1600", n_frames=6, selectors=3,
                    host_checks=True):
    """Stream n_frames host frames (pinned) at the preset's pad shape
    eagerly through infer_step, then with every launch count set to 0 just
    before, through make_infer_fn(model), the captured frame (the main
    path; a preset's own path for another ``name``); per_frame: the
    launches each frame must make of each kernel, in KERNELS order;
    selectors: the token selectors each eager frame must run; record: the
    kernels whose launch counts this run reports. The captured frame's
    outputs (boxes, scores, labels, validity, the bank) must equal eager's
    bit for bit, frame by frame. Prints for both: the frame times, steady
    ms/frame, peak memory and, with host_checks, the host's
    synchronisations and copies in one more steady frame and the
    weight-key check's host cost. Returns (ok, decoded per frame)."""
    import torch
    from toc3d_tpu_torch.models import toc3d_vit
    from toc3d_tpu_torch.models.detector import (infer_step, init_state,
                                                 make_infer_fn)
    from toc3d_tpu_torch.ops.cuda import param_key
    dev = torch.device("cuda")
    frames = host_frames(2, n_frames, model.cfg.pad_shape)
    infer = make_infer_fn(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    selector, ran = toc3d_vit.selector_score, []

    def count_selector(*a, **kw):
        ran.append(1)
        return selector(*a, **kw)
    toc3d_vit.selector_score = count_selector
    try:
        eager_state, eager, eager_ms = _stream(
            lambda s, f: infer_step(model, s, f),
            init_state(1, model.cfg, device=dev), frames)
    finally:
        toc3d_vit.selector_score = selector
    eager_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    for f in counters():
        f.launches = 0
    state, graph, graph_ms = _stream(infer, init_state(1, model.cfg,
                                                       device=dev), frames)
    launches = [f.launches for f in counters()]
    graph_peak = torch.cuda.max_memory_allocated() / 2**30
    ok = len(ran) == selectors * len(frames)
    if not ok:
        log(f"main path {name} {label}: {len(ran)} selector runs in "
            f"{len(frames)} eager frames, expected {selectors} a frame")
    for key, got, want in zip(KERNELS, launches, per_frame):
        if key in record:
            results[key]["launches"] = got
        if got != want * len(frames):
            log(f"main path {name} {label}: kernel {key} launched {got} "
                f"times, expected {want * len(frames)}")
            ok = False
    equal = [all(torch.equal(a, b) for a, b in zip(
        tuple(gs.memory) + tuple(gd), tuple(es.memory) + tuple(ed)))
        for (gs, gd), (es, ed) in zip(graph, eager)]
    ok &= all(equal)
    dets = [d for _, d in graph]
    det = dets[-1]
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (det.bboxes, det.scores, state.memory.embedding,
                  state.memory.reference_point))
    shapes = (tuple(det.bboxes.shape) == (1, 300, 9)
              and tuple(det.scores.shape) == (1, 300))
    ok &= finite and shapes
    steady = frames[-1]
    calls_g = calls_e = "not counted"
    key_us = float("nan")
    if host_checks:
        calls_g = host_calls(lambda: infer(state, steady))
        calls_e = host_calls(lambda: infer_step(model, eager_state, steady))
        key_us = host_us(lambda: param_key(model), calls=200)
    h, w = model.cfg.pad_shape
    for run, ms, peak, calls in (("eager infer_step", eager_ms, eager_peak,
                                  calls_e),
                                 ("captured make_infer_fn", graph_ms,
                                  graph_peak, calls_g)):
        log(f"main path {name} {label}, {run}, {len(frames)} x {w}x{h} "
            f"uint8 host frames, batch 1: frame ms "
            f"{[round(t, 3) for t in ms]}; steady mean "
            f"{sum(ms[2:]) / len(ms[2:]):.3f} ms/frame over frames 2-"
            f"{len(frames) - 1}; peak memory {peak:.3f} GiB; one more steady "
            f"frame: {calls}")
    log(f"main path {name} {label}: launches {'/'.join(KERNELS)} "
        f"{launches}; selector runs (eager) {len(ran)}; captured equals "
        f"eager per frame {equal}; finite {finite} shapes {shapes}; "
        f"weight-key check {key_us:.1f} us a call")
    return ok, dets


def _against_bf16(label, dets, ref):
    """Printed, not checked: per frame, how many of the int8 run's 50 best
    boxes have a bf16 box among the bf16 run's 50 best within 0.5 m
    (centres), the median distance to the nearest one, and the mean |score
    difference| rank by rank over the 300 decoded."""
    import torch
    overlap, near, mad = [], [], []
    for d, r in zip(dets, ref):
        dist = torch.cdist(d.bboxes[0, :50, :3].float(),
                           r.bboxes[0, :50, :3].float()).amin(dim=1)
        overlap.append(int((dist <= 0.5).sum()))
        near.append(round(dist.median().item(), 3))
        mad.append(round((d.scores - r.scores).abs().mean().item(), 6))
    log(f"{label} against bf16, same frames (not checked): top-50 overlap "
        f"{overlap}; median nearest centre (m) {near}; score MAD {mad}")


def phase_main_path_int8(results, bf16_dets):
    """The int8 serving path at full width: ToC3D_faster_1600 with backbone
    and decoder quant 'int8' and the bf16 run's random weights (same seed),
    streamed with dynamic scales, then calibrated on 2 synthetic frames and
    streamed with static scales."""
    import torch
    from dataclasses import replace
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import build_detector, synthetic_frame
    from toc3d_tpu_torch.ops.int8_calib import (attach_act_scales,
                                                calibrate_act_scales)
    cfg = get_config("ToC3D_faster_1600")
    cfg = replace(cfg, backbone=replace(cfg.backbone, quant="int8"),
                  head=replace(cfg.head, decoder=replace(cfg.head.decoder,
                                                         quant="int8")))
    model = build_detector(cfg, device="cuda", seed=0)
    per_frame = (1, 0, 0, 12, 6, 18, 60, 0, 96, 72)
    ok, dets = phase_main_path(model, results, "int8 dynamic", per_frame,
                               ("B8", "C8", "H8", "G8"))
    _against_bf16("int8 dynamic", dets, bf16_dets)
    g = torch.Generator(device="cuda").manual_seed(7)
    cal = [synthetic_frame(g, t) for t in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    attach_act_scales(model, calibrate_act_scales(model, cal))
    torch.cuda.synchronize()
    log(f"calibration: 2 frames in {time.perf_counter() - t0:.3f} s")
    ok_s, dets = phase_main_path(model, results, "int8 static", per_frame,
                                 ())
    _against_bf16("int8 static", dets, bf16_dets)
    return ok and ok_s


def phase_presets(results):
    """The other presets' paths at full width, each with every launch count
    set to 0 just before it and read just after (phase_main_path):
    stream_petr_eva_vit_l_1600 (the plain backbone: 24 B blocks, no
    selector) for 6 frames in bf16 and in int8 dynamic; ToC3D_fast (ratio
    .7) and ToC3D_vit_b_faster (ViT-B, selectors at 3, 6, 9) at 800x320
    for 3 frames each; captured against eager bit for bit. Returns ok."""
    import torch
    from dataclasses import replace
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import build_detector
    ok_all = True
    runs = (("stream_petr_eva_vit_l_1600", "bf16", 6, 0,
             (1, 24, 0, 12, 0, 0, 0, 96, 0, 72)),
            ("stream_petr_eva_vit_l_1600", "int8 dynamic", 6, 0,
             (1, 0, 0, 12, 24, 0, 60, 0, 96, 72)),
            ("ToC3D_fast", "bf16", 3, 3, (1, 6, 18, 12, 0, 0, 0, 96, 0, 72)),
            ("ToC3D_vit_b_faster", "bf16", 3, 3,
             (1, 3, 9, 12, 0, 0, 0, 48, 0, 36)))
    for name, label, n, sel, per_frame in runs:
        cfg = get_config(name)
        if label != "bf16":
            cfg = replace(cfg, backbone=replace(cfg.backbone, quant="int8"),
                          head=replace(cfg.head, decoder=replace(
                              cfg.head.decoder, quant="int8")))
        model = build_detector(cfg, device="cuda", seed=0)
        ok, _ = phase_main_path(model, results, label, per_frame, (), name,
                                n, sel, host_checks=False)
        ok_all &= ok
        del model
        torch.cuda.empty_cache()
    return ok_all


def phase_gumbel():
    """eval_mask 'gumbel' on the card: the tiny preset with two selectors
    (the first one's mask feeds the second), streamed over prev_exists 0,
    1, 1, 0, 1 through the captured make_infer_fn and through eager
    infer_step (eager_infer_fn), both from mask_seed 11: equal bit for bit.
    Then two more calls on the same state and frame: the noise is fresh,
    so they differ, and the global generator is untouched. Returns ok."""
    import torch
    from dataclasses import replace
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import (build_detector,
                                                 eager_infer_fn, init_state,
                                                 make_infer_fn,
                                                 synthetic_frame)
    cfg = get_config("tiny", compute_dtype="bfloat16")
    cfg = replace(cfg, head=replace(cfg.head, compute_dtype="bfloat16"),
                  backbone=replace(cfg.backbone, eval_mask="gumbel",
                                   pruning_loc=(0, 2),
                                   token_ratio=(0.5, 0.5)))
    model = build_detector(cfg, device="cuda", seed=3)
    g = torch.Generator().manual_seed(4)
    frames = []
    for t, pe in enumerate((0.0, 1.0, 1.0, 0.0, 1.0)):
        f = synthetic_frame(g, t, views=2, height=64, width=128, device="cpu")
        f["prev_exists"] = torch.full((1,), pe)
        frames.append({k: v.pin_memory() for k, v in f.items()})
    outs = {}
    for kind, make in (("captured", make_infer_fn), ("eager", eager_infer_fn)):
        infer = make(model, mask_seed=11)
        state = init_state(1, cfg, device="cuda")
        outs[kind] = []
        for f in frames:
            state, det = infer(state, f)
            outs[kind].append(tuple(state.memory) + tuple(det))
    equal = [all(torch.equal(a, b) for a, b in zip(x, y))
             for x, y in zip(outs["captured"], outs["eager"])]
    infer = make_infer_fn(model, mask_seed=11)
    state = init_state(1, cfg, device="cuda")
    for f in frames[:2]:
        state, _ = infer(state, f)
    rng = torch.cuda.get_rng_state()
    first = infer(state, frames[2])[0].memory.embedding
    again = infer(state, frames[2])[0].memory.embedding
    fresh = not torch.equal(first, again)
    untouched = torch.equal(rng, torch.cuda.get_rng_state())
    ok = all(equal) and fresh and untouched
    log(f"gumbel eval mask (tiny, 2 selectors, mask_seed 11): captured "
        f"equals eager per frame {equal}; two replays on one state and "
        f"frame differ {fresh} (bank embeddings mean |d| "
        f"{(first - again).abs().mean().item():.6g}); global generator "
        f"untouched {untouched} {'ok' if ok else 'FAIL'}")
    return ok


FLIPS = 8   # CPU streams with last-bit steps in their features


def last_bit_steps(f, g):
    """f (f32 holding bf16 values) with about half its nonzero values
    moved one bf16 step up or down in magnitude (a quarter each way): the
    kind of difference two bf16 implementations of the same op leave."""
    import torch
    b = f.to(torch.bfloat16)
    r = torch.randint(0, 4, f.shape, generator=g)
    step = ((r == 2).to(torch.int16) - (r == 3).to(torch.int16)) * (b != 0)
    return (b.view(torch.int16) + step).view(torch.bfloat16).to(f.dtype)


def phase_small_agreement(quant="none", plain=False):
    """The tiny preset in bf16 on the card (kernels) against the same model
    on the CPU (plain versions, bf16), streamed for 3 frames (prev_exists
    0, 1, 1), each side carrying its own memory bank from frame to frame.
    quant 'dynamic' / 'static': backbone and decoder int8 (B8, C8, H8 on
    the card), static with scales calibrated on the card on 2 frames and
    loaded into the CPU model with the weights. The int8 checks take twice
    the kernel tolerance: an int8 step is 2^-7 of a row's range, and a
    last-bit bf16 difference before the quantization (the card's and the
    CPU's LayerNorm and matmuls round apart) flips the step of up to half
    the values near the row's maximum, so after the decoder's 60 int8
    linears the banks' mean error reaches 2^-6 of their mean (measured on
    the card).

    plain: the tiny preset's widths with the plain EVA-02 backbone (no
    selector). Its random-weight head amplifies the backbone's last-bit
    differences: the neck features of card and CPU differ by 0.32% of their
    mean, and the banks by 1.8-3.4%, while the card's head computes bit for
    bit the CPU's given the same features and bank choice (measured on the
    card, frame 0). So the CPU's head takes the card's neck features there,
    after they are compared: the backbone and the head are each held to
    the bounds. End to end, a second CPU stream runs its own head on its
    own features, and the f32 yardstick below holds it.

    The f32 yardstick (quant 'none'): the same model in f32 on the CPU,
    with the card's choices. Its distance (mean |d| over mean |f32|) to the
    card must be at most 1.25 times the largest of its distances to the
    CPU's bf16 streams: the CPU's own, and FLIPS more whose head takes the
    CPU's neck features with the last bit of about half the values moved
    one step (last_bit_steps), each carrying its own bank. One bf16 stream
    is one sample of how far a last-bit difference in the features carries
    through this random head: for the plain backbone, the card's bank and
    the CPU's own stood 1.5-3 times apart against the f32 run (measured on
    the card), while their features stood equally far from it. Checked per
    frame for the neck features and the bank's embeddings (512 values or
    more), and over the 3 frames together for the bank's reference points
    and velocities (8, 16 and 24 entries of 5 values).

    Two discrete choices are a top-k over nearly tied values: token
    routing, over bf16 selector scores, and the queries that enter the
    memory bank, over random-weight detection scores. One flipped last bit
    between two matmul implementations breaks such a tie the other way,
    and from there the stream differs by more than rounding. So the CPU
    side computes both on its own, and then follows the card's choice:
    routing with the card's selector scores, the bank with the card's
    propagated queries. The card's bank choice is checked first: it must
    be a top-k of the CPU's own detection scores up to 0.01 (no query left
    out scores more than 0.01 above one taken). Compared per frame, with
    compare()'s tolerance: the selectors' scores, the neck features and
    the memory bank (embeddings, reference points, velocities); and the
    decoded scores within 0.01. Printed beside, not checked: the neck
    features of the CPU routing with its own scores, against the card's,
    and how many bank queries the CPU's own top-k would have chosen
    otherwise. They show what the pinned choices take out of the
    comparison."""
    import torch
    from dataclasses import fields, replace
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models import streampetr_head, toc3d_vit
    from toc3d_tpu_torch.models.eva_vit import EVAViTConfig
    from toc3d_tpu_torch.models.detector import (build_detector,
                                                 extract_img_feat, head_step,
                                                 init_state,
                                                 precast_backbone_,
                                                 synthetic_frame)
    from toc3d_tpu_torch.ops.int8_calib import (attach_act_scales,
                                                calibrate_act_scales)
    cfg = get_config("tiny", compute_dtype="bfloat16")
    cfg = replace(cfg, head=replace(cfg.head, compute_dtype="bfloat16"))
    if plain:
        cfg = replace(cfg, backbone=EVAViTConfig(**{
            f.name: getattr(cfg.backbone, f.name)
            for f in fields(EVAViTConfig)}))
    if quant != "none":
        cfg = replace(cfg, backbone=replace(cfg.backbone, quant="int8"),
                      head=replace(cfg.head, decoder=replace(
                          cfg.head.decoder, quant="int8")))
    tag = ("tiny" if quant == "none" else f"tiny int8 {quant}") + (
        ", plain backbone" if plain else "")
    tol = 1.0 if quant == "none" else 2.0
    gpu = build_detector(cfg, device="cuda", seed=3)
    cpu = build_detector(cfg, device="cpu")
    if quant == "static":
        gc = torch.Generator(device="cuda").manual_seed(5)
        attach_act_scales(gpu, calibrate_act_scales(gpu, [
            synthetic_frame(gc, t, views=2, height=64, width=128,
                            device="cuda") for t in range(2)]))
    cpu.load_state_dict(gpu.state_dict())
    # an f32 run on the CPU (same choices as the card's) as the yardstick
    # of both bf16 sides' rounding
    ref = None
    if quant == "none":
        ref = build_detector(replace(cfg, compute_dtype="float32",
                                     head=replace(cfg.head,
                                                  compute_dtype="float32")),
                             device="cpu")
        ref.load_state_dict(gpu.state_dict())
        sr = init_state(1, ref.cfg, "cpu")
        so = init_state(1, cfg, "cpu")
        stepped = [init_state(1, cfg, "cpu") for _ in range(FLIPS)]
        gs = torch.Generator().manual_seed(8)
        # summed |d| of the card and of each CPU stream, then sum |f32|
        geo = {n: [0.0] * (FLIPS + 3) for n in ("reference_point", "velo")}
    precast_backbone_(gpu)
    precast_backbone_(cpu)
    g = torch.Generator(device="cuda").manual_seed(4)
    sg, sc = init_state(1, cfg, "cuda"), init_state(1, cfg, "cpu")
    selector = toc3d_vit.selector_score
    propagated = streampetr_head.propagated_queries
    card_sel, cpu_pred, card_bank, cpu_bank = [], [], [], []

    def record(*a, **kw):
        card_sel.append(selector(*a, **kw))
        return card_sel[-1]

    def replay(*a, **kw):
        cpu_pred.append(selector(*a, **kw)[1])
        return tuple(t.cpu() for t in card_sel[len(cpu_pred) - 1])

    def record_bank(hcfg, cls_last):
        card_bank.append(propagated(hcfg, cls_last))
        return card_bank[-1]

    def replay_bank(hcfg, cls_last):
        cpu_bank.append((torch.sigmoid(cls_last).amax(dim=-1),
                         propagated(hcfg, cls_last)))
        return card_bank[-1].cpu()

    ok, score_abs = True, 0.0
    try:
        for t in range(3):
            fg = synthetic_frame(g, t, views=2, height=64, width=128,
                                 device="cuda")
            fc = {k: v.cpu() for k, v in fg.items()}
            steady = t > 0
            del card_sel[:], cpu_pred[:]
            toc3d_vit.selector_score = record
            streampetr_head.propagated_queries = record_bank
            featg = extract_img_feat(gpu, fg["img"], sg.memory, fg, steady)
            sg, dg = head_step(gpu, sg, featg, fg)
            toc3d_vit.selector_score = selector
            featw = extract_img_feat(cpu, fc["img"], sc.memory, fc, steady)
            toc3d_vit.selector_score = replay
            streampetr_head.propagated_queries = replay_bank
            featc = extract_img_feat(cpu, fc["img"], sc.memory, fc, steady)
            sc, dc = head_step(cpu, sc, featg.cpu() if plain else featc, fc)
            if ref is not None:
                seen = []

                def replay_ref(*a, **kw):
                    seen.append(1)
                    return tuple(x.cpu().float()
                                 for x in card_sel[len(seen) - 1])
                toc3d_vit.selector_score = replay_ref
                streampetr_head.propagated_queries = \
                    lambda hcfg, cls_last: card_bank[-1].cpu()
                featr = extract_img_feat(ref, fc["img"], sr.memory, fc,
                                         steady)
                sr, _ = head_step(ref, sr, featr, fc)
                if plain:
                    so, _ = head_step(cpu, so, featc, fc)
                feats, states = [featg.cpu(), featc], [sg, so if plain
                                                       else sc]
                for i in range(FLIPS):
                    feats.append(last_bit_steps(featc, gs))
                    stepped[i], _ = head_step(cpu, stepped[i], feats[-1],
                                              fc)
                    states.append(stepped[i])
                rel = lambda a, b: ((a.float() - b).abs().mean()
                                    / b.abs().mean()).item()
                d = {"neck features": [rel(f, featr) for f in feats]}
                for n in ("embedding", "reference_point", "velo"):
                    d[f"memory {n}"] = [
                        rel(getattr(st.memory, n).cpu(),
                            getattr(sr.memory, n)) for st in states]
                for n, acc in geo.items():
                    r = getattr(sr.memory, n)
                    for i, st in enumerate(states):
                        acc[i] += (getattr(st.memory, n).cpu().float()
                                   - r).abs().sum().item()
                    acc[-1] += r.abs().sum().item()
                held = all(d[n][0] <= 1.25 * max(d[n][1:]) for n in (
                    "neck features", "memory embedding"))
                ok &= held
                log(f"frame {t} against an f32 CPU run with the card's "
                    f"choices ({tag}): mean |d| / mean |f32| of the card / "
                    f"the CPU's own bf16 stream / the largest of all "
                    f"{FLIPS + 1} CPU streams: " + ", ".join(
                        f"{n} {v[0]:.4%} / {v[1]:.4%} / {max(v[1:]):.4%}"
                        for n, v in d.items())
                    + " (neck features and embedding: card <= 1.25 x "
                    f"largest) {'ok' if held else 'FAIL'}")
            toc3d_vit.selector_score = selector
            streampetr_head.propagated_queries = propagated
            for i, (card, own) in enumerate(zip(card_sel, cpu_pred)):
                ok &= compare(f"frame {t} selector {i} scores ({tag})",
                              card[1].cpu(), own, tol)[0]
            ok &= compare(f"frame {t} neck features ({tag})", featg.cpu(),
                          featc, tol)[0]
            free = ((featw - featg.cpu()).abs().mean()
                    / featg.abs().mean()).item()
            rec, own_idx = cpu_bank[-1]
            taken = torch.zeros_like(rec, dtype=torch.bool)
            taken.scatter_(1, card_bank[-1].cpu(), True)
            gap = (rec.masked_fill(taken, -1.0).amax(dim=1)
                   - rec.masked_fill(~taken, 2.0).amin(dim=1)).max().item()
            flips = int((~taken.gather(1, own_idx)).sum())
            bank_ok = gap <= 0.01
            ok &= bank_ok
            log(f"frame {t} bank choice ({tag}): best query left out beats "
                f"the worst taken by {gap:.6g} (tol 0.01) "
                f"{'ok' if bank_ok else 'FAIL'}; the CPU's own top-k "
                f"differs in {flips} of {own_idx.numel()}; neck features "
                f"with the CPU's own routing: mean |d| {free:.4%} of mean "
                f"|card|")
            for name in ("embedding", "reference_point", "velo"):
                ok &= compare(f"frame {t} memory {name} ({tag})",
                              getattr(sg.memory, name).cpu(),
                              getattr(sc.memory, name), tol)[0]
            score_abs = max(score_abs,
                            (dg.scores.cpu() - dc.scores).abs().max().item())
            ok &= bool(torch.isfinite(dg.scores).all())
    finally:
        toc3d_vit.selector_score = selector
        streampetr_head.propagated_queries = propagated
    ok &= score_abs <= 0.01
    for n, acc in (geo.items() if ref is not None else ()):
        card, own, top = acc[0], acc[1], max(acc[1:-1])
        geo_ok = card <= 1.25 * top
        ok &= geo_ok
        log(f"memory {n} over 3 frames against the f32 run ({tag}): mean "
            f"|d| / mean |f32| of the card {card / acc[-1]:.4%} / the CPU's "
            f"own bf16 stream {own / acc[-1]:.4%} / the largest CPU stream "
            f"{top / acc[-1]:.4%} (card <= 1.25 x largest) "
            f"{'ok' if geo_ok else 'FAIL'}")
    log(f"small-input agreement ({tag}, bf16, card vs CPU plain, 3 frames): "
        f"decoded scores max |d| {score_abs:.6g} (tol 0.01) "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import build_detector

    phase_build()
    t0 = time.perf_counter()
    model = build_detector(get_config("ToC3D_faster_1600"), device="cuda",
                           seed=0)
    log(f"model: ToC3D_faster_1600 random weights (seed 0) built in "
        f"{time.perf_counter() - t0:.1f} s")
    results = {}
    with torch.no_grad():
        ok_k = phase_kernels(model, results)
        ok_k8 = phase_kernels_int8(model, results)
        ok_ps = phase_preset_shapes()
        ok_m, bf16_dets = phase_main_path(model, results)
        del model
        torch.cuda.empty_cache()
        ok_m8 = phase_main_path_int8(results, bf16_dets)
        del bf16_dets
        torch.cuda.empty_cache()
        ok_p = phase_presets(results)
        ok_gb = phase_gumbel()
        ok_s = all([phase_small_agreement(),
                    phase_small_agreement(plain=True)])
        ok_s8 = all([phase_small_agreement("dynamic"),
                     phase_small_agreement("static")])
    if not (ok_k and ok_k8 and ok_ps and ok_m and ok_m8 and ok_p and ok_gb
            and ok_s and ok_s8):
        log(f"chip_smoke: FAILED (kernels {ok_k}, int8 kernels {ok_k8}, "
            f"other presets' kernel shapes {ok_ps}, main path {ok_m}, int8 "
            f"main path {ok_m8}, other presets' paths {ok_p}, gumbel eval "
            f"mask {ok_gb}, small-input agreement {ok_s}, int8 small-input "
            f"agreement {ok_s8})")
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    log(json.dumps({"kernels": [{k: results[r][k] for k in keys}
                                for r in KERNELS]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
