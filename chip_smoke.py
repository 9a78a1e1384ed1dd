"""Smoke run of the PyTorch / CUDA port (toc3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --qkv-handoff [TREE]

(The second: check_qkv_handoff alone, the QKV epilogue and the window
attention at the kernel table's shapes, beside the window attention of the
checkout at TREE, e.g. a `git archive` of an earlier commit, when given.)

Phases, each fatal on failure (exit code != 0):
  1. device: needs torch.cuda; prints the nvidia-smi name / power limit line;
  2. build: compiles every kernel of the main path from toc3d_tpu_torch/csrc
     (one nvcc per source, in parallel) into build/kernels/; the native
     LAP (toc3d_tpu_torch/native/lap.cpp, g++) into build/native/;
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
     int8 linear H8 (csrc/int8_linear.cu, one launch a call) at its five
     main-path shapes (check_h8: S1 (900, 256) -> 256 24 launches a frame,
     S2 (1668, 256) -> 256 12, S3 (30000, 256) -> 256 12, S4 (900, 256) ->
     2048 6, S5 (900, 2048) -> 256 6), torch.equal to its plain version and
     to the old row quantization + mma.sync tile, each timed as CUDA-graph
     replays beside the old tile, torch._int_mm and its bound, the
     per-frame sums against the 0.1405 ms bound and the graph's floor for
     one launch; the int8 main path
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
  7b. the modules outside the shipped configs (phase_alt_modules):
     ToC3D_faster_1600 with backbone.pruning_score_type=score streamed
     for 10 frames (A 1, B 6, C 18, D 12, G 96, LN 72 a frame, captured
     against eager bit for bit) beside the 'attention' path streamed the
     same way; PETRHeadDN at full width (900 queries, 6 layers, feats
     (1, 6, 50, 100, 256)) without DN (D 12: 6 at 900 keys, 6 at 30000)
     and with DN (D 6, the masked self-attention written out), and the
     PETR encoder (2 layers over 6000 tokens, D 2), each against the same
     call with a plain f32 attention core at the kernel tolerance; D at
     q 900 / k 900 against its plain version, timed by graph replay
     beside SDPA and its bound (the kernels line's "D kv900" row);
     VoVNet V-99-eSE (6 views at 320x800 and 800x1600) and ViTSimpleFPN
     (scales 4, 2, 1, 0.5 on (6, 50, 100, 1024)) in bf16 against f32
     (VoVNet at twice the kernel tolerance), shapes, finite, ms beside the
     convolutions' operation bound, peak memory; the host-pipeline twin
     (tools/host_pipeline_bench.py) for 24 frames: host, infer and
     end-to-end frames/s and the overlap, and whether e2e stayed within
     the host's rate (else it is no steady reading); the phase's wall
     time and the nvidia-smi line;
  8. streaming eval (phase_eval): ToC3D_faster_1600 at full width through
     the eval CLI (toc3d_tpu_torch.tools.test's main, in this process) on 2
     learnable synthetic scenes x 6 frames of six 1600x900 JPEGs, the exact
     path (float32 frames, PIL decode) and --fast-decode (uint8, normalized
     on the card), each a capture of its own and each with the counts set
     to 0 just before it and read just after (A 1, B 6, C 18, D 12, G 96,
     LN 72 a frame): its submission equal byte for byte to the one
     streaming_eval builds from eager infer_step on the same frames, every
     sample present, mAP / NDS and the tracker's AMOTA (tools.track
     --eval) finite and in [0, 1]; prints the readers, eval frames/s, the
     host's ms to build a frame and the card's ms a frame by stage; then
     the bench's ToC3D_faster_1600 frames/s in the same process;
  8b. export (phase_export): ToC3D_faster_1600 at full width and depth
     exported (runtime/export.py: torch.export programs, the kernels as
     toc3d:: custom ops) twice, bf16 with float32 images and int8
     dynamic with uint8 images, into a temporary directory deleted after;
     each artifact loaded in a fresh `python3 -c` with no
     toc3d_tpu_torch.models module, 3 frames through the loaded
     detector's call (its programs replayed as captured CUDA graphs)
     equal bit for bit to make_infer_fn's (boxes, scores, labels,
     validity, bank) with the launches per frame of phase 5 and 6 (bf16:
     A 1, B 6, C 18, D 12, G 96, LN 72; int8: A 1, B8 6, C8 18, D 12, H8
     60, G8 96, LN 72), and the same 3 frames through its eager run
     (ExportedDetector.eager) equal too; prints export seconds, artifact
     bytes, load seconds, the loaded programs' steady ms/frame captured
     and eager beside make_infer_fn's captured ones, the phase's wall time
     and the nvidia-smi line;
  8c. warm start (phase_pretrained): ToC3D_faster_1600 on the card, one
     frame captured and replayed through make_infer_fn, then a seeded
     synthetic EVA-02 checkpoint at full width (24 blocks, a 32 x 32 + cls
     pos_embed) merged by runtime/checkpoint.load_backbone_pretrained
     (patch_embed, pos_embed and all 24 blocks loaded); the same frame
     again, recaptured: different from before and equal bit for bit to
     eager infer_step, with the main path's launches on its replay;
  9. training (phase_train): ToC3D_faster at full width, batch 2 (6 views
     of 800x320 each), through runtime/train.make_train_step: the
     Functions of A, B and C at their training shapes (C at every (ws,
     ratio) with the reference's keep counts, k 128 at ws 16 / .5), and
     D's at the head's (1860 queries, 6000 and 2628 keys), each forward
     against its plain version at the kernel bounds (a row each in the
     kernels line) and its gradients against autograd through the model
     path at the same bounds; one step with the counts set to 0 just
     before it and read just after (A 1, B 1, C 18, D 0, G 76, LN 57, the
     backward none); 30 steps on one synthetic batch (3 to settle):
     finite, falling losses, no non-finite skip, steps/s, samples/s, peak
     memory and the ms a step by stage; a capture made before training
     recaptures on the trained weights and equals eager infer_step bit
     for bit for 3 frames; a save / load round trip of the train state is
     exact; a tiny bf16 step on the card against the CPU (each side's
     distance to an f32 step, the card's at most 1.25 times the CPU's);
     the trainer CLI (tools.train) for 3 tiny iterations on synthetic
     scenes, its checkpoint and its eval; the step's launches include the
     auction matcher (AU 7: the card's default, one launch a cost
     tensor), the step's cost tensors are kept, and 6 more steps run with
     the host LAP ('callback') pinned, so that both matchers' `host
     matching` ms a step are printed; the tiny card-against-CPU step pins
     'callback' on both sides;
  9b. training at 1600x800 (phase_train_1600): ToC3D_faster_1600 at full
     width and depth, batch 2 of 6 views at 1600x800: A, B (ws 16) and C
     at every (ws, ratio) at the step's shapes, 12 views (60000 rows) and
     the default view scan's chunks of 2, each against its plain version
     at the kernel bounds and timed (rows "A train1600 x12", ...); one
     step under the default policy (the view scan on, a view a chunk)
     with the counts set to 0 just before it and read just after (A 6, B
     6, C 108, D 0, G 456, LN 342, AU 7) and its device memory by stage;
     13 more steps with finite, falling losses and no skip (steps/s,
     samples/s, peak memory, ms a step by stage); the backbone's own
     peak in each regime; then view scan off, a chunk of 3 views and attn
     chunk 32 unscanned, each with its launches (view scan off and attn
     chunk 32: A 1, B 1, C 18; chunk 3: A 2, B 2, C 36), peak memory and
     steps/s, an out-of-memory error of these three printed as that
     regime's result; last 2 default steps under the profiler and 3
     timed after it; prints the phase's seconds;
 10. matchers and closed loop (phase_traineval): the auction kernel
     (csrc/auction.cu) against its plain version, torch.equal, at JAX's
     test sizes (tests/test_auction.py, tests/test_auction_scale.py: Q 900,
     G 8 / 32 / 96, padding, near ties) and on the ToC3D_faster step's real
     cost tensors (six (2, 900, 32), one (12, 1000, 32)), each within
     JAX's bound of the native LAP's optimum with no query twice; the
     step's tensors timed (kernel, plain, native LAP with its copies,
     bound); the closed loop (tools.traineval, tiny, 150 iterations,
     resumed at 75, evaluated at 0 and 150): resumed, finite metrics in
     [0, 1], the loss's last 5 below 0.7 of its first 5;
 11. multi-GPU (phase_parallel; the card's machine has one H100): world
     size 1 over NCCL in this process (a FileStore rendezvous): one
     data-parallel step of ToC3D_faster at 800x320, batch 2, its lanes
     with unequal box counts (dp_train_batch; make_train_step with the
     process group: normalizer counts summed
     over the ranks, gradients averaged in 25 MB buckets) against the
     plain step from the same weights, batch and noise, both under
     deterministic algorithms, bit for bit in losses, grad_norm,
     gradients, parameters and bank; the all-reduce's ms a step (CUDA
     events) and the DP steps/s beside phase_train's; the view-sharded
     ToC3D_faster_1600 stream (parallel/infer_spmd, the all-gather
     between the captured programs) for 3 frames in bf16 and int8 dynamic
     against make_infer_fn bit for bit with the main path's launches a
     frame; then two spawned ranks sharing the card over gloo: the DP
     step at batch 1 a rank against one process at batch 2 (within the
     bounds DP_BATCH2_TOL states, measured on the card, with the routing
     flips between the two counted) and against each lane stepped alone
     in one process, normalized by the global batch's counts and the
     world size (bit for bit), the ranks' parameters equal, and the
     view-sharded frame at 3 views a rank against make_infer_fn bit for
     bit, with A 1, B 6, C 18, D 12 a frame on each rank; prints the phase's wall time and the nvidia-smi
     line;
 12. report: a {"kernels": [...]} JSON line (each row's "op": the
     toc3d:: custom op it runs as, null for G, G8, LN and AU, which run
     inside the ops or in training; the auction's row adds lap_ms, the
     native LAP's time; no PyTorch call solves an assignment, so its
     library_ms is null), the nvidia-smi line, and last
     {"ok": true, "device": {...}}.
The kernels' plain versions compute in f32 (TF32 off for matmuls and
convolutions).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores

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


def graph_time(fn, reps: int = 20, replays: int = 10) -> float:
    """Device ms per call of fn: ``reps`` calls captured in one CUDA graph
    and replayed ``replays`` times, so that launches follow each other as
    in the captured frame, with no host launch cost (a small kernel's eager
    time is the host's); a call that allocates takes the graph's pool."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * reps)


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
    from toc3d_tpu_torch import native
    from toc3d_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    times = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in times.items())})")
    t0 = time.perf_counter()
    native.get_lap_lib()
    log(f"build: native LAP {native.library_path().name} "
        f"{time.perf_counter() - t0:.1f} s")
    for name in times:
        logf = build.BUILD_DIR / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    log(f"  ptxas {name}: {line.strip()}")
    # window attention at d = 64 and 32, each body: one persistent block
    # an SM whose ring holds ceil(n / 64) slots of a window of n rows
    # (B: 256, 400 rows; C: kr = k + 1 at ratios .5 / .4 / .3)
    occ = {f"d {d} {body}": build.occupancy(
        "vit_block", "toc3d_window_attention_occupancy", d, one)
        for d in (64, 32) for body, one in (("one-pass", 1), ("two-pass", 0))}
    slots = build.occupancy("vit_block", "toc3d_window_attention_slots", 64)
    log(f"resident blocks per SM: window attention {occ}, ring of {slots} "
        f"slots at d 64, slots a window by rows "
        f"{ {n: -(-n // 64) for n in (256, 400, 201, 128, 103, 77, 161, 121)} }"
        f"; flash partial (d 32) "
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


def check_flash(kv, g, reps=20, nq=900, b=1, graphed=False):
    """Kernel D on q (b,nq,256) against k/v (b,kv,256), 8 heads, against
    its plain version, timed beside SDPA and the bound: eagerly (CUDA
    events), or with ``graphed`` by graph replay (graph_time), as a call
    too small for its eager time to be the card's is. Returns
    (ok, entry)."""
    import torch
    from toc3d_tpu_torch.ops.cuda import cross_attn
    dev = torch.device("cuda")
    bf = torch.bfloat16
    hd = 8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q = (torch.randn(b, nq, 256, device=dev, generator=g)
         * (3 * 32 ** -0.5)).to(bf)
    k = torch.randn(b, kv, 256, device=dev, generator=g).to(bf)
    v = torch.randn(b, kv, 256, device=dev, generator=g).to(bf)
    splits, per = cross_attn.flash_splits(nq, kv, hd, b, sms)
    blocks = -(-nq // cross_attn.QUERY_TILE) * hd * splits * b
    ok, err = compare(f"D flash q ({b},{nq},256) k/v ({b},{kv},256), "
                      f"{splits} splits of {per} key tiles, {blocks} blocks "
                      f"on {sms} SMs",
                      cross_attn.flash_attention_core(q, k, v, hd),
                      cross_attn.flash_attention_plain(q, k, v, hd))
    sh = lambda t: t.reshape(b, -1, hd, 32).transpose(1, 2)
    b_ms, b_by = bound(4 * b * nq * kv * 256,
                       b * (nq * 2 + kv * 2) * 256 * 2)
    timed = graph_time if graphed else cuda_time
    entry = dict(
        shape=f"q ({b},{nq},256) k/v ({b},{kv},256) bf16, 8 heads",
        max_abs_err=err,
        ms=timed(lambda: cross_attn.flash_attention_core(q, k, v, hd),
                 reps),
        plain_ms=timed(lambda: cross_attn.flash_attention_plain(
            q, k, v, hd), 3),
        library_ms=timed(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                sh(q), sh(k), sh(v), scale=1.0), reps),
        bound_ms=b_ms, bound_by=b_by)
    log(f"time D kv{kv}{' (graph replay)' if graphed else ''}: "
        f"{json.dumps(entry)}")
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


def pad_rows(ws, ratio, h=50, w=100):
    """The rows of LN(0) a full block runs through LN1 and the QKV GEMM
    beyond its tokens (ops/cuda/vit_block._full_attention): one a window
    place where windows pass the (h, w) map's edge."""
    return ws * ws if ratio is None and (h % ws or w % ws) else 0


def ln_sites(cfg, b=6, h=50, w=100):
    """The LayerNorm call sites of every block shape of the backbone on a
    (b, h, w) patch map: {name: (x rows, output rows, n, npad, residual)}.
    B: LN1 with its LN(0) rows, LN2, the SwiGLU sub-LN on the gate output's
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
        sites[f"LN1 {kind}"] = (rows, rows + pad_rows(ws, r, h, w), c, c,
                                False)
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
    and C and the row quantization of B8 / C8's proj_in site and of the
    head's 30000 image tokens (the input of H8's oracle, the old tile),
    timed beside their bounds (check_qkv_handoff for the attention and the
    QKV epilogue that feeds it), and the per-frame bounds of the three
    families."""
    import torch
    import torch.nn.functional as F
    from toc3d_tpu_torch.models.eva_vit import make_rope_tables, rope_tensors
    from toc3d_tpu_torch.ops.cuda import build, int8, vit_block
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
            total += (ln_bytes(rows, rows + pad_rows(ws, r), c, c, False,
                               mode)
                      + ln_bytes(rows, rows, c, c, not full, mode)
                      + ln_bytes(rows, rows, hid, hp, False, mode))
        log(f"LayerNorm family bound per frame, {mode}: "
            f"{total / PEAK_BYTES * 1e3:.5f} ms ({total / 1e9:.4f} GB, "
            f"{3 * len(blocks)} launches)")
    wa_ms = {"bytes": 0.0, "operations": 0.0}
    rq_ms = 0.0
    for nw, n, rows, ws, r in blocks:
        wa_ms["bytes"] += rows * c * (3 * 2 + 2) / PEAK_BYTES * 1e3
        wa_ms["operations"] += 4 * nw * n * n * c / PEAK_BF16_FLOPS * 1e3
        rq_ms += rows * (c * 3 + 4) / PEAK_BYTES * 1e3
    log(f"window attention family bound per frame: bytes "
        f"{wa_ms['bytes']:.5f} ms, operations {wa_ms['operations']:.5f} ms "
        f"(24 launches); row quantization of the blocks' proj_in sites per "
        f"int8 frame: {rq_ms:.5f} ms (24 launches, dynamic)")

    ok_all &= check_qkv_handoff(cfg, g)

    # row quantization alone: the proj_in site of B8 / C8, and the decoder's
    # 30000 image tokens of width 256 (H8 quantizes inside its own kernel;
    # row quantization there feeds its oracle, the mma.sync tile)
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


def rope2_bf16(v, rope, tr):
    """bf16 of the kernels' rope2 on the f32 (rows, 3C) v at table rows tr
    (tests/test_torch_cuda.py's restatement): each pair (a, b) of q and k
    goes to fma(a, c0, fl(-b s0)) and fma(b, c1, fl(a s1)), v as it is."""
    import torch
    rows, c3 = v.shape
    cos, sin = (t[tr].double().reshape(rows, 1, -1, 2) for t in rope)
    qk = v[:, :2 * c3 // 3].double().reshape(rows, -1, cos.shape[2], 2)
    a, b = qk[..., 0], qk[..., 1]
    na = (a * cos[..., 0] + (-b * sin[..., 0]).float().double()).float()
    nb = (b * cos[..., 1] + (a * sin[..., 1]).float().double()).float()
    qk = torch.stack([na, nb], -1).reshape(rows, -1)
    return torch.cat([qk.to(torch.bfloat16),
                      v[:, 2 * c3 // 3:].to(torch.bfloat16)], 1)


def parent_window_attention(tree):
    """The window attention entry point of another checkout of this repo
    (a tree whose kernel still reads the f32 q / k / v and the RoPE tables:
    qkv, pos, cos, sin, out, nw, n, heads, head_dim, image, B, H, W, ws,
    one_pass, stream), compiled from <tree>/toc3d_tpu_torch/csrc into
    build/kernels/ with the port's flags."""
    import ctypes
    import hashlib
    from pathlib import Path
    from toc3d_tpu_torch.ops.cuda import build
    src = Path(tree) / "toc3d_tpu_torch" / "csrc"
    h = hashlib.sha256(b"".join((src / f).read_bytes() for f in
                                ("vit_block.cu",) + build.HEADERS))
    out = build.BUILD_DIR / f"libparent_vit_block-{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                            str(out), str(src / "vit_block.cu")],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}")
    fn = ctypes.CDLL(str(out)).toc3d_window_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_qkv_handoff(cfg, g, parent=None):
    """The QKV hand-off at the kernel table's shapes (B ws 16 / 20; C ws 16
    / 20 ratio .5, ws 16 ratio .3, each with the representative row):
    kernel G's QKV epilogue (bf16 q / k / v, RoPE applied; and G8's) bit
    for bit bf16(rope2(the f32 epilogue's output)), timed beside the f32
    epilogue that fed the window attention before it; the window attention
    on that output, each body, timed beside SDPA on windowed q / k / v and
    the bound (q / k / v read in bf16); with ``parent``, a checkout whose
    kernel reads the f32 output and applies RoPE in its producer, that
    kernel on the f32 output, timed and bit for bit against the new
    outputs, and the two paths' sums."""
    import torch
    import torch.nn.functional as F
    from toc3d_tpu_torch.models.eva_vit import make_rope_tables, rope_tensors
    from toc3d_tpu_torch.ops.cuda import build, int8, vit_block
    from toc3d_tpu_torch.ops.cuda.build import stream_of
    dev, bf = torch.device("cuda"), torch.bfloat16
    c, heads = cfg.embed_dim, cfg.num_heads
    d = c // heads
    old = parent_window_attention(parent) if parent else None
    win, glb = make_rope_tables(cfg)
    tabs = {cfg.window_size: rope_tensors(win, dev),
            cfg.global_window_size: rope_tensors(glb, dev)}
    scores = torch.randn(6, 5000, device=dev, generator=g).to(bf)
    w = (torch.randn(3 * c, c, device=dev, generator=g) * c ** -0.5).to(bf)
    bias = torch.randn(3 * c, device=dev, generator=g) * 0.1
    wq = torch.randint(-127, 128, (3 * c, c), device=dev, generator=g,
                       dtype=torch.int8)
    sc = torch.rand(3 * c, device=dev, generator=g) * 1e-3 + 1e-4
    ok_all = True
    sums = {}
    for ws, ratio in ((cfg.window_size, None), (cfg.global_window_size, None),
                      (cfg.window_size, cfg.token_ratio[0]),
                      (cfg.global_window_size, cfg.token_ratio[0]),
                      (cfg.window_size, cfg.token_ratio[-1])):
        nw, n, rows = block_rows(cfg, ws, ratio)
        image = ratio is None
        rope = tuple(t[:ws * ws].float().contiguous() for t in tabs[ws])
        pos = None
        m = rows + (ws * ws if image else 0)   # the map passes the windows
        if not image:
            plan = vit_block.compress_plan(scores, 6, 50, 100, ws, ratio,
                                           True, cfg.mxu_align_k)
            pos = torch.cat([plan.slow_idx, torch.full_like(
                plan.slow_idx[:, :1], plan.k)], 1).to(torch.int32)
            pos = pos.contiguous()
        tr = vit_block.qkv_table_rows(m, pos, (6, 50, 100), ws).to(dev)
        kw = dict(rope=rope, pos=pos, map_shape=(6, 50, 100), ws=ws)
        hin = torch.randn(m, c, device=dev, generator=g).to(bf)
        aq = torch.randint(-127, 128, (m, c), device=dev, generator=g,
                           dtype=torch.int8)
        xs = torch.rand(m, device=dev, generator=g) * 0.01 + 1e-3
        if image:   # the pad rows are one row (LN(0)), as in the block
            for t in (hin, aq, xs):
                t[rows:] = t[rows]
        f32 = {False: torch.empty(m, 3 * c, device=dev),
               True: torch.empty(m, 3 * c, device=dev)}
        q16 = {False: torch.empty(m, 3 * c, dtype=bf, device=dev),
               True: torch.empty(m, 3 * c, dtype=bf, device=dev)}
        runs = {
            False: (lambda: vit_block.gemm_bf16(hin, w, bias, out_f32=True,
                                                out=f32[False]),
                    lambda: vit_block.gemm_qkv(hin, w, bias, out=q16[False],
                                               **kw)),
            True: (lambda: int8.gemm_s8_sm90(aq, xs, wq, sc, bias,
                                             out_f32=True, out=f32[True]),
                   lambda: vit_block.gemm_qkv(aq, wq, bias, xs=xs, scales=sc,
                                              out=q16[True], **kw))}
        out = torch.empty(rows, c, dtype=bf, device=dev)
        out_old = torch.empty(rows, c, dtype=bf, device=dev)
        qs, ks, vs = (torch.randn(nw, heads, n, d, device=dev,
                                  generator=g).to(bf) for _ in range(3))
        b_ms, b_by = bound(4 * nw * n * n * c, rows * c * (3 * 2 + 2))
        tag = f"{'B' if image else 'C'} ws {ws}" + (
            "" if image else f", ratio {ratio}")
        for s8 in (False, True):
            one_pass = not s8
            run_f32, run_qkv = runs[s8]
            run_f32()
            run_qkv()
            same = torch.equal(q16[s8], rope2_bf16(f32[s8], rope, tr))
            ok_all &= same

            def attn(one_pass=one_pass, s8=s8):
                return vit_block.window_attention_launch(
                    q16[s8], out, (6, 50, 100), ws, nw, n, heads, image,
                    one_pass=one_pass)

            def attn_old(one_pass=one_pass, s8=s8):
                ptr = lambda t: None if t is None else t.data_ptr()
                rc = old(f32[s8].data_ptr(), ptr(pos), rope[0].data_ptr(),
                         rope[1].data_ptr(), out_old.data_ptr(), nw, n,
                         heads, d, int(image), 6, 50, 100, ws,
                         int(one_pass), stream_of(out_old))
                assert rc == 0, rc
            entry = dict(shape=f"{tag}: {nw} windows x {n} rows, "
                               f"{'G8' if s8 else 'G'} QKV ({m},{3 * c}), "
                               f"{'two' if s8 else 'one'}-pass body",
                         qkv_bf16_equal_rope2_of_f32=same,
                         qkv_ms=cuda_time(run_qkv, 20),
                         qkv_f32_ms=cuda_time(run_f32, 20),
                         ms=cuda_time(attn, 20),
                         library_ms=cuda_time(
                             lambda: F.scaled_dot_product_attention(
                                 qs, ks, vs, scale=1.0), 20),
                         bound_ms=b_ms, bound_by=b_by,
                         blocks_per_sm=build.occupancy(
                             "vit_block",
                             "toc3d_window_attention_occupancy", d,
                             int(one_pass)))
            entry["path_ms"] = entry["qkv_ms"] + entry["ms"]
            if old is not None:
                attn()
                attn_old()
                torch.cuda.synchronize()
                entry["equal_to_parent"] = torch.equal(out, out_old)
                ok_all &= entry["equal_to_parent"]
                entry["parent_ms"] = cuda_time(attn_old, 20)
                entry["parent_path_ms"] = entry["qkv_f32_ms"] + \
                    entry["parent_ms"]
                entry["ms_again"] = cuda_time(attn, 20)
            for k in ("path_ms", "parent_path_ms"):
                if k in entry:
                    sums[(s8, k)] = sums.get((s8, k), 0.0) + entry[k]
            log(f"time qkv hand-off: {json.dumps(entry)}")
        del f32, q16, hin, aq, out, out_old, qs, ks, vs
    named = {("int8 " if s8 else "bf16 ") + k: v for (s8, k), v in
             sums.items()}
    log(f"qkv hand-off sums over the five shapes: {json.dumps(named)}")
    return ok_all


def phase_kernels_int8(model, results):
    """Check and time B8 and C8 at every main-path shape, with per-row
    (dynamic) activation scales and with static site scales (calibrated on
    the same input by the plain probes of ops/int8_calib), and the head's
    int8 linear H8 at its five main-path shapes (check_h8)."""
    import torch
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
    return check_h8(model, results) and ok_all


# kernel H8's five main-path shapes (ToC3D_faster_1600 in int8: 6 decoder
# layers, 900 queries, 768 memory entries, 6 x 50 x 100 image tokens, width
# 256, FFN 2048): name -> (rows, in, out, launches a frame, the decoder
# layer's linear that has the shape)
H8_SHAPES = {
    "S1": (900, 256, 256, 24, "self q (and self o, cross q, cross o)"),
    "S2": (1668, 256, 256, 12, "self k (and self v)"),
    "S3": (30000, 256, 256, 12, "cross k (and cross v)"),
    "S4": (900, 256, 2048, 6, "FFN in"),
    "S5": (900, 2048, 256, 6, "FFN out"),
}
H8_FRAME_BOUND_MS = 0.1405   # the five shapes' bounds, launches a frame


def h8_bytes(m, k, n):
    """What H8 must move for x (m, k) @ w (n, k)^T: x and y in bf16, the
    int8 weight, the f32 channel scales and bias."""
    return m * k * 2 + n * k + m * n * 2 + n * 8


def check_h8(model, results):
    """Kernel H8 at its five main-path shapes with the first decoder layer's
    weights (seeded random) on seeded random bf16 rows spanning three
    decades: bit for bit (torch.equal) against its plain version and
    against the old two launches (row quantization, then the mma.sync tile
    with the head's epilogue); timed as CUDA-graph replays (the small
    shapes' eager calls measure the host) beside the old tile, its plain
    version (eager), torch._int_mm (_lib_qmm, a graph) and its bound, with
    each shape's launches a frame; the per-frame sums against the 0.1405 ms
    bound; the graph's floor for one launch (an empty kernel's replay)."""
    import torch
    from toc3d_tpu_torch.layers import quantize_linear
    from toc3d_tpu_torch.ops.cuda import int8
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    layer = model.pts_bbox_head.transformer.decoder.layers[0]
    sa, ca = layer.attentions[0].attn, layer.attentions[1].attn
    lins = {"S1": (sa.in_proj_weight[:256], sa.in_proj_bias[:256]),
            "S2": (sa.in_proj_weight[256:512], sa.in_proj_bias[256:512]),
            "S3": (ca.in_proj_weight[256:512], ca.in_proj_bias[256:512]),
            "S4": (layer.ffns[0].layers[0][0].weight,
                   layer.ffns[0].layers[0][0].bias),
            "S5": (layer.ffns[0].layers[1].weight,
                   layer.ffns[0].layers[1].bias)}
    floor = graph_time(lambda: torch.cuda._sleep(0), 50)
    log(f"H8: the graph's floor for one launch (an empty kernel's replay): "
        f"{floor:.6f} ms")
    ok_all, rows, err = True, [], 0.0
    frame = dict(ms=0.0, old_ms=0.0, plain_ms=0.0, library_ms=0.0)
    for name, (m, k, n, per_frame, what) in H8_SHAPES.items():
        x = (torch.randn(m, k, device=dev, generator=g)
             * torch.logspace(-2, 1, m, device=dev)[:, None]).to(
                 torch.bfloat16)
        p = quantize_linear(*lins[name])
        plan = int8.h8_plan(m, n, k, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        out = int8.int8_linear(x, p)
        ref = int8.int8_linear_plain(x, p)
        old = int8.gemm_s8(*int8.row_quant(x), p.w, p.scale, p.bias,
                           head=True)
        torch.cuda.synchronize()
        eq_plain, eq_old = torch.equal(out, ref), torch.equal(out, old)
        ok_all &= eq_plain and eq_old
        e = (out.float() - ref.float()).abs().max().item()
        err = max(err, e)
        b_ms, b_by = bound_int8(2 * m * k * n, 0, h8_bytes(m, k, n))
        row = dict(
            shape=f"{name} x ({m},{k}) bf16 -> {n}: {what}",
            launches_per_frame=per_frame,
            plan=f"BN {plan.bn}, grid {plan.grid}, tiles {plan.tiles}",
            equal_to_plain=eq_plain, equal_to_old_tile=eq_old,
            max_abs_err=e,
            ms=graph_time(lambda: int8.int8_linear(x, p)),
            old_ms=graph_time(lambda: int8.gemm_s8(
                *int8.row_quant(x), p.w, p.scale, p.bias, head=True)),
            plain_ms=cuda_time(lambda: int8.int8_linear_plain(x, p), 3),
            library_ms=graph_time(lambda: _lib_qmm(x, p.w, p.scale,
                                                    p.bias)),
            bound_ms=b_ms, bound_by=b_by)
        row["of_bound"] = b_ms / row["ms"]
        for key in frame:
            frame[key] += per_frame * row[key]
        rows.append(row)
        log(f"{'check' if eq_plain and eq_old else 'FAIL'} H8 {name}: "
            f"{json.dumps(row)}")
    bound_sum = sum(f * bound_int8(2 * m * k * n, 0, h8_bytes(m, k, n))[0]
                    for m, k, n, f, _ in H8_SHAPES.values())
    if abs(bound_sum - H8_FRAME_BOUND_MS) > 5e-5:
        log(f"FAIL H8: the per-frame bound {bound_sum} is not "
            f"{H8_FRAME_BOUND_MS} ms")
        ok_all = False
    frame["bound_ms"] = bound_sum
    log(f"H8 per frame (60 launches): {json.dumps(frame)}; the old tile's "
        f"two launches {frame['old_ms']:.6f} ms")
    s3 = rows[2]
    results["H8"] = dict(
        name="int8_linear", route="cuda",
        source="toc3d_tpu_torch/csrc/int8_linear.cu",
        replaces="toc3d_tpu/layers.py:110",
        shape=s3["shape"] + " (the row's times; shapes: all five)",
        max_abs_err=err, ms=s3["ms"], plain_ms=s3["plain_ms"],
        library_ms=s3["library_ms"], bound_ms=s3["bound_ms"],
        bound_by=s3["bound_by"], shapes=rows, frame=frame,
        graph_floor_ms=floor)
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
    QKV GEMM runs at B's tokens plus its LN(0) rows, or at C's rows; G and G8
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
                out["gemm"].setdefault((c, hid), set()).add(
                    rows + pad_rows(ws, r, h, w))
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


KERNELS = ("A", "B", "C", "D", "B8", "C8", "H8", "G", "G8", "LN", "AU", "W1",
           "W2", "conv", "qkv")


def counters():
    """The launch-counting wrapper of each kernel, in KERNELS order, read by
    name from counted_wrappers (G: vit_block._gemm, under gemm_bf16 and
    every bf16 matmul of B and C, not A's product; G8: int8.gemm_s8_sm90,
    every weight matmul of B8 and C8; LN: vit_block.layernorm, every launch
    of the LayerNorm kernel, three a block; W1 / W2: the window attention's
    one-pass body, one launch a B or C, and its two-pass body, one a B8 or
    C8; conv: the packed convolutions, two a ViT frame in the neck, none in
    training, which runs the neck on per-call casts; qkv: the QKV epilogue,
    one a window attention launch)."""
    from toc3d_tpu_torch.ops.cuda import counted_wrappers
    wrappers = counted_wrappers()
    return [wrappers[k] for k in KERNELS]


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
                    per_frame=(1, 6, 18, 12, 0, 0, 0, 96, 0, 72, 0, 24, 0, 2,
                               24),
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
    steady_ms = lambda ms: sum(ms[2:]) / len(ms[2:])
    results.setdefault("paths", {})[f"{name} {label}"] = dict(
        eager_ms=steady_ms(eager_ms), captured_ms=steady_ms(graph_ms),
        eager_peak_gib=eager_peak, captured_peak_gib=graph_peak)
    for run, ms, peak, calls in (("eager infer_step", eager_ms, eager_peak,
                                  calls_e),
                                 ("captured make_infer_fn", graph_ms,
                                  graph_peak, calls_g)):
        log(f"main path {name} {label}, {run}, {len(frames)} x {w}x{h} "
            f"uint8 host frames, batch 1: frame ms "
            f"{[round(t, 3) for t in ms]}; steady mean "
            f"{steady_ms(ms):.3f} ms/frame over frames 2-"
            f"{len(frames) - 1}; peak memory {peak:.3f} GiB; one more steady "
            f"frame: {calls}")
    log(f"main path {name} {label}: launches {'/'.join(KERNELS)} "
        f"{launches}; selector runs (eager) {len(ran)}; captured equals "
        f"eager per frame {equal}; finite {finite} shapes {shapes}; "
        f"weight-key check {key_us:.1f} us a call")
    return ok, dets


MAIN_PER_FRAME = (1, 6, 18, 12, 0, 0, 0, 96, 0, 72, 0, 24, 0, 2, 24)
INT8_PER_FRAME = (1, 0, 0, 12, 6, 18, 60, 0, 96, 72, 0, 0, 24, 2, 24)


def phase_eval(name="ToC3D_faster_1600", scenes=2, frames_per_scene=6,
               views=6, src=(900, 1600), device="cuda",
               per_frame=MAIN_PER_FRAME):
    """The streaming eval end to end (toc3d_tpu_torch.tools.test's main, in
    this process) on learnable synthetic scenes written as JPEGs (scenes x
    frames_per_scene samples of ``views`` src views), at the full width and
    depth of ``name`` with seeded random weights, through the captured
    frame: the exact path (float32 frames normalized on the host, PIL
    decode) and --fast-decode (uint8 frames normalized on the card), two
    dtypes of the image buffer and so two captures. Each CLI run is driven
    with the counts set to 0 just before it and read just after; each must
    launch ``per_frame`` of each kernel a frame. Holds: the submission
    equals, byte for byte, the one streaming_eval builds from eager
    infer_step on the same frames and weights; every sample token is in
    it; mAP and NDS (nusc_metrics) and the tracker's AMOTA (tools.track
    --eval) are finite and in [0, 1]. Prints the readers, eval frames/s over
    the frames after the captures and the prefetch queue's fill, the host
    ms to build a frame and the card ms a frame by stage (the stage timer)."""
    import gc
    import tempfile
    import PIL
    import torch
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.configs.presets import served_in_bf16
    from toc3d_tpu_torch.data import loader
    from toc3d_tpu_torch.data.nuscenes import NuScenesInfos
    from toc3d_tpu_torch.data.synthetic import make_learnable_dataset
    from toc3d_tpu_torch.models.detector import (build_detector,
                                                 eager_infer_fn, init_state)
    from toc3d_tpu_torch.runtime.eval import streaming_eval, write_submission
    from toc3d_tpu_torch.tools import test as eval_cli
    from toc3d_tpu_torch.tools import track as track_cli
    if loader._has_cv2():
        import cv2
        fast_reader = f"cv2 {cv2.__version__} imread (reduced decode)"
    else:
        fast_reader = f"PIL {PIL.__version__} draft"
    log(f"eval readers: exact path PIL {PIL.__version__} (Image.open, "
        f"convert RGB, resize, crop); --fast-decode {fast_reader}")
    cfg = get_config(name)
    if device == "cuda" and cfg.compute_dtype != "bfloat16":
        cfg = served_in_bf16(cfg)
    aug = eval_cli.eval_aug(cfg, *src)
    ok = True
    with tempfile.TemporaryDirectory(prefix="toc3d_eval_") as tmp:
        t0 = time.perf_counter()
        ann = make_learnable_dataset(
            f"{tmp}/data", n_scenes=scenes, frames_per_scene=frames_per_scene,
            n_cams=views, src_h=src[0], src_w=src[1], seed=0)
        infos = NuScenesInfos(ann)
        n = len(infos)
        tokens = [i["token"] for i in infos.infos]
        log(f"eval data: {scenes} scenes x {frames_per_scene} frames x "
            f"{views} views of {src[1]}x{src[0]} JPEGs (learnable synthetic "
            f"scenes, seed 0) written in {time.perf_counter() - t0:.1f} s; "
            f"{name} at {cfg.pad_shape[1]}x{cfg.pad_shape[0]}")
        steps = eval_host_steps(infos, aug)
        log(f"eval host steps, ms a frame ({views} views, each step alone on "
            f"one thread of {os.cpu_count()} cores): "
            + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()))
        eager = None
        for tag, fast in (("exact", False), ("fast", True)):
            argv = ["--config", name, "--ann", ann, "--work-dir",
                    f"{tmp}/{tag}", "--speed-test", "--device", device,
                    "--src-h", str(src[0]), "--src-w", str(src[1])]
            for f in counters():
                f.launches = 0
            out = eval_cli.main(argv + ["--fast-decode"] * fast)
            launches = [f.launches for f in counters()]
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
            counts_ok = launches == [k * n for k in per_frame]
            if eager is None:
                eager = eager_infer_fn(build_detector(cfg, device=device,
                                                      seed=0))
            pairs = [loader.build_eval_frame(infos, i, aug, fast_decode=fast,
                                             device_normalize=fast)
                     for i in range(n)]
            dtype = pairs[0][0]["img"].dtype
            ref = streaming_eval(eager, lambda: init_state(1, cfg,
                                                           device=device),
                                 [p[0] for p in pairs],
                                 [p[1] for p in pairs], progress_every=0)
            del pairs
            with open(out["path"], "rb") as f:
                sub = f.read()
            with open(write_submission(ref, f"{tmp}/{tag}_eager"), "rb") as f:
                same = sub == f.read()
            m = out["metrics"]
            trk = track_cli.main(["--results", out["path"], "--ann", ann,
                                  "--work-dir", f"{tmp}/{tag}_track",
                                  "--eval", "--device", device])["metrics"]
            scores = [m["mAP"], m["NDS"], trk["AMOTA"]]
            metrics_ok = all(math.isfinite(v) and 0.0 <= v <= 1.0
                             for v in scores)
            present = list(out["results"]) == tokens
            boxes = sum(map(len, out["results"].values()))
            ok &= counts_ok and same and metrics_ok and present
            # throughput after the captures (frames 0, 1) and the frames
            # the prefetch queue (depth 2, one more in the worker) filled
            # meanwhile
            k0 = min(5, n - 2)
            done = out["done_at"]
            fps = (n - 1 - k0) / (done[-1] - done[k0])
            # a frame's top-level spans (a child's time is in its parent)
            stage = {k: v[2:] for k, v in out["stage_ms"].items()
                     if "/" not in k}
            card = [sum(x) for x in zip(*stage.values())]
            build = out["build_ms"]
            log(f"eval {tag} ({dtype} frames{', normalized on the card' if fast else ''}), "
                f"{n} samples: launches {'/'.join(KERNELS)} {launches} "
                f"(expected {per_frame} x {n}) {'ok' if counts_ok else 'FAIL'}; "
                f"captured submission equals eager infer_step's byte for "
                f"byte {same}; all {len(tokens)} tokens {present}, {boxes} "
                f"boxes; mAP {m['mAP']:.6g} NDS {m['NDS']:.6g} AMOTA "
                f"{trk['AMOTA']:.6g} (random weights) "
                f"{'ok' if metrics_ok else 'FAIL'}")
            log(f"eval {tag}: {fps:.4f} frames/s over frames {k0}-{n - 1} "
                f"({1e3 / fps:.3f} ms/frame); host build ms/frame mean "
                f"{sum(build) / len(build):.3f} (min {min(build):.3f}, max "
                f"{max(build):.3f}, one prefetch thread); card ms/frame "
                f"over frames 2-{n - 1} by the stage timer: "
                + ", ".join(f"{k} {sum(v) / len(v):.3f}"
                            for k, v in stage.items())
                + f", total {sum(card) / len(card):.3f}; loop wall after each "
                f"frame (s) {[round(t, 3) for t in done]}")
        del eager
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return ok


def eval_host_steps(infos, aug, index=0, reps=3) -> dict:
    """ms a frame of each host step of build_eval_frame (data/loader.py) for
    sample ``index``, both paths, each step timed alone on this thread,
    mean of ``reps``."""
    import numpy as np
    from toc3d_tpu_torch.data import loader
    from toc3d_tpu_torch.data import nuscenes as nus
    paths = infos.frame_meta(index)["img_paths"]
    _, dims, crop, flip = nus.sample_augmentation(aug, training=False)
    steps = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        steps[name] = steps.get(name, 0.0) + (
            time.perf_counter() - t0) * 1e3 / reps
        return out
    fill = np.round(nus.IMG_NORM_MEAN)
    for _ in range(reps):
        imgs, fast = [], []
        for p in paths:
            img = timed("exact decode", loader._load_image_bgr, p)
            img = timed("exact resize+crop", nus.transform_image, img, dims,
                        crop, flip)
            img = timed("exact normalize", nus.normalize_image, img)
            imgs.append(timed("exact pad", nus.pad_to_multiple, img, 32))
            img = timed("fast decode+crop", loader._load_transform_fast, p,
                        dims, crop, flip)
            fast.append(timed("fast pad", nus.pad_to_multiple, img, 32,
                              fill))
        timed("exact stack+cast", lambda: np.stack(imgs)[None].astype(
            np.float32))
        timed("fast stack", lambda: np.stack(fast)[None])
    return steps


def phase_bench_fps(name="ToC3D_faster_1600"):
    """The bench's frames/s of ``name`` (toc3d_tpu_torch.bench, its default
    protocol: 200 warm-up and 100 timed uint8 frames in pinned memory,
    captured), in this process, beside the eval's."""
    import contextlib
    import io
    from toc3d_tpu_torch import bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--config", name])
    run = bench.parse_run(buf.getvalue())
    if rc != 0 or run is None:
        log(f"bench {name}: FAILED (exit {rc})\n{buf.getvalue()[-2000:]}")
        return False
    log(f"bench {name} (same process): {run['fps']} frames/s, {run['ms']} "
        f"ms/frame, peak {run['peak_gib']} GiB")
    return True


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
    per_frame = INT8_PER_FRAME
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
             (1, 24, 0, 12, 0, 0, 0, 96, 0, 72, 0, 24, 0, 2, 24)),
            ("stream_petr_eva_vit_l_1600", "int8 dynamic", 6, 0,
             (1, 0, 0, 12, 24, 0, 60, 0, 96, 72, 0, 0, 24, 2, 24)),
            ("ToC3D_fast", "bf16", 3, 3,
             (1, 6, 18, 12, 0, 0, 0, 96, 0, 72, 0, 24, 0, 2, 24)),
            ("ToC3D_vit_b_faster", "bf16", 3, 3,
             (1, 3, 9, 12, 0, 0, 0, 48, 0, 36, 0, 12, 0, 2, 12)))
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


# the new row of the kernels line: kernel D at the DN head's self-attention
# (q 900, k 900); the main path launches D at 30000 and 1668 keys only
D900_ROW = "D kv900"
# frames of each selector's run in phase_alt_modules: the steady mean is
# over frames 2 on, after the first frame and the steady program's capture
ALT_FRAMES = 10
# bf16 against f32 of VoVNet V-99-eSE: twice the kernel tolerance, as it
# stacks 99 bf16 convolutions (2 x 128 x 256 on the CPU: max 0.0105 and
# mean 0.0042 of the f32 run's max and mean |value|). ViTSimpleFPN (two
# to three convolutions), and the DN head and the encoder with kernel D
# against the same call with a plain f32 attention core, are held to the
# kernel tolerance itself.
VOVNET_TOL_SCALE = 2.0


@contextlib.contextmanager
def attention_core(fn):
    """ops.attention.mha's attention core (kernel D's differentiable
    wrapper) replaced by fn(q, k, v, heads) inside the block, for the
    checks only."""
    from toc3d_tpu_torch.ops import attention
    orig = attention.flash_attention
    attention.flash_attention = fn
    try:
        yield
    finally:
        attention.flash_attention = orig


def plain_f32_core(q, k, v, heads):
    """The attention core in f32 (flash_attention_plain on f32 inputs: no
    bf16 rounding of the probabilities), cast back to v's dtype."""
    from toc3d_tpu_torch.ops.cuda.cross_attn import flash_attention_plain
    return flash_attention_plain(q.float(), k.float(), v.float(),
                                 heads).to(v.dtype)


def _against_plain_core(tag, run, keys):
    """run() with kernel D and again with plain_f32_core: launches of D in
    the first, the key count of each core call, and each of ``keys`` of the
    outputs (a dict, or one tensor) against the plain run at the kernel
    tolerance. Returns (ok, kernel outputs, launches, key counts, ms
    of the kernel run)."""
    import torch
    from toc3d_tpu_torch.ops import attention
    from toc3d_tpu_torch.ops.cuda import cross_attn
    kernel, seen = attention.flash_attention, []

    def record(q, k, v, heads):
        seen.append(k.shape[1])
        return kernel(q, k, v, heads)
    with attention_core(record):
        cross_attn.flash_attention_core.launches = 0
        out = run()
        torch.cuda.synchronize()
        launches = cross_attn.flash_attention_core.launches
    ms = cuda_time(run, 3, warmup=1)
    with attention_core(plain_f32_core):
        ref = run()
    ok = True
    for k in keys:
        a, b = (out[k], ref[k]) if isinstance(out, dict) else (out, ref)
        ok &= compare(f"{tag} {k} (kernel D against the f32 core)", a,
                      b)[0]
        ok &= bool(torch.isfinite(a).all())
    return ok, out, launches, seen, ms


@contextlib.contextmanager
def conv_flops():
    """Count the operations of every F.conv2d / F.conv_transpose2d call in
    the block (2 per multiply-add, from the shapes); yields a one-element
    list that holds the sum."""
    import torch.nn.functional as F
    conv, convt, total = F.conv2d, F.conv_transpose2d, [0]

    def counted(x, w, *a, **kw):
        y = conv(x, w, *a, **kw)
        total[0] += 2 * y.numel() * w[0].numel()
        return y

    def counted_t(x, w, *a, **kw):
        total[0] += 2 * x.numel() * w[0].numel()
        return convt(x, w, *a, **kw)
    F.conv2d, F.conv_transpose2d = counted, counted_t
    try:
        yield total
    finally:
        F.conv2d, F.conv_transpose2d = conv, convt


def _bf16_against_f32(tag, fn, x, shapes, scale):
    """fn(x) in bf16 against fn(x) in f32 on the card (TF32 off): output
    shapes, finite, within the kernel tolerance times ``scale``. Prints the
    bf16 call's ms (3 calls after one to warm up) beside the bound of its
    convolutions' operations, and both runs' peak memory. Returns ok."""
    import torch
    peaks = []
    for dt in (torch.float32, torch.bfloat16):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with conv_flops() as flops:
            outs = fn(x.to(dt))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        if dt == torch.float32:
            ref = outs
    xb = x.to(torch.bfloat16)
    ms = cuda_time(lambda: fn(xb), 3, warmup=1)
    log(f"{tag}: bf16 {ms:.3f} ms a call, the convolutions' "
        f"{flops[0] / 1e12:.4f} TFLOP over the bf16 peak "
        f"{flops[0] / PEAK_BF16_FLOPS * 1e3:.4f} ms; peak memory f32 "
        f"{peaks[0]:.3f} GiB, bf16 {peaks[1]:.3f} GiB; outputs "
        f"{[tuple(o.shape) for o in outs]}")
    ok = [tuple(o.shape) for o in outs] == shapes
    for i, (o, r) in enumerate(zip(outs, ref)):
        ok &= bool(torch.isfinite(o).all())
        ok &= compare(f"{tag} output {i} bf16 against f32", o, r, scale)[0]
    return ok


def phase_alt_modules(results):
    """The modules outside the shipped configs, on the card at full width:
    ToC3D_faster_1600 with the 'score' selector (ALT_FRAMES frames through
    phase_main_path, captured against eager, A 1, B 6, C 18, D 12, G 96,
    LN 72 a frame, its ms/frame beside the 'attention' path's, streamed
    the same way just before it); PETRHeadDN (900
    queries, 6 layers, feats (1, 6, 50, 100, 256)) without DN (12 D
    launches: 6 at 900 keys, 6 at 30000) and with DN (6: the masked
    self-attention is written out), each against the same call with a
    plain f32 attention core; D at q 900 / k 900 against its plain version
    and timed (a row of the kernels line); the PETR encoder (2 layers over
    6000 tokens) the same way; VoVNet V-99-eSE (6 views at 320x800 and
    800x1600) and ViTSimpleFPN (scales 4, 2, 1, 0.5 on (6, 50, 100, 1024))
    in bf16 against f32; the host-pipeline twin for 24 frames. Prints the
    phase's wall time and the nvidia-smi line. Returns ok."""
    import torch
    from toc3d_tpu_torch.configs import apply_overrides, get_config
    from toc3d_tpu_torch.core.dn import (draw_dn_noise, dn_reference_points,
                                         prepare_for_dn)
    from toc3d_tpu_torch.models.detector import build_detector, build_module
    from toc3d_tpu_torch.models.petr_head_dn import (build_petr_head_dn,
                                                     petr_head_dn_config,
                                                     petr_head_dn_forward)
    from toc3d_tpu_torch.models.petr_transformer import (DecoderConfig,
                                                         Encoder,
                                                         encoder_forward)
    from toc3d_tpu_torch.models.vit_simple_fpn import (
        ViTSimpleFPN, ViTSimpleFPNConfig, vit_simple_fpn_forward)
    from toc3d_tpu_torch.models.vovnet import (VoVNet, VoVNetConfig,
                                               vovnet_forward)
    from toc3d_tpu_torch.tools import host_pipeline_bench
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    bf = torch.bfloat16
    oks = {}

    # the 'score' selector on the main path's preset, beside 'attention'
    # streamed the same way just before it; the steady mean over
    # ALT_FRAMES - 2 frames
    for score_type in ("attention", "score"):
        cfg = apply_overrides(get_config("ToC3D_faster_1600"),
                              [f"backbone.pruning_score_type={score_type}"])
        model = build_detector(cfg, device="cuda", seed=0)
        oks[score_type], _ = phase_main_path(
            model, results, f"bf16 {score_type}", MAIN_PER_FRAME, (),
            n_frames=ALT_FRAMES, host_checks=False)
        del model
        torch.cuda.empty_cache()
    att, sc = (results["paths"][f"ToC3D_faster_1600 bf16 {t}"]
               for t in ("attention", "score"))
    log(f"selector score_type 'score' against 'attention', {ALT_FRAMES} "
        f"frames each, steady ms/frame (frames 2-{ALT_FRAMES - 1}) captured "
        f"{sc['captured_ms']:.3f} against "
        f"{att['captured_ms']:.3f}, eager {sc['eager_ms']:.3f} against "
        f"{att['eager_ms']:.3f}")

    # PETRHeadDN at full width, without and with DN
    hcfg = petr_head_dn_config(compute_dtype="bfloat16")
    head = build_petr_head_dn(hcfg, "cuda", seed=0)
    feats = torch.randn(1, 6, 50, 100, 256, device=dev, generator=g)
    frame = host_frames(4, 1)[0]
    data = {"intrinsics": frame["intrinsics"].to(dev),
            "img2lidar": frame["img2lidar"].to(dev), "pad_shape": (800, 1600)}
    keys = ("all_cls_scores", "all_bbox_preds")
    ok, out, n_d, seen, ms = _against_plain_core(
        "PETRHeadDN", lambda: petr_head_dn_forward(head, hcfg, feats, data),
        keys)
    ok &= (n_d == 12 and sorted(seen) == [900] * 6 + [30000] * 6
           and tuple(out["all_cls_scores"].shape) == (6, 1, 900, 10))
    log(f"PETRHeadDN (900 queries, 6 layers, feats (1,6,50,100,256) bf16) "
        f"without DN: {ms:.3f} ms a call, D launches {n_d} at keys "
        f"{sorted(seen)}: {'ok' if ok else 'FAIL'}")
    oks["head"] = ok
    n900 = seen.count(900)
    gt = hcfg.dn_max_gt
    boxes = torch.rand(1, gt, 9, device=dev, generator=g)
    boxes[..., :3] = boxes[..., :3] * 80 - 40
    boxes[..., 3:6] = boxes[..., 3:6] * 4 + 0.5
    dn = prepare_for_dn(hcfg, boxes, torch.randint(0, 10, (1, gt), device=dev,
                                                   generator=g),
                        torch.ones(1, gt, dtype=torch.bool, device=dev),
                        draw_dn_noise(hcfg, 1, g, dev))
    dn_head = {"padded_reference_points": dn_reference_points(
        dn, head.reference_points.weight, 1), "attn_mask": dn["attn_mask"],
        "pad_size": dn["pad_size"]}
    pad = dn["pad_size"]
    ok, out, n_d, seen, ms = _against_plain_core(
        "PETRHeadDN with DN",
        lambda: petr_head_dn_forward(head, hcfg, feats, data, dn=dn_head),
        keys + ("dn_cls_scores", "dn_bbox_preds"))
    ok &= (n_d == 6 and seen == [30000] * 6
           and tuple(out["dn_cls_scores"].shape) == (6, 1, pad, 10)
           and tuple(out["dn_bbox_preds"].shape) == (6, 1, pad, 10))
    log(f"PETRHeadDN with DN ({gt} boxes, {pad} DN queries): {ms:.3f} ms a "
        f"call, D launches {n_d} at keys {seen}: {'ok' if ok else 'FAIL'}")
    oks["head dn"] = ok
    del head, feats, out
    ok, entry = check_flash(900, g, graphed=True)
    results[D900_ROW] = dict(
        name="flash_attention_core", route="cuda",
        source="toc3d_tpu_torch/csrc/cross_attn.cu",
        replaces="toc3d_tpu/ops/pallas/cross_attn.py:118", launches=n900,
        frame="PETRHeadDN call (its self-attention; 0 on the main path)",
        **entry)
    oks["D kv900"] = ok

    # the PETR encoder: 2 layers over 6 views of 20 x 50 tokens
    ecfg = DecoderConfig()
    enc = build_module(lambda: Encoder(ecfg, 2), "cuda", seed=0)
    x = (torch.randn(1, 6000, 256, device=dev, generator=g)).to(bf)
    pos = (torch.randn(1, 6000, 256, device=dev, generator=g)).to(bf)
    ok, out, n_d, seen, ms = _against_plain_core(
        "PETR encoder", lambda: encoder_forward(enc, ecfg, x, pos), ("x",))
    ok &= n_d == 2 and seen == [6000, 6000]
    log(f"PETR encoder (2 layers, (1, 6000, 256) bf16): {ms:.3f} ms a call, "
        f"D launches {n_d} at keys {seen}: {'ok' if ok else 'FAIL'}")
    oks["encoder"] = ok
    del enc, x, pos, out

    # VoVNet V-99-eSE and ViTSimpleFPN, bf16 against f32
    vov = build_module(lambda: VoVNet(VoVNetConfig("V-99-eSE")), "cuda",
                       seed=0)
    for h, w in ((320, 800), (800, 1600)):
        img = torch.randn(6, h, w, 3, device=dev, generator=g)
        oks[f"vovnet {w}x{h}"] = _bf16_against_f32(
            f"VoVNet V-99-eSE 6 x {w}x{h}",
            lambda t: vovnet_forward(vov, t), img,
            [(6, h // 16, w // 16, 768), (6, h // 32, w // 32, 1024)],
            VOVNET_TOL_SCALE)
    del vov, img
    fcfg = ViTSimpleFPNConfig(1024, 256, (4.0, 2.0, 1.0, 0.5), 4)
    fpn = build_module(lambda: ViTSimpleFPN(fcfg), "cuda", seed=0)
    x = torch.randn(6, 50, 100, 1024, device=dev, generator=g)
    oks["fpn"] = _bf16_against_f32(
        "ViTSimpleFPN (6, 50, 100, 1024) scales 4/2/1/0.5",
        lambda t: vit_simple_fpn_forward(fpn, t), x,
        [(6, 200, 400, 256), (6, 100, 200, 256), (6, 50, 100, 256),
         (6, 25, 50, 256)], 1.0)
    del fpn, x
    torch.cuda.empty_cache()

    # the host-pipeline twin, a short run
    rec = host_pipeline_bench.main(
        ["--config", "ToC3D_faster_1600", "--frames", "24", "--warmup", "8",
         "--distinct", "4", "--host-probe", "8"])
    fps = {k: 1e3 / rec[f"{k}_ms"] for k in ("host_fast_u8", "infer_u8",
                                              "e2e_fast")}
    oks["host pipeline"] = all(math.isfinite(v) and v > 0
                               for v in fps.values())
    # one prefetch thread: in steady state e2e is no faster than the host
    # alone; a faster reading means the timed frames began on a filled
    # queue, and its e2e and overlap are no steady reading
    steady = fps["e2e_fast"] <= fps["host_fast_u8"]
    log(f"host pipeline ToC3D_faster_1600 (24 timed frames, 8 warm-up, 4 "
        f"distinct sets of six 1600x900 JPEGs): host (fast, uint8) "
        f"{fps['host_fast_u8']:.3f} frames/s, infer {fps['infer_u8']:.3f}, "
        f"e2e {fps['e2e_fast']:.3f}; overlap {rec['overlap_eff_fast']}, "
        f"host-bound {rec['host_bound']}; e2e within the host rate "
        f"{steady}" + ("" if steady else " (e2e and overlap not steady: "
                                         "not a reading)"))
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    results.setdefault("paths", {})["alt_modules_wall_s"] = wall
    bad = [k for k, v in oks.items() if not v]
    log(f"phase_alt_modules: {wall:.1f} s wall, failed {bad or 'none'} | "
        f"{nvidia_smi_line()}")
    return not bad


def kernel_ops() -> dict:
    """The custom op of each kernel of the kernels line, by key (G, G8, LN
    and AU run inside the ops or in training, and are no op of their
    own)."""
    from toc3d_tpu_torch.ops.cuda.library import OPS
    return {k: op for op, k in OPS.items()}


EXPORT_CHECKED = 3   # frames held bit for bit: the first, then two steady
EXPORT_TIMED = 6     # steady frames timed after them (the last one again)

# run in a fresh interpreter: load an artifact with no model module,
# stream the saved frames through the loaded detector's call (captured
# graphs) and through its eager run, hold both to make_infer_fn's saved
# outputs, and time steady frames of each
EXPORT_CHILD = r"""
import json, sys, time
import torch
from toc3d_tpu_torch.ops.cuda import counted_wrappers
from toc3d_tpu_torch.runtime.export import load_detector
art, data = sys.argv[1], sys.argv[2]
t0 = time.perf_counter()
det = load_detector(art)
load_s = time.perf_counter() - t0
d = torch.load(data, weights_only=True)
frames = [{k: v.pin_memory() for k, v in f.items()} for f in d["frames"]]
counters = counted_wrappers()
for c in counters.values():
    c.launches = 0
state, equal = det.init_state(), []
for f, ref in zip(frames, d["ref"]):
    state, out = det(state, f)
    got = tuple(out) + tuple(state.memory)
    equal.append(all(torch.equal(a.cpu(), b) for a, b in zip(got, ref)))
launches = {k: c.launches for k, c in counters.items()}
estate, eager_equal = det.init_state(), []
for f, ref in zip(frames, d["ref"]):
    estate, out = det.eager(estate, f)
    got = tuple(out) + tuple(estate.memory)
    eager_equal.append(all(torch.equal(a.cpu(), b) for a, b in zip(got, ref)))


def timed(run, state):
    ms = []
    for _ in range(d["timed"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = run(state, frames[-1])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


ms, eager_ms = timed(det, state), timed(det.eager, estate)
mods = sorted(m for m in sys.modules if m.startswith("toc3d_tpu_torch.models"))
print(json.dumps({"load_s": load_s, "equal": equal,
                  "eager_equal": eager_equal, "launches": launches,
                  "ms": ms, "eager_ms": eager_ms, "programs": sorted(
                      det.runner.programs), "model_modules": mods}))
"""


def export_frames(seed: int, uint8: bool, n: int, pad_shape, views=6):
    """n frames of the synthetic stream (prev_exists 0, then 1) on the
    host: the main path's uint8 views, or seeded normal float32 ones."""
    import torch
    frames = host_frames(seed, n, pad_shape)
    if not uint8:
        g = torch.Generator().manual_seed(seed)
        for f in frames:
            f["img"] = torch.randn(f["img"].shape, generator=g).pin_memory()
    return frames


def phase_export(results):
    """The export path (runtime/export.py) at full width and depth:
    ToC3D_faster_1600, 6 views, batch 1, seeded random weights, exported
    twice (bf16 with float32 images; int8 dynamic, backbone and decoder,
    with uint8 images) into a temporary directory; each artifact loaded in
    a fresh `python3 -c` that asserts no toc3d_tpu_torch.models module is
    loaded, streams 3 frames (the first, two steady) through the loaded
    detector's call (captured graphs) equal bit for bit to make_infer_fn's
    (boxes, scores, labels, validity, bank) with each kernel's launches per
    frame (bf16: A 1, B 6, C 18, D 12, G 96, LN 72; int8: A 1, B8 6, C8
    18, D 12, H8 60, G8 96, LN 72), and through its eager run, equal too,
    then times steady frames of both beside make_infer_fn's captured ones.
    Returns ok."""
    import shutil
    import tempfile
    import torch
    from dataclasses import replace
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import (build_detector, init_state,
                                                 make_infer_fn)
    from toc3d_tpu_torch.runtime.export import export_detector
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="toc3d_export_")
    ok_all = True
    try:
        for label, int8, per_frame in (
                ("bf16, float32 images", False, MAIN_PER_FRAME),
                ("int8 dynamic, uint8 images", True, INT8_PER_FRAME)):
            cfg = get_config("ToC3D_faster_1600")
            if int8:
                cfg = replace(cfg, backbone=replace(cfg.backbone,
                                                    quant="int8"),
                              head=replace(cfg.head, decoder=replace(
                                  cfg.head.decoder, quant="int8")))
            model = build_detector(cfg, device="cuda", seed=0)
            art = os.path.join(tmp, "int8" if int8 else "bf16")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            manifest = export_detector(
                model, art, img_dtype=torch.uint8 if int8 else torch.float32)
            export_s = time.perf_counter() - t0
            sizes = {f: os.path.getsize(os.path.join(art, f))
                     for f in sorted(os.listdir(art))}
            frames = export_frames(3, int8, EXPORT_CHECKED, cfg.pad_shape)
            infer = make_infer_fn(model)
            state = init_state(1, cfg, device="cuda")
            refs = []
            for f in frames:
                state, det = infer(state, f)
                refs.append([t.cpu() for t in tuple(det) +
                             tuple(state.memory)])
            graph_ms = []
            for _ in range(EXPORT_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, det = infer(state, frames[-1])
                torch.cuda.synchronize()
                graph_ms.append((time.perf_counter() - t0) * 1e3)
            data = os.path.join(tmp, "frames.pt")
            torch.save({"frames": frames, "ref": refs,
                        "timed": EXPORT_TIMED}, data)
            del model, infer, state, det, frames, refs
            torch.cuda.empty_cache()
            r = subprocess.run(
                [sys.executable, "-c", EXPORT_CHILD, art, data], cwd=root,
                env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                text=True, timeout=600)
            lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
            if r.returncode != 0 or not lines:
                log(f"export {label}: the loading process FAILED (exit "
                    f"{r.returncode})\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
                ok_all = False
                continue
            got = json.loads(lines[-1])
            # a loaded program runs the neck's convolutions as aten ops
            want = {k: 0 if k == "conv" else n * EXPORT_CHECKED
                    for k, n in zip(KERNELS, per_frame)}
            ok = (all(got["equal"]) and all(got["eager_equal"])
                  and got["launches"] == want
                  and got["programs"] == ["backbone_first",
                                          "backbone_steady", "head+decode"]
                  and not got["model_modules"]
                  and set(manifest["ops"]) <= set(kernel_ops().values()))
            ok_all &= ok

            def mean(ms):
                return sum(ms[1:]) / len(ms[1:])
            c_ms, e_ms, g_ms = (mean(got["ms"]), mean(got["eager_ms"]),
                                mean(graph_ms))
            results.setdefault("export", {})[label] = dict(
                export_s=export_s, artifact_bytes=sizes,
                load_s=got["load_s"], loaded_captured_ms=c_ms,
                loaded_eager_ms=e_ms, captured_ms=g_ms)
            log(f"export ToC3D_faster_1600 {label}: {export_s:.3f} s to "
                f"export, artifact {sum(sizes.values())} bytes {sizes}; ops "
                f"{manifest['ops']}; loaded in a fresh process in "
                f"{got['load_s']:.3f} s, model modules {got['model_modules']}"
                f", graphs {got['programs']}; equal to make_infer_fn bit for "
                f"bit per frame: captured {got['equal']}, eager "
                f"{got['eager_equal']}; launches {got['launches']} over "
                f"{EXPORT_CHECKED} frames (want "
                f"{want}); steady ms/frame (frames 1-{EXPORT_TIMED - 1}): "
                f"loaded artifact captured "
                f"{[round(t, 3) for t in got['ms']]} mean {c_ms:.3f} "
                f"({1e3 / c_ms:.4f} frames/s), loaded artifact eager "
                f"{[round(t, 3) for t in got['eager_ms']]} mean {e_ms:.3f} "
                f"({1e3 / e_ms:.4f} frames/s), make_infer_fn captured "
                f"{[round(t, 3) for t in graph_ms]} mean {g_ms:.3f} "
                f"({1e3 / g_ms:.4f} frames/s); loaded captured / "
                f"make_infer_fn {c_ms / g_ms:.4f} "
                f"{'ok' if ok else 'FAIL'}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase_export: {time.perf_counter() - t_phase:.1f} s wall | "
        f"{nvidia_smi_line()}")
    return ok_all


PRETRAINED_GRID = 32   # the synthetic checkpoint's pos_embed: 32 x 32 + cls


def pretrained_checkpoint(vit, seed: int, grid: int = PRETRAINED_GRID):
    """A seeded synthetic EVA-02 backbone checkpoint on the card, named as
    the public one (patch_embed.proj, pos_embed, blocks.{i}), at the widths
    and depth of ``vit`` (an EVAViTConfig) with a pos_embed of grid x grid
    + cls; matrices N(0, 0.02), LayerNorm scales 1 + N(0, 0.02), the rest
    N(0, 0.02), as an initialized backbone."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    c, hid, ps = vit.embed_dim, int(vit.embed_dim * vit.mlp_ratio), \
        vit.patch_size

    def draw(name, *shape):
        v = torch.randn(shape, generator=g, device="cuda") * 0.02
        return v + 1.0 if name.endswith(("norm1.weight", "norm2.weight",
                                          "ffn_ln.weight")) else v
    block = {"norm1.weight": (c,), "norm1.bias": (c,),
             "attn.q_proj.weight": (c, c), "attn.q_bias": (c,),
             "attn.k_proj.weight": (c, c), "attn.v_proj.weight": (c, c),
             "attn.v_bias": (c,), "attn.proj.weight": (c, c),
             "attn.proj.bias": (c,), "norm2.weight": (c,),
             "norm2.bias": (c,), "mlp.w1.weight": (hid, c),
             "mlp.w1.bias": (hid,), "mlp.w2.weight": (hid, c),
             "mlp.w2.bias": (hid,), "mlp.w3.weight": (c, hid),
             "mlp.w3.bias": (c,), "mlp.ffn_ln.weight": (hid,),
             "mlp.ffn_ln.bias": (hid,)}
    sd = {"patch_embed.proj.weight": draw("w", c, 3, ps, ps),
          "patch_embed.proj.bias": draw("b", c),
          "pos_embed": draw("w", 1, grid * grid + 1, c)}
    for i in range(vit.depth):
        for k, shape in block.items():
            sd[f"blocks.{i}.{k}"] = draw(k, *shape)
    return sd


def phase_pretrained(results):
    """The warm start (runtime/checkpoint.load_backbone_pretrained) on the
    card: ToC3D_faster_1600 with seeded random weights, one frame (pinned
    host memory, prev_exists 0) through make_infer_fn twice (its first use,
    then a replay); a seeded synthetic EVA-02 checkpoint at full width with
    a 32 x 32 + cls pos_embed merged into the model, whose report must
    list pos_embed, patch_embed and all 24 blocks as loaded; the same frame
    from a fresh state twice again: the programs are packed and captured
    anew, both results differ from the frame before the merge and equal
    eager infer_step's bit for bit (boxes, scores, labels, validity,
    bank), and the replay launches the main path's per-frame counts.
    Returns ok."""
    import torch
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import (build_detector, infer_step,
                                                 init_state, make_infer_fn)
    from toc3d_tpu_torch.runtime.checkpoint import load_backbone_pretrained
    t0 = time.perf_counter()
    cfg = get_config("ToC3D_faster_1600")
    model = build_detector(cfg, device="cuda", seed=0)
    infer = make_infer_fn(model)
    frame = host_frames(11, 1, cfg.pad_shape)[0]

    def outputs(run):
        state, det = run(init_state(1, cfg, device="cuda"), frame)
        return tuple(det) + tuple(state.memory)
    outputs(infer)
    before = outputs(infer)
    programs = dict(infer.runner.programs)
    ck = pretrained_checkpoint(cfg.backbone, 13)
    torch.cuda.synchronize()
    t_merge = time.perf_counter()
    report = load_backbone_pretrained(model, ck)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t_merge
    del ck
    want_loaded = ["pos_embed", "patch_embed"] + [
        f"blocks.{i}" for i in range(cfg.backbone.depth)]
    first = outputs(infer)
    for f in counters():
        f.launches = 0
    replay = outputs(infer)
    launches = [f.launches for f in counters()]
    eager = outputs(lambda s, f: infer_step(model, s, f))
    recaptured = sorted(map(str, infer.runner.programs)) == sorted(
        map(str, programs)) and all(infer.runner.programs[k] is not p
                                    for k, p in programs.items())
    same = [all(torch.equal(a, b) for a, b in zip(got, eager))
            for got in (first, replay)]
    differs = not torch.equal(replay[1], before[1]) and \
        not torch.equal(replay[0], before[0])
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (replay[0], replay[1], eager[4]))
    ok = (report == {"loaded": want_loaded, "missing": []} and recaptured
          and all(same) and differs and finite
          and launches == list(MAIN_PER_FRAME))
    results["pretrained"] = dict(merge_s=merge_s, loaded=len(
        report["loaded"]), missing=report["missing"])
    log(f"warm start ToC3D_faster_1600: a synthetic EVA-02 checkpoint "
        f"({cfg.backbone.depth} blocks of width {cfg.backbone.embed_dim}, "
        f"pos_embed {PRETRAINED_GRID}x{PRETRAINED_GRID} + cls) merged in "
        f"{merge_s:.3f} s: loaded {len(report['loaded'])} "
        f"{report['loaded'][:3]}..., missing {report['missing']}; programs "
        f"captured anew {recaptured}; the frame after the merge differs "
        f"from the one before {differs}, finite {finite}; equal to eager "
        f"infer_step bit for bit (first use, replay) {same}; replay "
        f"launches {'/'.join(KERNELS)} {launches} (want "
        f"{list(MAIN_PER_FRAME)}); {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    return ok


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


# ---------------------------------------------------------------------------
# training (phase_train)
# ---------------------------------------------------------------------------

TRAIN_PER_STEP = {"A": 1, "B": 1, "C": 18, "D": 0, "B8": 0, "C8": 0,
                  "H8": 0, "G": 76, "G8": 0, "LN": 57, "AU": 7, "W1": 19,
                  "W2": 0, "conv": 0, "qkv": 19}
TRAIN_STEPS, TRAIN_SETTLE = 30, 3
MATCH_STEPS = 6   # steps timed with the 'callback' matcher pinned


def train_batch(rng, b, n, h, w, g3=32, g2=32, prev_exists=1.0):
    """bench.py's synthetic training batch (bench.py:47-84: random
    normalized views, a fixed rig, 32 3D and 32 2D boxes), numpy; the
    port's bench builds it (toc3d_tpu_torch.bench.make_train_batch)."""
    from toc3d_tpu_torch.bench import make_train_batch
    return make_train_batch(rng, b, n, h, w, g3, g2, prev_exists)


def _grad_pairs(tag, fn_out, model_out, inputs, g):
    """The Function against the model path its backward differentiates, on
    the same inputs: the model path's forward held to the kernel's output
    at the kernel bounds (TOL_MAX_REL / TOL_MEAN_REL; C routed by the
    forward's plan), which is what ties the backward to the kernel; then
    the Function's vjp of g against autograd through the model path, at
    the same bounds. The backward is that autograd, so the gradients agree
    by construction, up to the order of atomic sums. Returns (ok, the
    largest max |err| of the gradients, how many are bit-equal, the
    forward's max |err|)."""
    import torch
    ok, ferr = compare(f"{tag} model path forward against the kernel",
                       model_out.detach(), fn_out.detach())
    gf = torch.autograd.grad(fn_out, inputs, g, allow_unused=True)
    gm = torch.autograd.grad(model_out, inputs, g, allow_unused=True)
    worst, equal = 0.0, 0
    for i, (a, b) in enumerate(zip(gf, gm)):
        if a is None or b is None:
            ok &= a is None and b is None
            continue
        equal += bool(torch.equal(a, b))
        err = (a.float() - b.float()).abs()
        mx = err.max().item()
        tmax = TOL_MAX_REL * b.float().abs().max().item()
        tmean = TOL_MEAN_REL * b.float().abs().mean().item()
        good = math.isfinite(mx) and mx <= tmax and err.mean().item() <= tmean
        if not good:
            log(f"check {tag} gradient {i}: max_abs {mx:.6g} (tol "
                f"{tmax:.6g}) mean_abs {err.mean().item():.6g} (tol "
                f"{tmean:.6g}) FAIL")
        ok &= good
        worst = max(worst, mx)
    log(f"check {tag} gradients against the model path: {len(inputs)} "
        f"inputs, {equal} bit-equal, largest max_abs {worst:.6g} "
        f"{'ok' if ok else 'FAIL'}")
    return ok, worst, equal, ferr


def train_patch_row(tag, conv, x_img):
    """Kernel A (PatchEmbedFn's forward) on the views x_img (V, H, W, 3)
    bf16 against its plain version at the kernel bounds, timed beside
    F.conv2d and its bound. Returns (ok, the kernels-line row)."""
    import torch
    from toc3d_tpu_torch.ops.cuda import patch_embed
    bf = torch.bfloat16
    v, h, w, _ = x_img.shape
    c = conv.out_channels
    wmat, bias = patch_embed.pack_patch_weight(conv, bf)
    shape = f"x ({v},{h},{w},3) bf16 -> ({v},{h // 16},{w // 16},{c})"
    out = patch_embed.patchify_matmul(x_img, wmat, bias, 16)
    ok, err = compare(f"{tag} {shape}", out,
                      patch_embed.patchify_plain(x_img, wmat, bias, 16))
    del out
    m = v * (h // 16) * (w // 16)
    b_ms, b_by = bound(2 * m * 768 * c, x_img.numel() * 2 + wmat.numel() * 2
                       + m * c * 2)
    xin, wconv, bconv = x_img.permute(0, 3, 1, 2), conv.weight.to(bf), \
        conv.bias.to(bf)
    return ok, dict(
        name="patchify_matmul (training: PatchEmbedFn)", route="cuda",
        source="toc3d_tpu_torch/csrc/patch_embed.cu",
        replaces="toc3d_tpu/ops/pallas/patch_embed.py:60",
        shape=shape, max_abs_err=err,
        ms=cuda_time(lambda: patch_embed.patchify_matmul(x_img, wmat, bias,
                                                          16), 20),
        plain_ms=cuda_time(lambda: patch_embed.patchify_plain(
            x_img, wmat, bias, 16), 3),
        library_ms=cuda_time(lambda: torch.nn.functional.conv2d(
            xin, wconv, bconv, stride=16), 20),
        bound_ms=b_ms, bound_by=b_by)


def train_kernel_checks(model, results, g):
    """Each Function of the training step at its training shapes
    (ToC3D_faster, batch 2: 12 views of 800x320, 20 x 50 maps): the
    forward of A, B (ws 16) and C at every (ws, ratio) of the step with
    the reference's keep counts (k 128 at ws 16 / .5) held to its plain
    version at the kernel bounds and timed (a row each); D at the head's
    training shapes (1860 queries: 960 DN, 644 matching, 256 propagated;
    6000 and 2628 keys). Each Function's model path, the function its
    backward linearizes, held to the kernel's output on the same inputs
    (C with the forward's plan), and its gradients to autograd through
    that path (_grad_pairs), and the backward timed. The LN biases are 0
    at this seeded init, so B's padded windows (ws 16 on a 20 x 50 map)
    are the same function on both sides (ops/trainable.py). Returns
    ok."""
    import torch
    from dataclasses import replace
    from toc3d_tpu_torch.models.eva_vit import make_rope_tables, rope_tensors
    from toc3d_tpu_torch.ops import trainable
    from toc3d_tpu_torch.ops.cuda import cross_attn
    dev = torch.device("cuda")
    bf = torch.bfloat16
    cfg = replace(model.cfg.backbone, mxu_align_k=False)
    bb = model.img_backbone
    c, heads = cfg.embed_dim, cfg.num_heads
    ok_all = True
    win, glb = make_rope_tables(cfg)
    rope = {cfg.window_size: rope_tensors(win, dev),
            cfg.global_window_size: rope_tensors(glb, dev)}

    # A: 12 x 320 x 800 normalized views
    x_img = torch.randn(12, 320, 800, 3, device=dev, generator=g).to(bf)
    conv = bb.patch_embed.proj
    ok, results["A train"] = train_patch_row("A train", conv, x_img)
    ok_all &= ok
    ga = torch.randn(12, 20, 50, c, device=dev, generator=g).to(bf)
    ins = [conv.weight, conv.bias]
    ok, _, _, ferr = _grad_pairs("A train", trainable.trainable_patch_embed(
        conv, x_img, 16), trainable.patch_embed_model(conv, x_img, 16), ins,
        ga)
    ok_all &= ok
    results["A train"]["model_fwd_max_abs_err"] = ferr
    results["A train"]["bwd_ms"] = cuda_time(lambda: torch.autograd.grad(
        trainable.trainable_patch_embed(conv, x_img, 16), ins, ga), 5)
    log(f"time A train: {json.dumps(results['A train'])}")
    del x_img

    # B at ws 16 (block 0) and C at every (ws, ratio) of the step
    x = (torch.randn(12, 20, 50, c, device=dev, generator=g) * 0.5).to(bf)
    scores = torch.log(torch.rand(12, 1000, device=dev, generator=g)
                       * 0.9 + 0.05).to(bf)
    gy = torch.randn(12, 20, 50, c, device=dev, generator=g).to(bf)
    for i, ws, ratio in block_shapes(cfg):
        if ratio is None and i != 0:
            continue          # the other full blocks run the model path
        kind = "B" if ratio is None else "C"
        tag = f"{kind} train ws{ws}" + ("" if ratio is None
                                        else f" r{ratio}")
        blk = bb.blocks[i]
        ok, entry = check_block(tag, blk, x, cfg, ws, rope[ws], scores,
                                ratio, reps=5)
        ok_all &= ok
        params = list(blk.parameters())
        xg = x.detach().requires_grad_(True)
        if ratio is None:
            f = lambda: trainable.trainable_full_block(blk, xg, heads, ws,
                                                       rope[ws])
            mdl = lambda: trainable.full_block_model(blk, xg, heads, ws,
                                                     rope[ws])
            ins = [xg] + params
        else:
            sg = scores.detach().requires_grad_(True)
            f = lambda: trainable.trainable_compressed_block(
                blk, xg, sg, heads, ws, ratio, rope[ws], True, True)
            plan = trainable.compress_plan(sg, 12, 20, 50, ws, ratio, True,
                                           align_k=False)
            mdl = lambda: trainable.compressed_block_model(
                blk, xg, sg, heads, ws, rope[ws], plan)
            ins = [xg, sg] + params
        ok, gerr, equal, ferr = _grad_pairs(tag, f(), mdl(), ins, gy)
        ok_all &= ok
        entry.update(grad_max_abs_err=gerr, grads_bit_equal=equal,
                     model_fwd_max_abs_err=ferr,
                     grads=len(ins),
                     bwd_ms=cuda_time(lambda: torch.autograd.grad(
                         f(), ins, gy), 3, warmup=1))
        results[tag] = dict(
            name=("fused_full_block (training: FullBlockFn)" if kind == "B"
                  else "fused_compressed_block (training: "
                       "CompressedBlockFn)"),
            route="cuda", source="toc3d_tpu_torch/csrc/vit_block.cu",
            replaces=BLOCK_ROWS[kind][1], **entry)
        log(f"time {tag} backward: {entry['bwd_ms']:.3f} ms")
    del x, scores, gy

    # D at the head's training shapes
    for kv in (6000, 2628):
        ok, entry = check_flash(kv, g, reps=10, nq=1860, b=2)
        ok_all &= ok
        q = (torch.randn(2, 1860, 256, device=dev, generator=g)
             * (3 * 32 ** -0.5)).to(bf).requires_grad_(True)
        k = torch.randn(2, kv, 256, device=dev, generator=g).to(bf) \
            .requires_grad_(True)
        v = torch.randn(2, kv, 256, device=dev, generator=g).to(bf) \
            .requires_grad_(True)
        gd = torch.randn(2, 1860, 256, device=dev, generator=g).to(bf)
        ok, gerr, equal, ferr = _grad_pairs(
            f"D train kv{kv}", cross_attn.flash_attention(q, k, v, 8),
            cross_attn.attention_core_model(q, k, v, 8), [q, k, v], gd)
        ok_all &= ok
        entry.update(grad_max_abs_err=gerr, grads_bit_equal=equal,
                     model_fwd_max_abs_err=ferr,
                     bwd_ms=cuda_time(lambda: torch.autograd.grad(
                         cross_attn.flash_attention(q, k, v, 8), [q, k, v],
                         gd), 3, warmup=1))
        results[f"D train kv{kv}"] = dict(
            name="flash_attention_core (training: FlashAttentionFn)",
            route="cuda", source="toc3d_tpu_torch/csrc/cross_attn.cu",
            replaces="toc3d_tpu/ops/pallas/cross_attn.py:118", **entry)
        log(f"time D train kv{kv} backward: {entry['bwd_ms']:.3f} ms")
    return ok_all


def _tally_train_shapes(tag="train", views=False):
    """Wrap the kernels the trainable Functions call with a per-shape
    tally (the kernels' own counters are per kernel), keyed "A {tag}",
    "B {tag} ws{ws}", "C {tag} ws{ws} r{ratio}", with " x{views}" after
    the key when ``views``. Returns (tally, restore)."""
    from toc3d_tpu_torch.ops import trainable
    tally = {}
    full, comp, patch = (trainable.fused_full_block,
                         trainable.fused_compressed_block,
                         trainable.patchify_matmul)

    def count(key, x):
        key += f" x{x.shape[0]}" if views else ""
        tally[key] = tally.get(key, 0) + 1

    def full_(blk, x, heads, ws, rope):
        count(f"B {tag} ws{ws}", x)
        return full(blk, x, heads, ws, rope)

    def comp_(blk, x, scores, heads, ws, ratio, *a, **kw):
        count(f"C {tag} ws{ws} r{ratio}", x)
        return comp(blk, x, scores, heads, ws, ratio, *a, **kw)

    def patch_(x, *a, **kw):
        count(f"A {tag}", x)
        return patch(x, *a, **kw)
    trainable.fused_full_block = full_
    trainable.fused_compressed_block = comp_
    trainable.patchify_matmul = patch_

    def restore():
        trainable.fused_full_block = full
        trainable.fused_compressed_block = comp
        trainable.patchify_matmul = patch
    return tally, restore


def train_small_agreement():
    """One tiny training step in bf16 on the card against the CPU, by
    phase_small_agreement's method: the same weights, batch and noise; an
    f32 step on the CPU is the yardstick. For each loss term and
    grad_norm, the card's distance |card - f32| / |f32| must be at most
    1.25 times the largest distance of the CPU's bf16 steps: its own, and
    FLIPS more on images with about half the values moved one bf16 step
    (last_bit_steps). Returns ok."""
    import numpy as np
    import torch
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.configs.presets import served_in_bf16
    from toc3d_tpu_torch.models.detector import build_detector
    from toc3d_tpu_torch.runtime import train as tr
    f32cfg = get_config("tiny")
    cfg = served_in_bf16(f32cfg)
    sd = build_detector(cfg, device="cuda", seed=3).state_dict()
    host = train_batch(np.random.RandomState(2), 1, 2, 64, 128, g3=4, g2=4,
                       prev_exists=0.0)
    noise = tr.draw_train_noise(cfg, 1, 2, torch.Generator().manual_seed(6),
                                "cpu", gt3=4)

    def to(obj, dev):
        if isinstance(obj, torch.Tensor):
            return obj.to(dev)
        if isinstance(obj, (list, tuple)):
            return type(obj)(*(to(o, dev) for o in obj)) if hasattr(
                obj, "_fields") else type(obj)(to(o, dev) for o in obj)
        if isinstance(obj, dict):
            return {k: to(v, dev) for k, v in obj.items()}
        return obj

    def run(c, dev, img=None):
        m = build_detector(c, device=dev, state_dict=sd)
        tx = tr.make_optimizer(m, total_iters=100)
        bt = dict(host)
        if img is not None:
            bt["img"] = img
        batch, steady = tr.batch_to_device(bt, dev)
        _, met = tr.make_train_step(tx)(tr.init_train_state(m, tx, 1),
                                        batch, to(noise, dev), steady=steady)
        return {k: float(v) for k, v in met.items()
                if k != "nonfinite_skips"}

    card, ref = run(cfg, "cuda"), run(f32cfg, "cpu")
    gen = torch.Generator().manual_seed(8)
    cpus = [run(cfg, "cpu")] + [
        run(cfg, "cpu", last_bit_steps(torch.from_numpy(host["img"]),
                                       gen).numpy())
        for _ in range(FLIPS)]
    ok = True
    for k in sorted(ref):
        den = abs(ref[k]) or 1.0
        dc = abs(card[k] - ref[k]) / den
        dcpu = max(abs(x[k] - ref[k]) / den for x in cpus)
        good = math.isfinite(card[k]) and dc <= 1.25 * dcpu
        ok &= good
        log(f"train tiny bf16 step {k}: f32 {ref[k]:.6g}, card {card[k]:.6g}"
            f" (distance {dc:.4g}), CPU bf16 distances up to {dcpu:.4g} "
            f"({1 + FLIPS} steps) {'ok' if good else 'FAIL'}")
    return ok


PORT_KERNELS = ("gemm_sm90_kernel", "patch_im2col_kernel",
                "window_attention_kernel", "layernorm_kernel",
                "gather_merge_kernel", "scatter_update_kernel",
                "flash_partial_kernel", "flash_combine_kernel")


def train_profile(run_step, n=2, top=10, tag="train"):
    """run_step(i) ``n`` times under torch.profiler: the wall ms a step (up
    to a synchronisation), the device time of the CUDA kernels a step
    (copies and fills not counted), the idle share (1 - kernel time / wall),
    the port's kernels' share of the kernel time and the top kernels.
    Returns the summary dict."""
    import torch
    from collections import defaultdict
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run_step(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    per_kernel = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and "Memcpy" not in ev.name and "Memset" not in ev.name:
            per_kernel[ev.name] += ev.time_range.elapsed_us() / 1e3 / n
    total = sum(per_kernel.values())
    ours = sum(ms for k, ms in per_kernel.items()
               if any(p in k for p in PORT_KERNELS))
    out = dict(wall_ms=wall, kernel_ms=total,
               idle_share=max(0.0, 1 - total / wall), port_kernel_ms=ours,
               top=[(round(ms, 3), k[:90]) for k, ms in sorted(
                   per_kernel.items(), key=lambda kv: -kv[1])[:top]])
    log(f"{tag} profile ({n} steps): wall {wall:.3f} ms/step; device "
        f"kernel time {total:.3f} ms/step; idle share "
        f"{out['idle_share']:.3f}; the port's kernels {ours:.3f} ms/step; "
        f"top kernels (ms/step) {out['top']}")
    return out


def train_cli_on_card():
    """The trainer CLI (toc3d_tpu_torch.tools.train's main, in this process)
    on the card: the tiny preset (trained in bf16 there) for 3 iterations
    on learnable synthetic scenes, with a checkpoint and the eval CLI on
    the final weights. Holds: finite losses logged, no skip, the
    checkpoint written, the eval's mAP in [0, 1]. Returns ok."""
    import shutil
    from toc3d_tpu_torch.data.synthetic import make_learnable_dataset
    from toc3d_tpu_torch.tools import train as cli
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_smoke")
    shutil.rmtree(os.path.join(root, "cli"), ignore_errors=True)
    ann = make_learnable_dataset(os.path.join(root, "synth"), src_h=90,
                                 src_w=160)
    t0 = time.perf_counter()
    out = cli.main(["--config", "tiny", "--ann", ann, "--iters", "3",
                    "--batch-size", "1", "--seq-split-num", "1",
                    "--log-interval", "1", "--checkpoint-interval", "3",
                    "--src-h", "90", "--src-w", "160", "--work-dir",
                    os.path.join(root, "cli"), "--val-ann", ann,
                    "--eval-limit", "4"])
    recs = out["records"]
    ok = ([r["iter"] for r in recs] == [1, 2, 3]
          and all(math.isfinite(r["total_loss"]) and r["nonfinite_skips"] == 0
                  for r in recs)
          and len(out["checkpoints"]) == 1
          and os.path.exists(out["checkpoints"][0])
          and 0.0 <= out["evals"][3]["mAP"] <= 1.0)
    log(f"train CLI on the card (tiny, bf16, 3 iterations, eval on 4 "
        f"samples): losses {[round(r['total_loss'], 4) for r in recs]}, "
        f"checkpoint {out['checkpoints']}, mAP {out['evals'][3]['mAP']}, "
        f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    return ok


def _capture_matching(captured):
    """Wrap the train step's hungarian_match so that it also keeps a copy
    of the problems it is given (phase_traineval's real cost tensors).
    Returns restore."""
    from toc3d_tpu_torch.runtime import train as tr
    match = tr.hungarian_match

    def match_(problems, impl=None):
        captured["problems"] = [(c.detach().clone(), v.detach().clone())
                                for c, v in problems]
        return match(problems, impl)
    tr.hungarian_match = match_

    def restore():
        tr.hungarian_match = match
    return restore


def phase_train(results, captured):
    """Training of ToC3D_faster at full width on the card
    (toc3d_tpu_torch.runtime.train.make_train_step), batch 2 (6 views of
    800x320 each), seeded random weights, bench.py's synthetic batch (32 3D
    and 32 2D boxes):
    1. each Function at its training shapes (train_kernel_checks);
    2. one step with every count set to 0 just before it and read just
       after: A 1, B 1, C 18, D 0, G 76, LN 57, AU 7 (the auction matcher,
       the card's default: one launch a cost tensor, six decoder layers
       and the 2D head; the backward launches none), and per shape
       (_tally_train_shapes); the step's cost tensors are kept in
       ``captured`` for phase_traineval;
    3. 30 steps on the fixed batch (bench.py --train's protocol, the first
       3 to settle): losses finite, the mean of the last 5 below the mean of
       the first 5, no non-finite skip; steps/s, samples/s, peak memory and
       the ms a step by stage (the stage timer: noise draw, pack rebuild,
       forward, host matching, losses, backward, optimizer), then 2 steps
       under torch.profiler (train_profile), then MATCH_STEPS steps with
       the 'callback' matcher (the native LAP on the host) pinned, timed
       the same way;
    4. after training: an eval copy captured before it (make_infer_fn)
       recaptures on the trained weights and equals eager infer_step bit
       for bit for 3 frames; a save / load round trip of the train state
       gives equal tensors;
    5. the tiny step, card against CPU (train_small_agreement, both sides
       on the 'callback' matcher);
    6. the trainer CLI on the card (train_cli_on_card).
    Returns ok."""
    import numpy as np
    import torch
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import (build_detector, frame_seed,
                                                 infer_step, init_state,
                                                 make_infer_fn)
    from toc3d_tpu_torch.runtime import train as tr
    from toc3d_tpu_torch.runtime.checkpoint import (load_train_state,
                                                    save_train_state)
    from toc3d_tpu_torch.runtime.timer import StageTimer, span
    dev = torch.device("cuda")
    cfg = get_config("ToC3D_faster")
    b, n = 2, 6
    model = build_detector(cfg, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(11)
    ok_k = train_kernel_checks(model, results, g)

    # an eval copy, captured on the weights before training
    ev = build_detector(cfg, device=dev, state_dict=model.state_dict())
    infer = make_infer_fn(ev)
    frames = host_frames(3, 3, cfg.pad_shape)
    with torch.no_grad():
        infer(init_state(1, cfg, device=dev), frames[0])
    before_programs = dict(infer.runner.programs)

    tx = tr.make_optimizer(model, total_iters=1000)
    state = tr.init_train_state(model, tx, b)
    step = tr.make_train_step(tx)
    batch, steady = tr.batch_to_device(
        train_batch(np.random.RandomState(0), b, n, *cfg.pad_shape), dev)
    gen = torch.Generator(device=dev)
    timer = StageTimer(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals, skips, tally = [], None, {}
    t0 = None
    for i in range(TRAIN_STEPS):
        if i == TRAIN_SETTLE:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        tm = timer if i >= TRAIN_SETTLE else None
        with span(tm, "noise draw"):
            gen.manual_seed(frame_seed(1, i))
            noise = tr.draw_train_noise(cfg, b, n, gen, dev, gt3=32)
        if i == 0:
            for f in counters():
                f.launches = 0
            tally, restore = _tally_train_shapes()
            unwrap = _capture_matching(captured)
            try:
                state, m = step(state, batch, noise, steady=steady)
                torch.cuda.synchronize()
            finally:
                restore()
                unwrap()
            launches = {k: f.launches for k, f in zip(KERNELS, counters())}
            captured["launches"] = launches["AU"]
        else:
            state, m = step(state, batch, noise, steady=steady, timer=tm)
        totals.append(m["total_loss"])
        skips = m["nonfinite_skips"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(totals).cpu().numpy().astype(np.float64)
    timed = TRAIN_STEPS - TRAIN_SETTLE
    ok_l = all(launches[k] == v for k, v in TRAIN_PER_STEP.items())
    log(f"train launches in one step: {launches} (expected "
        f"{TRAIN_PER_STEP}) {'ok' if ok_l else 'FAIL'}; per shape {tally}")
    for key, nl in tally.items():
        if key in results:
            results[key]["launches"] = nl
    ok_l &= sum(v for k, v in tally.items() if k.startswith("C")) == \
        launches["C"] and tally.get("B train ws16") == launches["B"] and \
        all("launches" in results[k] for k in results if " train" in k
            and not k.startswith("D"))
    for k in results:
        if k.startswith("D train"):
            results[k]["launches"] = launches["D"]
    first5, last5 = losses[:5].mean(), losses[-5:].mean()
    ok_s = bool(np.isfinite(losses).all()) and last5 < first5 and \
        int(skips) == 0
    stages = timer.summary()
    log(f"train ToC3D_faster batch {b} x {n} views 800x320, {TRAIN_STEPS} "
        f"steps on one batch ({TRAIN_SETTLE} to settle): losses "
        f"{[round(float(v), 4) for v in losses]}; first 5 mean {first5:.4f}"
        f", last 5 mean {last5:.4f}; nonfinite_skips {int(skips)}; "
        f"{timed / wall:.4f} steps/s, {b * timed / wall:.4f} samples/s, "
        f"{wall / timed * 1e3:.3f} ms/step wall; peak memory {peak:.3f} GiB "
        f"{'ok' if ok_s else 'FAIL'}")
    log("train ms a step by stage (stage timer, mean over "
        f"{timed} steps): " + json.dumps(
            {k: round(v["mean"], 3) for k, v in stages.items()}))
    results["train"] = dict(steps_per_s=timed / wall,
                            samples_per_s=b * timed / wall, peak_gib=peak,
                            stage_ms={k: v["mean"]
                                      for k, v in stages.items()})

    def profiled(i):
        nonlocal state
        gen.manual_seed(frame_seed(1, TRAIN_STEPS + i))
        state, _ = step(state, batch, tr.draw_train_noise(
            cfg, b, n, gen, dev, gt3=32), steady=steady)
    results["train"]["profile"] = train_profile(profiled)

    # the same steps with the host matcher pinned
    from toc3d_tpu_torch.core.assigner import set_default_impl
    ctimer = StageTimer(dev)
    set_default_impl("callback")
    try:
        for i in range(MATCH_STEPS + 1):
            gen.manual_seed(frame_seed(2, i))
            noise = tr.draw_train_noise(cfg, b, n, gen, dev, gt3=32)
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, m = step(state, batch, noise, steady=steady,
                            timer=ctimer if i else None)
        torch.cuda.synchronize()
    finally:
        set_default_impl(None)
    cwall = (time.perf_counter() - t0) / MATCH_STEPS
    cstages = ctimer.summary()
    results["train"]["callback"] = dict(
        steps_per_s=1 / cwall, stage_ms={k: v["mean"]
                                         for k, v in cstages.items()})
    log(f"train matchers, host matching ms a step: 'auction' (default) "
        f"{stages['host matching']['mean']:.4f} ({timed / wall:.4f} "
        f"steps/s), 'callback' (native LAP) "
        f"{cstages['host matching']['mean']:.4f} ({1 / cwall:.4f} steps/s, "
        f"{MATCH_STEPS} steps); 'callback' ms a step by stage: "
        + json.dumps({k: round(v["mean"], 3) for k, v in cstages.items()}))

    # the eval copy recaptures on the trained weights
    ev.load_state_dict(model.state_dict())
    with torch.no_grad():
        _, cap, _ = _stream(infer, init_state(1, cfg, device=dev), frames)
        _, eag, _ = _stream(lambda s, f: infer_step(ev, s, f),
                            init_state(1, cfg, device=dev), frames)
    recaptured = bool(before_programs) and all(
        infer.runner.programs.get(k) is not v
        for k, v in before_programs.items())
    equal = [all(torch.equal(a, b_) for a, b_ in zip(
        tuple(gs.memory) + tuple(gd), tuple(es.memory) + tuple(ed)))
        for (gs, gd), (es, ed) in zip(cap, eag)]
    ok_c = recaptured and all(equal)
    log(f"train: captured make_infer_fn on the trained weights recaptured "
        f"{recaptured}, equal to eager infer_step per frame {equal} "
        f"{'ok' if ok_c else 'FAIL'}")
    del ev, infer, cap, eag, before_programs

    # save / load round trip
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_smoke", "state.pth")
    save_train_state(state, tx, path)
    fresh = build_detector(cfg, device=dev, seed=1)
    ftx = tr.make_optimizer(fresh, total_iters=1000)
    loaded = load_train_state(path, tr.init_train_state(fresh, ftx, b), ftx)
    ref_sd = model.state_dict()
    ok_r = all(torch.equal(v, ref_sd[k])
               for k, v in fresh.state_dict().items())
    ok_r &= all(torch.equal(a, b_) for key in ("mu", "nu")
                for a, b_ in zip(loaded.opt_state[key],
                                 state.opt_state[key]))
    ok_r &= all(torch.equal(a, b_) for a, b_ in zip(loaded.memory,
                                                     state.memory))
    ok_r &= loaded.step == state.step and torch.equal(
        loaded.opt_state["count"], state.opt_state["count"])
    log(f"train: save / load round trip of the train state equal {ok_r}")
    del fresh, ftx, loaded, model, state, tx
    torch.cuda.empty_cache()
    from toc3d_tpu_torch.core.assigner import set_default_impl
    set_default_impl("callback")     # one matcher on both sides
    try:
        ok_a = train_small_agreement()
    finally:
        set_default_impl(None)
    ok_cli = train_cli_on_card()
    ok = ok_k and ok_l and ok_s and ok_c and ok_r and ok_a and ok_cli
    log(f"phase_train: kernels {ok_k}, launches {ok_l}, steps {ok_s}, "
        f"recapture {ok_c}, save/load {ok_r}, tiny card vs CPU {ok_a}, "
        f"trainer CLI {ok_cli}")
    return ok


# ---------------------------------------------------------------------------
# training at 1600x800 (phase_train_1600)
# ---------------------------------------------------------------------------

# one step of ToC3D_faster_1600 at batch 2 under the default policy (the
# view scan on, a chunk of 1 view: 6 chunks of 2 rows); unscanned, one
# chunk of 12 rows (A 1, B 1, C 18, G 76, LN 57, as phase_train's)
TRAIN1600_PER_STEP = {"A": 6, "B": 6, "C": 108, "D": 0, "B8": 0, "C8": 0,
                      "H8": 0, "G": 456, "G8": 0, "LN": 342, "AU": 7,
                      "W1": 114, "W2": 0, "conv": 0, "qkv": 114}
TRAIN1600_SETTLE, TRAIN1600_TIMED = 3, 10
REGIME_TIMED = 3     # steps timed in each other regime, after its first
# (label, make_train_step's options, views a chunk): JAX's bench flags
# --view-scan off, --view-chunk 3 and --attn-chunk 32 (unscanned by the
# policy)
TRAIN1600_REGIMES = (("view scan off", dict(view_scan=False), 6),
                     ("view chunk 3", dict(view_scan=3), 3),
                     ("attn chunk 32", dict(attn_chunk=32), 6))


def _per_step(views_a_chunk: int) -> dict:
    """The launches of one step whose backbone runs 6 / views_a_chunk
    chunks of views."""
    nc = 6 // views_a_chunk
    return {k: (v if k in ("D", "AU") else v // 6 * nc)
            for k, v in TRAIN1600_PER_STEP.items()}


def train1600_kernel_checks(model, results, g):
    """A, B (ws 16) and C at every (ws, ratio) of the step, with the
    reference's keep counts, each forward against its plain version at the
    kernel bounds and timed beside its library yardstick and bound, at the
    step's 1600x800 shapes (50 x 100 maps): 12 views (batch 2 unscanned:
    60000 rows, 336 windows at ws 16, 180 at ws 20) and 2 (a chunk of the
    default view scan). Rows "A train1600 x12", "B train1600 ws16 x2", ...,
    each with the regime whose step launches it (its launches are set
    there). Returns ok."""
    import torch
    from dataclasses import replace
    from toc3d_tpu_torch.models.eva_vit import make_rope_tables, rope_tensors
    dev = torch.device("cuda")
    bf = torch.bfloat16
    cfg = replace(model.cfg.backbone, mxu_align_k=False)
    bb = model.img_backbone
    c = cfg.embed_dim
    win, glb = make_rope_tables(cfg)
    rope = {cfg.window_size: rope_tensors(win, dev),
            cfg.global_window_size: rope_tensors(glb, dev)}
    ok_all = True
    for v, regime in ((12, "view scan off"), (2, "view scan (default)")):
        x_img = torch.randn(v, 800, 1600, 3, device=dev, generator=g).to(bf)
        tag = f"A train1600 x{v}"
        ok, results[tag] = train_patch_row(tag, bb.patch_embed.proj, x_img)
        log(f"time {tag}: {json.dumps(results[tag])}")
        ok_all &= ok
        del x_img
        x = (torch.randn(v, 50, 100, c, device=dev, generator=g)
             * 0.5).to(bf)
        scores = torch.log(torch.rand(v, 5000, device=dev, generator=g)
                           * 0.9 + 0.05).to(bf)
        for i, ws, ratio in block_shapes(cfg):
            if ratio is None and i != 0:
                continue      # the other full blocks run the model path
            kind = "B" if ratio is None else "C"
            tag = f"{kind} train1600 ws{ws}" + (
                "" if ratio is None else f" r{ratio}") + f" x{v}"
            ok, entry = check_block(tag, bb.blocks[i], x, cfg, ws, rope[ws],
                                    scores, ratio, reps=5)
            ok_all &= ok
            results[tag] = dict(
                name=("fused_full_block (training: FullBlockFn)"
                      if kind == "B" else "fused_compressed_block "
                      "(training: CompressedBlockFn)"),
                route="cuda", source="toc3d_tpu_torch/csrc/vit_block.cu",
                replaces=BLOCK_ROWS[kind][1], **entry)
        for tag in results:
            if tag.startswith(("A train1600", "B train1600", "C train1600")) \
                    and tag.endswith(f" x{v}"):
                results[tag].update(launches=0, regime=regime)
        del x, scores
        torch.cuda.empty_cache()
    return ok_all


class MemorySpans:
    """A stand-in for runtime/timer.StageTimer that reads, for each span of
    a step, the peak of allocated device memory inside it (the device
    synchronised and the peak reset at the span's start) and the memory
    allocated at its start, in GiB."""

    def __init__(self):
        self.peaks, self.start = {}, {}

    @contextlib.contextmanager
    def span(self, name):
        import torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.start[name] = torch.cuda.memory_allocated() / 2**30
        yield
        torch.cuda.synchronize()
        self.peaks[name] = torch.cuda.max_memory_allocated() / 2**30

    def line(self) -> str:
        return json.dumps({k: [round(self.start[k], 3), round(v, 3)]
                           for k, v in self.peaks.items()})


def backbone_peak(model, memory, batch, steady, noise, **opts):
    """The backbone alone in training (extract_img_feat(train=True) with
    ``opts``: view_scan, attn_chunk), forward and backward of a loss of its
    features and token masks against its parameters: the device memory
    allocated before it and the peak above that, in GiB, and its ms (host
    clock to a synchronisation)."""
    import torch
    from toc3d_tpu_torch.models.detector import extract_img_feat
    params = [p for p in model.img_backbone.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    f, aux = extract_img_feat(model, batch["img"], memory, batch,
                              steady=steady, mask_noise=noise.gumbel,
                              train=True, dp_keep=noise.drop_path,
                              remat=True, **opts)
    loss = f.square().mean() + sum(m.float().mean()
                                   for m in aux["token_masks"])
    torch.autograd.grad(loss, params, allow_unused=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return dict(start_gib=start / 2**30,
                peak_above_gib=(torch.cuda.max_memory_allocated() - start)
                / 2**30, ms=ms)


def _train_run(step, state, batch, steady, noise_at, steps, timer=None,
               settle=0):
    """``steps`` train steps; the first ``settle`` untimed. Returns (state,
    the total losses (numpy), skips, wall s of the timed steps)."""
    import numpy as np
    import torch
    totals, m = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        if i == settle:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, batch, noise_at(i), steady=steady,
                        timer=timer if i >= settle else None)
        totals.append(m["total_loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (state, torch.stack(totals).cpu().numpy().astype(np.float64),
            int(m["nonfinite_skips"]), wall)


def phase_train_1600(results):
    """Training of ToC3D_faster_1600 at full width and depth on the card,
    batch 2 of 6 views at 1600x800, seeded random weights, bench.py's
    synthetic batch (train_batch):
    (a) A, B and C at the step's 1600x800 shapes (train1600_kernel_checks);
    (b) one step under the default policy (the view scan on, a view a
        chunk) with every count set to 0 just before it and read just
        after: A 6, B 6, C 108, D 0, G 456, LN 342, AU 7, and per shape;
        the device memory allocated at the start of each stage of that
        step and its peak inside the stage (MemorySpans);
    (c) TRAIN1600_SETTLE + TRAIN1600_TIMED more steps: every loss of the
        run finite, the mean of its last 5 below the mean of its first 5,
        no non-finite skip; steps/s, samples/s, peak memory (over (b) and
        (c)) and the ms a step by stage (the stage timer);
    then the backbone alone under the default and each other regime
        (backbone_peak), the part of the step the view scan bounds;
    (d) each of TRAIN1600_REGIMES, on the same state: its first step with
        the counts set to 0 and read after and its memory by stage, then
        REGIME_TIMED timed steps; peak memory and steps/s. An
        out-of-memory error of such a regime
        is caught and printed as its result; the default regime has no
        such catch;
    (e) 2 default steps under torch.profiler (train_profile: kernel time,
        idle share), last, as a profiler session slows the launches that
        follow it in the process, then REGIME_TIMED default steps timed
        after it.
    Prints the phase's seconds. Returns ok."""
    import gc
    import numpy as np
    import torch
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import build_detector, frame_seed
    from toc3d_tpu_torch.runtime import train as tr
    from toc3d_tpu_torch.runtime.timer import StageTimer
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config("ToC3D_faster_1600")
    b, n = 2, 6
    model = build_detector(cfg, device=dev, seed=0)
    with torch.no_grad():
        ok_k = train1600_kernel_checks(
            model, results, torch.Generator(device=dev).manual_seed(12))
    torch.cuda.empty_cache()
    tx = tr.make_optimizer(model, total_iters=1000)
    state = tr.init_train_state(model, tx, b)
    batch, steady = tr.batch_to_device(
        train_batch(np.random.RandomState(0), b, n, *cfg.pad_shape), dev)
    gen = torch.Generator(device=dev)

    def noise_from(seed):
        def at(i):
            gen.manual_seed(frame_seed(seed, i))
            return tr.draw_train_noise(cfg, b, n, gen, dev, gt3=32)
        return at

    def counted_step(step, st, noise, views_a_chunk):
        """One step with the counts set to 0 before it and read after, its
        memory read by stage (MemorySpans); the peak is reset after it."""
        for f in counters():
            f.launches = 0
        tally, restore = _tally_train_shapes("train1600", views=True)
        mem = MemorySpans()
        try:
            st, m = step(st, batch, noise, steady=steady, timer=mem)
            torch.cuda.synchronize()
        finally:
            restore()
        got = {k: f.launches for k, f in zip(KERNELS, counters())}
        want = _per_step(views_a_chunk)
        ok = got == want and sum(
            v for k, v in tally.items() if k.startswith("C")) == got["C"]
        for key, nl in tally.items():
            if key in results:
                results[key]["launches"] = nl
        torch.cuda.reset_peak_memory_stats()
        return st, m, got, want, tally, ok, mem

    # (b) + (c): the default policy
    step = default_step = tr.make_train_step(tx)
    at = noise_from(1)
    state, m0, got, want, tally, ok_l, mem = counted_step(step, state, at(0),
                                                         1)
    ok_l &= tr.auto_view_scan(cfg)
    log(f"train1600 launches in one step (view scan, a view a chunk): "
        f"{got} (expected {want}) {'ok' if ok_l else 'FAIL'}; per shape "
        f"{tally}; GiB allocated at the start of each stage and its peak: "
        f"{mem.line()}")
    timer = StageTimer(dev)
    state, losses, skips, wall = _train_run(
        step, state, batch, steady, lambda i: at(1 + i),
        TRAIN1600_SETTLE + TRAIN1600_TIMED, timer, TRAIN1600_SETTLE)
    losses = np.concatenate([[float(m0["total_loss"])], losses])
    peak = max(torch.cuda.max_memory_allocated() / 2**30,
               *mem.peaks.values())
    first5, last5 = losses[:5].mean(), losses[-5:].mean()
    ok_s = bool(np.isfinite(losses).all()) and last5 < first5 and skips == 0
    sps = TRAIN1600_TIMED / wall
    stages = {k: v["mean"] for k, v in timer.summary().items()}
    log(f"train1600 ToC3D_faster_1600 batch {b} x {n} views 1600x800, view "
        f"scan (a view a chunk), {len(losses)} steps on one batch: losses "
        f"{[round(float(v), 4) for v in losses]}; first 5 mean "
        f"{first5:.4f}, last 5 mean {last5:.4f}; nonfinite_skips {skips}; "
        f"{sps:.4f} steps/s, {b * sps:.4f} samples/s, "
        f"{wall / TRAIN1600_TIMED * 1e3:.3f} ms/step wall "
        f"({TRAIN1600_TIMED} timed); peak memory {peak:.3f} GiB "
        f"{'ok' if ok_s else 'FAIL'}")
    log("train1600 ms a step by stage (CUDA events, mean over "
        f"{TRAIN1600_TIMED} steps): "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    out = results["train1600"] = dict(
        default=dict(steps_per_s=sps, samples_per_s=b * sps, peak_gib=peak,
                     stage_ms=stages, launches=got, stage_peak_gib=mem.peaks))


    # the backbone alone under each regime: what the view scan bounds
    noise = noise_from(3)(0)
    alone = {label: backbone_peak(model, state.memory, batch, steady, noise,
                                  **opts)
             for label, opts in [("view scan (default)", dict(view_scan=True))]
             + [(label, opts) for label, opts, _ in TRAIN1600_REGIMES]}
    del noise
    out["backbone_alone"] = alone
    log("train1600 the backbone alone, forward and backward (GiB allocated "
        "before it, peak above that, ms): " + json.dumps(
            {k: [round(v["start_gib"], 3), round(v["peak_above_gib"], 3),
                 round(v["ms"], 1)] for k, v in alone.items()}))

    # (d): the other regimes on the same state
    ok_r = True
    for label, opts, views_a_chunk in TRAIN1600_REGIMES:
        step = tr.make_train_step(tx, **opts)
        at = noise_from(2)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem = None
        try:
            state, m0, got, want, tally, ok_c, mem = counted_step(
                step, state, at(0), views_a_chunk)
            state, losses, skips, wall = _train_run(
                step, state, batch, steady, lambda i: at(1 + i),
                REGIME_TIMED)
        except torch.cuda.OutOfMemoryError as e:
            rec = dict(oom=str(e).splitlines()[0][:200],
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            log(f"train1600 regime {label}: out of memory "
                f"({rec['oom']}); peak before it {rec['peak_gib']:.3f} GiB")
        else:
            peak = max(torch.cuda.max_memory_allocated() / 2**30,
                       *mem.peaks.values())
            good = ok_c and bool(np.isfinite(losses).all()) and skips == 0
            rec = dict(steps_per_s=REGIME_TIMED / wall,
                       samples_per_s=b * REGIME_TIMED / wall, peak_gib=peak,
                       launches=got, stage_peak_gib=mem.peaks)
            log(f"train1600 regime {label}: launches {got} (expected "
                f"{want}), per shape {tally}; GiB at the start of each "
                f"stage and its peak {mem.line()}; {REGIME_TIMED} steps "
                f"{rec['steps_per_s']:.4f} steps/s, "
                f"{rec['samples_per_s']:.4f} samples/s, peak memory "
                f"{peak:.3f} GiB, losses "
                f"{[round(float(v), 4) for v in losses]} "
                f"{'ok' if good else 'FAIL'}")
            ok_r &= good
        out[label] = rec
        gc.collect()

    # (e): the default step under the profiler, then timed after it
    def profiled(i):
        nonlocal state
        state, _ = default_step(state, batch, at(100 + i), steady=steady)
    at = noise_from(4)
    out["default"]["profile"] = train_profile(profiled, tag="train1600")
    state, losses, skips, wall = _train_run(
        default_step, state, batch, steady, lambda i: at(200 + i),
        REGIME_TIMED + 1, settle=1)
    out["default"]["steps_per_s_after_profiler"] = REGIME_TIMED / wall
    log(f"train1600 default after a profiler session: "
        f"{REGIME_TIMED / wall:.4f} steps/s ({REGIME_TIMED} steps; "
        f"{TRAIN1600_TIMED} before it: {sps:.4f})")
    del model, state, tx, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    ok = ok_k and ok_l and ok_s and ok_r
    log(f"phase_train_1600: kernels {ok_k}, launches {ok_l}, steps {ok_s}, "
        f"regimes {ok_r}; {out['wall_s']:.1f} s | {nvidia_smi_line()}")
    return ok


# ---------------------------------------------------------------------------
# the matchers and the closed loop (phase_traineval)
# ---------------------------------------------------------------------------

AUCTION_ROW = dict(name="auction", route="cuda",
                   source="toc3d_tpu_torch/csrc/auction.cu",
                   replaces="toc3d_tpu/core/auction.py:103")
# a bid scans its row once: a subtraction and two comparisons a query
AUCTION_OPS_PER_VALUE = 3
# JAX's bounds against the exact LAP (tests/test_auction_scale.py:72-76,
# 100): relative gap of the total cost, the absolute one at planted near
# ties, and the share of slots that agree where JAX asks it
AUCTION_REL_GAP = 1e-4
AUCTION_AGREE = 0.999
CLOSEDLOOP_ITERS = 150


def auction_realistic_cost(rng, q, g, num_classes=10):
    """tests/test_auction_scale.realistic_cost in the port's cost terms:
    focal + L1 costs of a mid-training model, each GT with 2-4
    near-duplicate competitive queries, background elsewhere. (q, g)
    numpy."""
    import numpy as np
    import torch
    from toc3d_tpu_torch.core.assigner import focal_cls_cost, l1_cost
    logits = rng.randn(q, num_classes).astype(np.float32) * 0.5 - 4.0
    boxes = rng.randn(q, 10).astype(np.float32)
    gt_labels = rng.randint(0, num_classes, (g,))
    gt_codes = rng.randn(g, 10).astype(np.float32)
    for j in range(g):
        for _ in range(rng.randint(2, 5)):
            i = rng.randint(0, q)
            logits[i, gt_labels[j]] = 2.0 + rng.randn() * 0.5
            boxes[i] = gt_codes[j] + rng.randn(10).astype(np.float32) * 0.05
    t = lambda a: torch.from_numpy(a)[None]
    cls_c = focal_cls_cost(t(logits), t(gt_labels), weight=2.0)
    reg_c = l1_cost(t(boxes) * 0.5, t(gt_codes) * 0.5, 0.25)
    return (cls_c + reg_c)[0].numpy().astype(np.float32)


def auction_cases():
    """JAX's auction test problems as (tag, cost (B, Q, G), n_valid (B,),
    kind): kind 'scale' asks the LAP's agreement too, 'ties' the absolute
    gap bound of planted near ties. tests/test_auction.py: 20 random
    problems (persons 2-23, objects 32-127) and a padded batch (8, 3, 0
    valid of 8 at 40 queries); tests/test_auction_scale.py: Q 900 padded
    to G 96 with 8, 32 and 96 valid (4 problems each) and 32 GTs with
    planted near ties."""
    import numpy as np
    rng = np.random.RandomState(0)
    for trial in range(20):
        p, o = rng.randint(2, 24), rng.randint(32, 128)
        cost = rng.randn(p, o).astype(np.float32) * rng.uniform(0.5, 20)
        yield (f"random {p}x{o}", np.ascontiguousarray(cost.T)[None],
               np.array([p], np.int32), "random")
    rng = np.random.RandomState(1)
    yield ("padded 3x40x8", rng.randn(3, 40, 8).astype(np.float32) * 5,
           np.array([8, 3, 0], np.int32), "random")
    for g in (8, 32, 96):
        rng = np.random.RandomState(g)
        costs = np.full((4, 900, 96), 1e6, np.float32)
        for i in range(4):
            costs[i, :, :g] = auction_realistic_cost(rng, 900, g)
        yield f"scale 900 G{g}/96", costs, np.full((4,), g, np.int32), \
            "scale"
    rng = np.random.RandomState(0)
    q, g = 900, 32
    cost = rng.rand(q, g).astype(np.float32) * 10
    for j in range(0, g, 2):
        i = rng.randint(0, q)
        cost[i, j] = 0.0
        cost[i, j + 1] = 1e-3
        cost[(i + 1) % q, j + 1] = 2e-3
    yield "near ties 900x32", cost[None], np.array([g], np.int32), "ties"


def check_auction(tag, cost, n_valid, kind):
    """The kernel against its plain version (torch.equal on the CPU's
    plain rounds) on one cost tensor (B, Q, G) numpy, and both against the
    native LAP's optimum: every valid slot assigned, no query twice, the
    total cost within JAX's bound (relative gap < 1e-4; at planted near
    ties < 1e-3 + 1e-4 |c|), and for kind 'scale' at least 0.999 of the
    slots as the LAP's. Returns (ok, stats)."""
    import numpy as np
    import torch
    from toc3d_tpu_torch.core.assigner import lsa_host
    from toc3d_tpu_torch.core.auction import auction_plain
    from toc3d_tpu_torch.ops.cuda.auction import auction_match
    dev_cost = torch.from_numpy(cost).cuda()
    dev_nv = torch.from_numpy(n_valid).cuda()
    out = auction_match(dev_cost, dev_nv).cpu()
    stats = {}
    plain = auction_plain(torch.from_numpy(cost), torch.from_numpy(n_valid),
                          stats=stats)
    equal = torch.equal(out, plain)
    lap = lsa_host(cost, n_valid)
    out = out.numpy()
    ok, worst, agree, total = equal, 0.0, 0, 0
    for i, nv in enumerate(n_valid):
        nv = int(nv)
        m = out[i, :nv]
        ok &= bool((out[i, nv:] == -1).all())
        if not nv:
            continue
        if (m < 0).any() or len(set(m.tolist())) != nv:
            ok = False
            continue
        cols = np.arange(nv)
        c_a = float(cost[i, m, cols].astype(np.float64).sum())
        c_l = float(cost[i, lap[i, :nv], cols].astype(np.float64).sum())
        gap = c_a - c_l
        if kind == "ties":
            ok &= gap < 1e-3 + 1e-4 * abs(c_l)
        else:
            rel = gap / max(abs(c_l), 1e-6)
            worst = max(worst, rel)
            ok &= rel < AUCTION_REL_GAP
        agree += int((m == lap[i, :nv]).sum())
        total += nv
    share = agree / total if total else 1.0
    if kind == "scale":
        ok &= share >= AUCTION_AGREE
    return ok, dict(equal=equal, rel_gap=worst, agree=share, **stats)


def phase_traineval(results, captured):
    """The training matchers and the closed loop on the card:
    1. the auction kernel (ops/cuda/auction.auction_match) against its
       plain version, torch.equal, at JAX's test sizes (auction_cases) and
       on the real cost tensors of the ToC3D_faster batch-2 step that
       phase_train captured (six (2, 900, 32) decoder layers and the 2D
       head's (12, 1000, 32)), each within JAX's bound of the native
       LAP's optimum with no duplicate (check_auction);
    2. the step's seven tensors timed: the kernel (one launch a tensor),
       its plain version on the card, the native LAP with its copies (the
       'callback' matcher: no PyTorch call solves an assignment, so the
       kernels line's library_ms is null and this is lap_ms), and the
       bound (the tensors' bytes, or the bids' scans at the f32 peak);
    3. the closed loop (toc3d_tpu_torch.tools.traineval's main, in this
       process) with every count set to 0 just before it and read just
       after: tiny, 150 iterations, resumed at 75, evaluated at 0 and 150
       (JAX's smoke recipe, tests/test_traineval_closedloop.py:56-66):
       resumed, finite metrics in [0, 1], loss_last5_mean < 0.7 x
       loss_first5_mean; A, B, C, D, G and LN launched, AU three times a
       step, no int8 kernel.
    Returns ok."""
    import shutil
    import numpy as np
    import torch
    from toc3d_tpu_torch.core.assigner import hungarian_match
    from toc3d_tpu_torch.core.auction import auction_plain
    from toc3d_tpu_torch.ops.cuda.auction import auction_match
    from toc3d_tpu_torch.tools import traineval

    ok_k = True
    for tag, cost, nv, kind in auction_cases():
        ok, st = check_auction(tag, cost, nv, kind)
        ok_k &= ok
        log(f"check auction {tag}: equal to plain {st['equal']}, worst "
            f"relative gap to the LAP {st['rel_gap']:.3g}, slots as the LAP "
            f"{st['agree']:.4f}, {st['rounds']} rounds, {st['bids']} bids "
            f"{'ok' if ok else 'FAIL'}")
    problems = captured["problems"]
    step_nv = []
    for j, (c, v) in enumerate(problems):
        nv = v.sum(dim=1).to(torch.int32)
        step_nv.append(nv)
        ok, st = check_auction(f"step {j} {tuple(c.shape)}",
                               c.cpu().numpy(), nv.cpu().numpy(), "step")
        ok_k &= ok
        st["shape"] = tuple(c.shape)
        captured.setdefault("stats", []).append(st)
        log(f"check auction ToC3D_faster step tensor {j} {tuple(c.shape)}: "
            f"equal to plain {st['equal']}, relative gap to the LAP "
            f"{st['rel_gap']:.3g}, slots as the LAP {st['agree']:.4f}, "
            f"{st['rounds']} rounds, {st['bids']} bids "
            f"{'ok' if ok else 'FAIL'}")

    # the step's seven tensors, timed
    def kernel():
        for (c, _), nv in zip(problems, step_nv):
            auction_match(c, nv)
    ms = cuda_time(kernel, reps=10)
    plain_ms = cuda_time(lambda: [auction_plain(c, nv) for (c, _), nv
                                  in zip(problems, step_nv)], reps=1,
                         warmup=1)
    lap_ms = cuda_time(lambda: hungarian_match(problems, impl="callback"),
                       reps=10)
    match_ms = cuda_time(lambda: hungarian_match(problems, impl="auction"),
                         reps=10)
    nbytes = sum(c.numel() * 4 + c.shape[0] * 4 + c.shape[0] * c.shape[2] * 4
                 for c, _ in problems)
    ops = sum(st["bids"] * c.shape[1] * AUCTION_OPS_PER_VALUE
              for (c, _), st in zip(problems, captured["stats"]))
    t_mem = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_mem else \
        (t_mem, "bytes")
    results["AU"] = dict(
        AUCTION_ROW, launches=captured["launches"], max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, lap_ms=lap_ms,
        shape=[list(c.shape) for c, _ in problems])
    log(f"time auction, the ToC3D_faster step's {len(problems)} cost "
        f"tensors: kernel {ms:.4f} ms ({len(problems)} launches), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
        f"{nbytes} bytes, {ops} operations), hungarian_match 'auction' "
        f"{match_ms:.4f} ms, 'callback' (native LAP, copies included) "
        f"{lap_ms:.4f} ms")

    # the closed loop
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "traineval_smoke")
    shutil.rmtree(root, ignore_errors=True)
    for f in counters():
        f.launches = 0
    t0 = time.perf_counter()
    rec = traineval.main(["--config", "tiny", "--iters",
                          str(CLOSEDLOOP_ITERS), "--eval-points", "1",
                          "--data-dir", root])["record"]
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in zip(KERNELS, counters())}
    # training and eval run A, B, C, G, LN and the eval's decoder D; the
    # step's matching the auction, three tensors a step at tiny; no int8
    ok_n = (all(launches[k] > 0 for k in ("A", "B", "C", "D", "G", "LN"))
            and launches["AU"] == 3 * CLOSEDLOOP_ITERS
            and all(launches[k] == 0 for k in ("B8", "C8", "H8", "G8")))
    log(f"closed loop launches {launches} {'ok' if ok_n else 'FAIL'}")
    traj = rec["map_trajectory"]
    ok_l = (rec["resumed"] is True
            and [p["iter"] for p in traj] == [0, CLOSEDLOOP_ITERS]
            and all(math.isfinite(p[k]) and 0.0 <= p[k] <= 1.0
                    for p in traj for k in ("mAP", "NDS", "mAP_present",
                                            "NDS_present"))
            and rec["loss_last5_mean"] < 0.7 * rec["loss_first5_mean"]
            and rec["matcher"] == "auction" and ok_n)
    log(f"closed loop on the card (tiny, bf16, {CLOSEDLOOP_ITERS} "
        f"iterations, resumed at {CLOSEDLOOP_ITERS // 2}, matcher "
        f"{rec['matcher']}): resumed {rec['resumed']}, loss "
        f"{rec['loss_first5_mean']} -> {rec['loss_last5_mean']}, trajectory "
        f"{traj}, {wall:.1f} s {'ok' if ok_l else 'FAIL'}")
    log(f"phase_traineval: auction kernel {ok_k}, closed loop {ok_l}")
    return ok_k and ok_l


PARALLEL_WORLD = 2          # ranks of the gloo check, sharing the card
PARALLEL_FRAMES = 3         # view-sharded frames at world 1, bf16 and int8
PARALLEL_TIMED = 5          # DP steps timed at world 1, after one to settle
# The two gloo ranks' DP step (batch 1 a rank) against one process's step on
# the global batch of 2, in bf16 on the card: the products run at other row
# counts, so cuBLAS rounds them otherwise, and under random weights the
# token routing's near ties then go either way (routing_flips counts them).
# Measured by this phase on an NVIDIA H100 80GB HBM3 at 700 W, with the
# lanes of dp_train_batch: 444 of 1368 windows keep another token set, the
# total loss 9.0e-3 apart, the worst loss term 0.081 (d1.loss_bbox), the
# gradient norm 0.115, all gradients as one vector 0.257 (relative L2).
# The bounds below are about twice those: they catch a gross fault (a loss
# off by the world size), not a normalizer off by a lane's share of the
# counts. What holds the normalizers on the card is the check against each
# lane stepped alone, normalized by the global batch's counts, bit for bit
# (_against_lanes).
DP_BATCH2_TOL = {"total_loss": 0.02, "loss": 0.2, "grad_norm": 0.25,
                 "grad_rel_l2_all": 0.5}


def dp_train_batch(rng, b, n, h, w):
    """train_batch with lanes of unequal counts: lane l keeps 32 - 8 l valid
    3D boxes (so its DN targets differ too) and, in view v, 32 - 4 l - v
    valid 2D boxes. A rank that normalized its losses by its own counts,
    or by the summed counts without the world size, then steps otherwise
    than one normalized as JAX normalizes the global batch."""
    bt = train_batch(rng, b, n, h, w)
    for lane in range(b):
        bt["gt_valid_3d"][lane, 32 - 8 * lane:] = False
        for v in range(n):
            bt["gt_valid_2d"][lane, v, 32 - 4 * lane - v:] = False
    return bt


class RoutingRecorder:
    """Records the training routing while it is entered: for each call of
    ops/trainable.compress_plan (kernel C's top-k in CompressedBlockFn), the
    keep mask of every window (W, ws * ws) and the scores it ranked, one
    row an image."""

    def __enter__(self):
        import torch
        from toc3d_tpu_torch.ops import trainable
        self.mod, self.orig, self.calls = trainable, trainable.compress_plan, []

        def recording(scores, b, h, w, window_size, *rest):
            plan = self.orig(scores, b, h, w, window_size, *rest)
            keep = torch.zeros(plan.slow_idx.shape[0], window_size ** 2,
                               dtype=torch.bool, device=scores.device)
            keep.scatter_(1, plan.slow_idx, True)
            self.calls.append((keep, scores.detach().float().reshape(b, -1)
                               .clone()))
            return plan
        trainable.compress_plan = recording
        return self

    def __exit__(self, *exc):
        self.mod.compress_plan = self.orig


def routing_flips(batch2, lanes) -> dict:
    """The keep decisions of one step on the global batch (a RoutingRecorder)
    against those of each lane stepped alone (one each, in lane order):
    windows whose kept set differs and tokens that moved, of the windows
    compared, and the largest difference of the scores ranked; and per
    routing call, in call order, [windows that differ, windows, largest
    score difference, largest score]."""
    if any(len(lane.calls) != len(batch2.calls) for lane in lanes):
        raise RuntimeError("a lane's step routed another number of times "
                           "than the global batch's")
    by_call = []
    for i, (kb, sb) in enumerate(batch2.calls):
        row = [0, 0, 0.0, float(sb.abs().max())]
        for r, lane in enumerate(lanes):
            kl, sl = lane.calls[i]
            nw, ni = kl.shape[0], sl.shape[0]
            diff = kb[r * nw:(r + 1) * nw] != kl
            row[0] += int(diff.any(1).sum())
            row[1] += nw
            row[2] = max(row[2], float(
                (sb[r * ni:(r + 1) * ni] - sl).abs().max()))
            row.append(int(diff.sum()) // 2)
        by_call.append(row[:4] + [sum(row[4:])])
    return {"routing_windows_flipped": sum(c[0] for c in by_call),
            "routing_tokens_moved": sum(c[4] for c in by_call),
            "routing_windows": sum(c[1] for c in by_call),
            "routing_scores_max_abs_diff": max(c[2] for c in by_call),
            "routing_by_call": [c[:4] for c in by_call]}


class CountsRecorder:
    """Records what runtime/train._global_counts returns while it is
    entered (the summed counts and the world size of each DP step), or,
    given ``counts``, returns those in its place: a single-process step
    over a one-rank group then normalizes as a rank of ``world`` does."""

    def __init__(self, counts=None, world=None):
        self.counts, self.world, self.seen = counts, world, []

    def __enter__(self):
        from toc3d_tpu_torch.runtime import train as tr
        self.orig = tr._global_counts

        def recording(*args):
            if self.counts is not None:
                return self.counts.clone(), self.world
            counts, world = self.orig(*args)
            self.seen.append((counts.clone(), world))
            return counts, world
        tr._global_counts = recording
        return self

    def __exit__(self, *exc):
        from toc3d_tpu_torch.runtime import train as tr
        tr._global_counts = self.orig


def _dp_snapshot(model, state, metrics, grads):
    """Clones of one DP check's outcome: metrics, parameters, the bank and
    the gradients the optimizer read."""
    return {"metrics": {k: v.detach().clone() for k, v in metrics.items()},
            "params": [p.detach().clone() for p in model.parameters()],
            "memory": [t.clone() for t in state.memory],
            "grads": grads}


def _dp_step(cfg, model, sd0, batch, steady, b, n, gen_seed, group,
             timer=None, steps=1, deterministic=False, lanes=None):
    """From the weights sd0 and a fresh optimizer: ``steps`` steps of
    make_train_step on ``lanes`` of a global ``batch`` of b lanes (by
    default all of them, or this rank's when group is given), each step
    drawing the global batch's noise and keeping those lanes, the
    gradients the optimizer read recorded on the first; deterministic:
    under torch.use_deterministic_algorithms (the default backward
    accumulates the third selector's aggregate gradient with atomics, so
    two plain steps differ in its last bits). Returns (snapshot, state,
    step fn)."""
    import torch
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        return _dp_steps(cfg, model, sd0, batch, steady, b, n, gen_seed,
                         group, timer, steps, lanes)
    finally:
        torch.use_deterministic_algorithms(before)


def _dp_steps(cfg, model, sd0, batch, steady, b, n, gen_seed, group, timer,
              steps, lanes):
    import torch
    from toc3d_tpu_torch.models.detector import frame_seed
    from toc3d_tpu_torch.parallel import mesh
    from toc3d_tpu_torch.runtime import train as tr
    dev = batch["img"].device
    model.load_state_dict(sd0)
    tx = tr.make_optimizer(model, total_iters=1000)
    if lanes is None:
        lanes = slice(0, b) if group is None else mesh.local_lanes(b, group)
    state = tr.init_train_state(model, tx, lanes.stop - lanes.start)
    if group is not None:
        mesh.broadcast_train_state(model, state.opt_state, group)
    grads = []
    step_orig = tx.step

    def recording(st, gs):
        if not grads:     # a parameter without a gradient steps on zeros
            grads.extend(torch.zeros_like(p) if g is None
                         else g.detach().clone()
                         for p, g in zip(tx.params, gs))
        return step_orig(st, gs)
    tx.step = recording
    step = tr.make_train_step(tx, group=group)
    gen = torch.Generator(device=dev)
    sub = {k: v[lanes] for k, v in batch.items()}
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        gen.manual_seed(frame_seed(gen_seed, i))
        noise = tr.noise_lanes(tr.draw_train_noise(cfg, b, n, gen, dev,
                                                   gt3=32), lanes, n)
        state, m = step(state, sub, noise, steady=steady,
                        timer=timer if i else None)
        if i == 0:
            snap = _dp_snapshot(model, state, m, grads)
    if steps > 1:       # the steps after the first, on the host's clock
        torch.cuda.synchronize()
        snap["timed_s"] = time.perf_counter() - t0
    tx.step = step_orig
    return snap, state, step


def _grad_err(got, want):
    """Gradient agreement: the largest over tensors of max |got - want| /
    max |want| (and that tensor's index), the largest per-tensor relative
    L2 error ||got - want|| / ||want||, and the relative L2 error of all
    gradients as one vector."""
    worst, at, worst_l2, num, den = 0.0, -1, 0.0, 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        d = a.double() - b.double()
        scale = max(float(b.abs().max()), 1e-30)
        e = float(d.abs().max()) / scale
        if e > worst:
            worst, at = e, i
        dn, bn = float(d.square().sum()), float(b.double().square().sum())
        worst_l2 = max(worst_l2, (dn / max(bn, 1e-60)) ** 0.5)
        num, den = num + dn, den + bn
    return worst, at, worst_l2, (num / max(den, 1e-60)) ** 0.5


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def parallel_world1(results):
    """World size 1 over NCCL, in this process (a FileStore rendezvous):
    one DP step of ToC3D_faster at 800x320, batch 2, against the plain
    make_train_step from the same weights, batch and noise, bit for bit;
    the gradient all-reduce's ms a step and the DP steps/s; the
    view-sharded ToC3D_faster_1600 stream (parallel/infer_spmd) in bf16
    and int8 dynamic against make_infer_fn, bit for bit, with the main
    path's launches. Returns ok."""
    import tempfile
    from dataclasses import replace
    import numpy as np
    import torch
    import torch.distributed as dist
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import (build_detector, init_state,
                                                 make_infer_fn)
    from toc3d_tpu_torch.parallel import mesh
    from toc3d_tpu_torch.parallel.infer_spmd import (make_spmd_infer_fn,
                                                     view_mesh)
    from toc3d_tpu_torch.runtime import train as tr
    from toc3d_tpu_torch.runtime.timer import StageTimer
    store = tempfile.mkdtemp(dir=_build_dir("parallel_smoke"))
    dev = mesh.init_distributed(f"file://{store}/store", 1, 0, "cuda")
    group = dist.group.WORLD
    out = results.setdefault("parallel", {})
    try:
        log(f"parallel world 1: backend {dist.get_backend()}, device {dev}")
        cfg = get_config("ToC3D_faster")
        b, n = 2, 6
        model = build_detector(cfg, device=dev, seed=0)
        sd0 = {k: v.clone() for k, v in model.state_dict().items()}
        batch, steady = tr.batch_to_device(
            dp_train_batch(np.random.RandomState(0), b, n, *cfg.pad_shape),
            dev)
        plain, _, _ = _dp_step(cfg, model, sd0, batch, steady, b, n, 3,
                               None, deterministic=True)
        for f in counters():
            f.launches = 0
        dp, _, _ = _dp_step(cfg, model, sd0, batch, steady, b, n, 3, group,
                            deterministic=True)
        dp_launches = {k: f.launches for k, f in zip(KERNELS, counters())}
        timer = StageTimer(dev)
        timed, _, _ = _dp_step(cfg, model, sd0, batch, steady, b, n, 4,
                               group, timer, steps=1 + PARALLEL_TIMED)
        wall = timed["timed_s"]
        eq = {"metrics": all(torch.equal(v, dp["metrics"][k])
                             for k, v in plain["metrics"].items()),
              "params": all(torch.equal(a, c) for a, c in
                            zip(plain["params"], dp["params"])),
              "bank": all(torch.equal(a, c) for a, c in
                          zip(plain["memory"], dp["memory"])),
              "gradients": all(torch.equal(a, c) for a, c in
                               zip(plain["grads"], dp["grads"]))}
        stages = timer.summary()
        ar = stages["all-reduce"]
        nbytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
        out["world1"] = dict(allreduce_ms=ar["mean"], allreduce_min=ar["min"],
                             allreduce_max=ar["max"],
                             dp_steps_per_s=PARALLEL_TIMED / wall,
                             grad_bytes=nbytes)
        ok_t = all(eq.values()) and dp_launches == TRAIN_PER_STEP
        sps = results.get("train", {}).get("steps_per_s", float("nan"))
        log(f"parallel world 1 (NCCL): DP step of ToC3D_faster, batch {b} x "
            f"{n} views 800x320, against the plain make_train_step step, "
            f"both under deterministic algorithms, bit for bit {eq}, the DP "
            f"step's launches {dp_launches} (expected {TRAIN_PER_STEP}) "
            f"{'ok' if ok_t else 'FAIL'}; then, in the default mode, gradient "
            f"all-reduce ({nbytes / 1e9:.3f} GB of f32 gradients, 25 MB "
            f"buckets) {ar['mean']:.4f} ms a step (min {ar['min']:.4f}, max "
            f"{ar['max']:.4f}, {ar['n']} steps, CUDA events); DP "
            f"{PARALLEL_TIMED / wall:.4f} steps/s over {PARALLEL_TIMED} "
            f"steps after one to settle, beside phase_train's {sps:.4f}; ms "
            "a step by stage " + json.dumps({k: round(v["mean"], 3)
                                             for k, v in stages.items()}))
        del model, sd0, batch, plain, dp, timed
        torch.cuda.empty_cache()

        ok_i = True
        base = get_config("ToC3D_faster_1600")
        int8 = replace(base, backbone=replace(base.backbone, quant="int8"),
                       head=replace(base.head, decoder=replace(
                           base.head.decoder, quant="int8")))
        for label, icfg, per_frame in (("bf16", base, MAIN_PER_FRAME),
                                       ("int8 dynamic", int8,
                                        INT8_PER_FRAME)):
            model = build_detector(icfg, device=dev, seed=0)
            frames = host_frames(4, PARALLEL_FRAMES, icfg.pad_shape)
            _, ref, _ = _stream(make_infer_fn(model),
                                init_state(1, icfg, device=dev), frames)
            vm = view_mesh(6)
            spmd = make_spmd_infer_fn(model, vm)
            for f in counters():
                f.launches = 0
            _, got, ms = _stream(spmd, init_state(1, icfg, device=dev),
                                 frames)
            launches = [f.launches for f in counters()]
            want = [v * len(frames) for v in per_frame]
            equal = [all(torch.equal(a, c) for a, c in zip(
                tuple(gs.memory) + tuple(gd), tuple(rs.memory) + tuple(rd)))
                for (gs, gd), (rs, rd) in zip(got, ref)]
            ok = all(equal) and launches == want
            ok_i &= ok
            out[f"world1 infer {label}"] = dict(ms=ms, launches=launches)
            log(f"parallel world 1 (NCCL): view-sharded ToC3D_faster_1600 "
                f"{label} ({vm.view} rank in the view group, 6 views on it, "
                f"the all-gather between the captured programs), "
                f"{len(frames)} frames: equal to make_infer_fn bit for bit "
                f"per frame {equal}; launches {'/'.join(KERNELS)} {launches}"
                f" (expected {want}); frame ms {[round(t, 3) for t in ms]} "
                f"{'ok' if ok else 'FAIL'}")
            del model, ref, got, spmd
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return ok_t and ok_i


def parallel_rank(rank, world, store, queue):
    """One of the ranks that share the card over gloo (a spawned process):
    the DP step at batch 1 a rank, rank 0 also the single-process steps it
    is compared with (the batch of 2, each lane alone) and the routing
    between them; both ranks' parameters compared bit for bit; then the view-sharded ToC3D_faster_1600 frames, 6 / world views a
    rank, rank 0 against make_infer_fn. Puts its report on ``queue``."""
    try:
        queue.put((rank, _parallel_rank(rank, world, store)))
    except Exception as e:      # reported by the parent, which fails
        import traceback
        queue.put((rank, {"error": f"{e!r}\n{traceback.format_exc()}"}))


def _parallel_rank(rank, world, store):
    import numpy as np
    import torch
    import torch.distributed as dist
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import (build_detector, init_state,
                                                 make_infer_fn)
    from toc3d_tpu_torch.parallel import mesh
    from toc3d_tpu_torch.parallel.infer_spmd import (make_spmd_infer_fn,
                                                     view_mesh)
    from toc3d_tpu_torch.runtime import train as tr
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    group = dist.group.WORLD
    solo = dist.new_group([0])      # rank 0's single-process references
    dev = torch.device("cuda", 0)
    rep = {"backend": dist.get_backend()}
    try:
        cfg = get_config("ToC3D_faster")
        b, n = world, 6
        model = build_detector(cfg, device=dev, seed=0)
        sd0 = {k: v.clone() for k, v in model.state_dict().items()}
        batch, steady = tr.batch_to_device(
            dp_train_batch(np.random.RandomState(0), b, n, *cfg.pad_shape),
            dev)
        plain = lane_runs = summed = None
        if rank == 0:
            # one process on the global batch, over a group of itself: the
            # data-parallel code path with nothing to sum, which reads the
            # global batch's counts (JAX's normalizers) as one process
            with CountsRecorder() as seen, RoutingRecorder() as rt_b2:
                plain, _, _ = _dp_step(cfg, model, sd0, batch, steady, b, n,
                                       3, solo, deterministic=True)
            summed = seen.seen[0][0]
            lane_runs, routes = [], []
            for r in range(world):
                with CountsRecorder(summed, world), RoutingRecorder() as rt:
                    lane_runs.append(_dp_step(
                        cfg, model, sd0, batch, steady, b, n, 3, solo,
                        deterministic=True, lanes=slice(r, r + 1))[0])
                routes.append(rt)
            rep.update(routing_flips(rt_b2, routes))
            del rt_b2, routes
        t0 = time.perf_counter()
        with CountsRecorder() as seen:
            dp, _, _ = _dp_step(cfg, model, sd0, batch, steady, b, n, 3,
                                group, deterministic=True)
        torch.cuda.synchronize()
        rep["dp_step_s"] = time.perf_counter() - t0
        rep["dp_counts"] = seen.seen[0][0].tolist()
        rep["dp_world"] = seen.seen[0][1]
        if rank == 0:
            rep["batch2_counts"] = summed.tolist()
            rep["counts_equal"] = torch_equal(seen.seen[0][0], summed)
        names = sorted(dp["metrics"])
        mean = mesh.reduce_mean(torch.stack(
            [dp["metrics"][k].float() for k in names]), group)
        norms = mesh.gather_lanes(dp["metrics"]["grad_norm"].reshape(1),
                                  group)
        rep["grad_norm_equal"] = bool((norms == norms[0]).all())
        same = torch.ones((), device=dev)
        for p in dp["params"]:
            other = p.clone()
            dist.broadcast(other, 1, group=group)
            same *= torch.equal(other, p)
        rep["params_equal"] = bool(same)
        if rank == 0:
            rep.update(_against_batch2(model, names, mean, dp, plain))
            rep.update(_against_lanes(names, mean, dp, lane_runs, world))
        del model, sd0, batch, plain, dp, lane_runs, summed, seen
        torch.cuda.empty_cache()

        icfg = get_config("ToC3D_faster_1600")
        model = build_detector(icfg, device=dev, seed=0)
        frames = host_frames(4, 2, icfg.pad_shape)
        vm = view_mesh(6)
        spmd = make_spmd_infer_fn(model, vm)
        for f in counters():
            f.launches = 0
        _, got, ms = _stream(spmd, init_state(1, icfg, device=dev), frames)
        rep["infer_launches"] = {k: f.launches
                                 for k, f in zip(KERNELS, counters())}
        rep["infer_ms"], rep["views_per_rank"] = ms, 6 // vm.view
        if rank == 0:
            _, ref, _ = _stream(make_infer_fn(model),
                                init_state(1, icfg, device=dev), frames)
            rep["infer_bit_equal"] = [all(torch.equal(a, c) for a, c in zip(
                tuple(gs.memory) + tuple(gd), tuple(rs.memory) + tuple(rd)))
                for (gs, gd), (rs, rd) in zip(got, ref)]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return rep


def _against_batch2(model, names, mean, dp, plain) -> dict:
    """The DP step (the ranks' mean of each metric, the averaged
    gradients) against one process's step on the global batch of 2."""
    want = {k: float(v) for k, v in plain["metrics"].items()}
    got = dict(zip(names, (float(v) for v in mean)))
    errs = {k: _rel(got[k], want[k]) for k in want}
    losses = {k: v for k, v in errs.items()
              if k not in ("grad_norm", "nonfinite_skips")}
    g_err, at, l2, l2_all = _grad_err(dp["grads"], plain["grads"])
    return {"batch2_loss_rel_err": max(losses.values()),
            "batch2_worst_loss": max(losses, key=losses.get),
            "batch2_total_loss_rel_err": errs["total_loss"],
            "batch2_grad_norm_rel_err": errs["grad_norm"],
            "batch2_grad_max_err": g_err,
            "batch2_worst_grad": [k for k, _ in
                                  model.named_parameters()][at],
            "batch2_grad_rel_l2_max": l2, "batch2_grad_rel_l2_all": l2_all,
            "batch2_bank_lane0_equal": [torch_equal(a[0], c[0]) for a, c in
                                        zip(plain["memory"], dp["memory"])]}


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def _against_lanes(names, mean, dp, lane_runs, world) -> dict:
    """The DP step against one process stepping each lane alone at batch 1
    (the same products, row for row, as each rank's), each lane's losses
    normalized by the global batch's counts and the world size (the counts
    read by the one-process step on the global batch, CountsRecorder): the
    lanes' gradients summed and divided by the world size, their metrics
    averaged as mesh.reduce_mean averages (each divided, then summed), the
    gradient norm that of the averaged gradients. The lanes' counts differ
    (dp_train_batch), so a rank that normalized otherwise differs here.
    Returns whether metrics, gradients and the rank's bank lane are
    equal."""
    import torch
    grads = [sum(gs) / world for gs in zip(*(run["grads"]
                                            for run in lane_runs))]
    # the norm AdamW.step takes of the averaged gradients
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    want = [norm if k == "grad_norm" else
            sum(run["metrics"][k].float() / world for run in lane_runs)
            for k in names]
    bad = [k for k, a, c in zip(names, mean, want) if not torch.equal(a, c)]
    return {"lanes_metrics_equal": not bad, "lanes_metrics_differ": bad,
            "lanes_grads_equal": all(torch.equal(a, c) for a, c in
                                     zip(dp["grads"], grads)),
            "lanes_bank_equal": all(torch.equal(a, c) for a, c in
                                    zip(dp["memory"],
                                        lane_runs[0]["memory"]))}


def parallel_two_ranks(results):
    """Two ranks spawned on the one card over gloo (the card's machine has
    one H100 and NCCL refuses two ranks on one device): the multi-rank
    logic with the kernels in it, not a speed figure."""
    import tempfile
    import torch.multiprocessing as mp
    store = os.path.join(tempfile.mkdtemp(dir=_build_dir("parallel_smoke")),
                         "store")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=parallel_rank,
                         args=(r, PARALLEL_WORLD, store, queue))
             for r in range(PARALLEL_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        reps = dict(queue.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    results.setdefault("parallel", {})["two_ranks"] = reps
    for r in sorted(reps):
        log(f"parallel {PARALLEL_WORLD} ranks on the card over gloo, rank "
            f"{r}: {json.dumps(reps[r], default=str)}")
    if any("error" in rep for rep in reps.values()):
        return False
    r0 = reps[0]
    tol = DP_BATCH2_TOL
    ok_b2 = (r0["batch2_total_loss_rel_err"] <= tol["total_loss"]
             and r0["batch2_loss_rel_err"] <= tol["loss"]
             and r0["batch2_grad_norm_rel_err"] <= tol["grad_norm"]
             and r0["batch2_grad_rel_l2_all"] <= tol["grad_rel_l2_all"])
    ok_ln = (r0["lanes_metrics_equal"] and r0["lanes_grads_equal"]
             and r0["lanes_bank_equal"] and r0["counts_equal"]
             and all(rep["dp_world"] == PARALLEL_WORLD
                     for rep in reps.values()))
    ok_eq = all(rep["params_equal"] and rep["grad_norm_equal"]
                for rep in reps.values())
    want = {"A": 2, "B": 12, "C": 36, "D": 24}
    ok_i = all(all(rep["infer_launches"][k] == v for k, v in want.items())
               for rep in reps.values()) and all(r0["infer_bit_equal"])
    log(f"parallel {PARALLEL_WORLD} ranks over gloo on one card, {wall:.1f} "
        f"s: DP step of ToC3D_faster at batch 1 a rank (deterministic "
        f"algorithms) against one process at batch 2: total loss (the "
        f"ranks' mean) rel err {r0['batch2_total_loss_rel_err']:.3e}, worst "
        f"loss term {r0['batch2_loss_rel_err']:.3e} "
        f"({r0['batch2_worst_loss']}), grad_norm "
        f"{r0['batch2_grad_norm_rel_err']:.3e}, gradients relative L2 "
        f"{r0['batch2_grad_rel_l2_all']:.3e} (worst tensor "
        f"{r0['batch2_grad_rel_l2_max']:.3e}, {r0['batch2_worst_grad']}), "
        f"bounds {tol} {'ok' if ok_b2 else 'FAIL'}; the routing of the "
        f"lanes stepped alone against the batch-2 step's: "
        f"{r0['routing_windows_flipped']} of {r0['routing_windows']} windows "
        f"keep another set, {r0['routing_tokens_moved']} tokens moved, "
        f"scores {r0['routing_scores_max_abs_diff']:.3e} apart at most "
        f"(by call, [windows that differ, windows, largest score "
        f"difference, largest score]: {r0['routing_by_call']}); the "
        f"lanes' counts summed by the all-reduce {r0['dp_counts']} against "
        f"the batch-2 step's {r0['batch2_counts']}, equal "
        f"{r0['counts_equal']}; against each lane stepped alone in one "
        f"process, normalized by those counts and the world size: metrics, "
        f"gradients, bank bit for bit "
        f"{[r0['lanes_metrics_equal'], r0['lanes_grads_equal'], r0['lanes_bank_equal']]}"
        f" {'ok' if ok_ln else 'FAIL'}; parameters and grad_norm equal on "
        f"both ranks {'ok' if ok_eq else 'FAIL'}; view-sharded "
        f"ToC3D_faster_1600, {r0['views_per_rank']} views a rank, 2 frames: "
        f"launches A/B/C/D a rank "
        f"{[[rep['infer_launches'][k] for k in 'ABCD'] for rep in reps.values()]}"
        f" (expected {list(want.values())}), against make_infer_fn bit for "
        f"bit {r0['infer_bit_equal']} {'ok' if ok_i else 'FAIL'}")
    return ok_b2 and ok_ln and ok_eq and ok_i


def _build_dir(name: str) -> str:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        name)
    os.makedirs(path, exist_ok=True)
    return path


def phase_parallel(results):
    """Multi-GPU paths of the port on a one-card machine (parallel/): world
    size 1 over NCCL (parallel_world1), then two ranks sharing the card
    over gloo (parallel_two_ranks). Prints the phase's wall time and the
    nvidia-smi line. Returns ok."""
    import torch
    t0 = time.perf_counter()
    ok1 = parallel_world1(results)
    torch.cuda.empty_cache()
    ok2 = parallel_two_ranks(results)
    wall = time.perf_counter() - t0
    results.setdefault("parallel", {})["wall_s"] = wall
    log(f"phase_parallel: world 1 over NCCL {ok1}, {PARALLEL_WORLD} ranks "
        f"over gloo {ok2}, {wall:.1f} s wall | {nvidia_smi_line()}")
    return ok1 and ok2


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

    if sys.argv[1:2] == ["--qkv-handoff"]:
        # the QKV hand-off alone, beside another checkout's window
        # attention when its tree is given
        from toc3d_tpu_torch.ops.cuda import build
        build.build_all(["vit_block"])
        g = torch.Generator(device="cuda").manual_seed(6)
        with torch.no_grad():
            ok = check_qkv_handoff(get_config("ToC3D_faster_1600").backbone,
                                   g, sys.argv[2] if sys.argv[2:] else None)
        log(smi)
        log(json.dumps({"ok": ok}))
        return 0 if ok else 1
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
        torch.cuda.empty_cache()
        ok_am = phase_alt_modules(results)
        ok_e = phase_eval()
        ok_bf = phase_bench_fps()
        ok_gb = phase_gumbel()
        ok_s = all([phase_small_agreement(),
                    phase_small_agreement(plain=True)])
        ok_s8 = all([phase_small_agreement("dynamic"),
                     phase_small_agreement("static")])
        torch.cuda.empty_cache()
        ok_x = phase_export(results)
        torch.cuda.empty_cache()
        ok_pt = phase_pretrained(results)
    torch.cuda.empty_cache()
    captured = {}
    ok_t = phase_train(results, captured)
    torch.cuda.empty_cache()
    ok_t16 = phase_train_1600(results)
    torch.cuda.empty_cache()
    ok_te = phase_traineval(results, captured)
    torch.cuda.empty_cache()
    ok_pl = phase_parallel(results)
    if not (ok_k and ok_k8 and ok_ps and ok_m and ok_m8 and ok_p and ok_am
            and ok_e and ok_bf and ok_gb and ok_s and ok_s8 and ok_x and ok_pt
            and ok_t and ok_t16 and ok_te and ok_pl):
        log(f"chip_smoke: FAILED (kernels {ok_k}, int8 kernels {ok_k8}, "
            f"other presets' kernel shapes {ok_ps}, main path {ok_m}, int8 "
            f"main path {ok_m8}, other presets' paths {ok_p}, modules "
            f"outside the shipped configs {ok_am}, streaming "
            f"eval {ok_e}, bench {ok_bf}, gumbel eval mask {ok_gb}, "
            f"small-input agreement {ok_s}, int8 small-input agreement "
            f"{ok_s8}, export {ok_x}, warm start {ok_pt}, training {ok_t}, "
            f"training at "
            f"1600x800 {ok_t16}, matchers and closed loop {ok_te}, "
            f"multi-GPU {ok_pl})")
        return 1
    keys = ("name", "op", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "shapes", "frame", "regime")
    rows = [k for k in KERNELS if k in results] + [D900_ROW] + [
        r for r in results if " train" in r]
    ops = kernel_ops()
    for r in rows:
        results[r]["op"] = ops.get(r.split()[0])
    log(json.dumps({"kernels": [
        {k: results[r][k] for k in keys + ("lap_ms",) if k in results[r]}
        for r in rows]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
