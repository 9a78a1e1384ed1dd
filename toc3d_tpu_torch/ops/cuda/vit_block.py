"""EVA-02 block kernels (kernels B and C, and their int8 forms B8 and C8;
source csrc/vit_block.cu).

B replaces toc3d_tpu/ops/pallas/vit_block.py :: fused_full_block (:602) and
C replaces :: fused_compressed_block (:819). Both TPU kernels compute one
whole block per window in VMEM; here each is a chain of hand-written CUDA
launches (LayerNorm, tensor-core GEMM with fused epilogues, window
attention, and for C the gather/merge and scatter/update kernels). See the
note at the top of csrc/vit_block.cu for the bound and the design.

Their bf16 matmuls all go through one GEMM, kernel G (``gemm_bf16``, source
csrc/gemm_sm90.cuh): TMA loads into a shared-memory ring, wgmma from shared
memory, a producer warpgroup and two consumer warpgroups, a persistent grid.
It stands in for the bf16 jnp.dot products of _attention and _swiglu
(vit_block.py:113-116, 150, 163-164, 176) inside _full_block_kernel and
_compressed_block_kernel.

B8 and C8 are the int8 bodies of the same two pallas_calls
(quantize_block_params :201, _actquant :271, _qmm :277): the seven weight
matmuls take int8 weights (per output channel) and int8 activations,
quantized per row (dynamic) or at the block's four calibrated site scales
(static, when the block carries ``act_scales``). The chain is B's and C's
with kernel G8 (``int8.gemm_s8_sm90``, G's int8 form: wgmma s32.s8.s8 on
the same pipeline) for the GEMM, a quantizing LayerNorm for the attn_in /
mlp_in / ffn_in sites and a row-quantization kernel for proj_in; window
attention, gather/merge and scatter/update stay bf16, as JAX quantizes only
the seven weight matmuls.

The plain versions below restate the same function with the kernels'
rounding points (bf16 activations between matmuls, f32 accumulation and
statistics, and for an int8 pack the exact int8 product of ops/cuda/int8);
on the CPU in f32 they are the JAX block math.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ...layers import layer_norm
from ..gather import batch_index_fill, batch_index_select
from ..rope import rotate_half
from ..window import pad_hw, window_partition, window_unpartition
from . import (cached_pack, check_cuda, check_pairs, check_res, param_key,
               tma_out)
from .build import call, stream_of
from .int8 import (gemm_s8_sm90, int8_dot, quantize_weight, row_quant,
                   rowquant, statquant)

LN_EPS = 1e-6


class BlockWeights(NamedTuple):
    """Kernel-ready weights of one block. wqkv stacks q (pre-scaled by
    d^-0.5, as the TPU kernel folds it, vit_block.py:287-322), k and v;
    w12 interleaves the SwiGLU w1/w2 rows (2j = w1[j], 2j+1 = w2[j]) and is
    zero-padded to 2 * hidden_pad rows; w3 is zero-padded to hidden_pad
    columns. Matrices are in the activation dtype, or int8 in an int8 pack,
    which adds the per-output-channel scales of each matrix, laid out like
    its rows, and ``act``: the four static activation scales in SITES order
    (None: dynamic per-row quantization). Vectors are f32."""
    ln1w: torch.Tensor
    ln1b: torch.Tensor
    wqkv: torch.Tensor
    bqkv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    ln2w: torch.Tensor
    ln2b: torch.Tensor
    w12: torch.Tensor
    b12: torch.Tensor
    flw: torch.Tensor
    flb: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    hidden: int
    sqkv: Optional[torch.Tensor] = None
    so: Optional[torch.Tensor] = None
    s12: Optional[torch.Tensor] = None
    s3: Optional[torch.Tensor] = None
    act: Optional[torch.Tensor] = None


def is_quantized(wts: BlockWeights):
    """False for a float pack; 'dynamic' for an int8 pack that quantizes
    activations per row, 'static' for one with calibrated site scales
    (is_quantized, vit_block.py:192)."""
    if wts.sqkv is None:
        return False
    return "dynamic" if wts.act is None else "static"


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _vec(t):
    return t.detach().float().contiguous()


def _pack(blk, num_heads: int, mat) -> BlockWeights:
    """Pack an models.eva_vit.Block; mat(linear, pre_scale) gives a
    matrix and its channel scales (None unless int8)."""
    a, m = blk.attn, blk.mlp
    f32 = torch.float32
    c = a.q_proj.weight.shape[0]
    dev = a.q_proj.weight.device
    scale = (c // num_heads) ** -0.5
    (wq, sq), (wk, sk), (wv, sv) = (mat(a.q_proj, scale), mat(a.k_proj),
                                    mat(a.v_proj))
    wo, so = mat(a.proj)
    (w1, s1), (w2, s2), (w3, s3) = mat(m.w1), mat(m.w2), mat(m.w3)
    bqkv = torch.cat([a.q_bias.detach().float() * scale,
                      torch.zeros(c, dtype=f32, device=dev),
                      a.v_bias.detach().float()])
    hid = w1.shape[0]
    hp = _round_up(hid, 16)
    w12 = w1.new_zeros(2 * hp, c)
    w12[0:2 * hid:2] = w1
    w12[1:2 * hid:2] = w2
    b12 = torch.zeros(2 * hp, dtype=f32, device=dev)
    b12[0:2 * hid:2] = m.w1.bias.detach().float()
    b12[1:2 * hid:2] = m.w2.bias.detach().float()
    w3p = w3.new_zeros(c, hp)
    w3p[:, :hid] = w3
    quant = {}
    if sq is not None:
        s12 = torch.zeros(2 * hp, dtype=f32, device=dev)
        s12[0:2 * hid:2] = s1
        s12[1:2 * hid:2] = s2
        act = getattr(blk, "act_scales", None)
        quant = dict(sqkv=torch.cat([sq, sk, sv]), so=so, s12=s12, s3=s3,
                     act=None if act is None else _vec(act))

    return BlockWeights(
        _vec(blk.norm1.weight), _vec(blk.norm1.bias),
        torch.cat([wq, wk, wv], 0).contiguous(), bqkv.contiguous(),
        wo.contiguous(), _vec(a.proj.bias), _vec(blk.norm2.weight),
        _vec(blk.norm2.bias), w12.contiguous(), b12.contiguous(),
        _vec(m.ffn_ln.weight), _vec(m.ffn_ln.bias), w3p.contiguous(),
        _vec(m.w3.bias), hid, **quant)


def pack_block_weights(blk, num_heads: int, dtype) -> BlockWeights:
    """Pack an models.eva_vit.Block for kernels B and C, matrices in
    ``dtype`` (cached on the module until its parameters change)."""
    def mat(lin, pre=1.0):
        w = lin.weight.detach()
        return (w.float() * pre).to(dtype) if pre != 1.0 else w.to(dtype), \
            None
    return cached_pack(blk, "block", param_key(blk, dtype, num_heads),
                       lambda: _pack(blk, num_heads, mat))


def pack_block_weights_int8(blk, num_heads: int, dtype) -> BlockWeights:
    """The int8 pack of kernels B8 and C8 (quantize_block_params,
    vit_block.py:201-244): each of the seven matrices, first rounded to the
    activation dtype ``dtype`` (the JAX precast casts the block weights to
    the compute dtype before it quantizes them, detector.py:310-329), then
    quantized per output channel, the d^-0.5 factor folded into q's weights
    before quantizing; static activation scales when the block carries
    ``act_scales`` (models.eva_vit.set_act_scales). Cached on the module
    until its parameters or scales change."""
    def mat(lin, pre=1.0):
        return quantize_weight(lin.weight.detach().to(dtype), pre)
    return cached_pack(blk, "block_int8",
                       param_key(blk, "int8", dtype, num_heads),
                       lambda: _pack(blk, num_heads, mat))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

_SITE = {"qkv": 0, "o": 1, "w12": 2, "w3": 3}   # the site feeding each matrix


def _site_scale(wts: BlockWeights, which: str):
    """The static scale (1 element) of matrix ``which``'s input site, or
    None for dynamic quantization."""
    if wts.act is None:
        return None
    i = _SITE[which]
    return wts.act[i:i + 1]


def _matrix(wts: BlockWeights, which: str):
    """(matrix, channel scales or None, bias) of matrix ``which``."""
    return {"qkv": (wts.wqkv, wts.sqkv, wts.bqkv),
            "o": (wts.wo, wts.so, wts.bo),
            "w12": (wts.w12, wts.s12, wts.b12),
            "w3": (wts.w3, wts.s3, wts.b3)}[which]


def _actquant(x, wts: BlockWeights, which: str):
    """Quantize the (rows, K) input of matrix ``which``: at its site's
    static scale when the pack has them, else per row (_actquant,
    vit_block.py:271)."""
    st = _site_scale(wts, which)
    return rowquant(x) if st is None else statquant(x, st)


def _qmm(q, xs, w, s):
    """int8 x int8 -> exact sum -> f32, dequantized as (acc) * (xs * s)
    (_qmm, vit_block.py:277-284)."""
    return int8_dot(q, w) * (xs * s)


def _mm(wts: BlockWeights, a, which: str):
    """a (rows, K) @ matrix ``which`` of the pack + its bias, f32: the
    product of a and the matrix in f32, or for an int8 pack the int8 product
    of a quantized at its site."""
    w, s, b = _matrix(wts, which)
    w = w[:, :a.shape[-1]]
    if s is None:
        return a.float() @ w.float().t() + b.float()
    return _qmm(*_actquant(a, wts, which), w, s) + b


def _attention_plain(wts: BlockWeights, hid, num_heads: int, rope, pos):
    """hid: (W, n, C) LN1 output -> raw attention delta (W, n, C) in
    hid.dtype: QKV, pairwise RoPE in f32 (at rows ``pos`` of the tables, or
    0..n-1), softmax with f32 statistics, P in the activation dtype, O-proj
    + bias."""
    nw, n, c = hid.shape
    d = c // num_heads
    dt = hid.dtype
    qkv = _mm(wts, hid.reshape(-1, c), "qkv").reshape(nw, n, 3, num_heads, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2].to(dt)
    if rope is not None:
        cos, sin = rope
        if pos is None:
            cos, sin = cos[:n][None, :, None], sin[:n][None, :, None]
        else:
            cos, sin = cos[pos][:, :, None], sin[pos][:, :, None]
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
    q, k = q.to(dt), k.to(dt)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))    # (W, heads, n, d)
    s = q.float() @ k.float().transpose(-1, -2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = ((p.to(dt).float() @ v.float()) / l).to(dt)
    o = o.transpose(1, 2).reshape(nw * n, c)
    return _mm(wts, o, "o").to(dt).reshape(nw, n, c)


def _swiglu_plain(wts: BlockWeights, x):
    """x: (rows, C) residual stream -> raw MLP delta (LN2, gate, sub-LN,
    w3 + bias) in x.dtype."""
    dt = x.dtype
    h = wts.hidden
    acc = _mm(wts, layer_norm(x, wts.ln2w, wts.ln2b, LN_EPS), "w12")
    a = acc[:, 0::2][:, :h].to(dt)
    b = acc[:, 1::2][:, :h].to(dt)
    g = (F.silu(a.float()).to(dt).float() * b.float()).to(dt)
    g = layer_norm(g, wts.flw, wts.flb, LN_EPS)
    return _mm(wts, g, "w3").to(dt)


def _add(a, b):
    """Residual add in the activation dtype (one rounding)."""
    return (a.float() + b.float()).to(a.dtype)


def _full_attention_plain(wts: BlockWeights, x, num_heads: int, ws: int,
                          rope_tables):
    """Attention delta of the full block as a (B, H, W, C) map."""
    b, h, w, c = x.shape
    xw, padded = window_partition(x, ws)
    nw = xw.shape[0]
    hid = layer_norm(xw.reshape(nw, ws * ws, c), wts.ln1w, wts.ln1b, LN_EPS)
    raw1 = _attention_plain(wts, hid, num_heads, rope_tables, None)
    return window_unpartition(raw1.reshape(nw, ws, ws, c), ws, padded,
                              (h, w))


def full_block_plain(wts: BlockWeights, x, num_heads: int, window_size: int,
                     rope_tables):
    b, h, w, c = x.shape
    raw1 = _full_attention_plain(wts, x, num_heads, window_size, rope_tables)
    x1 = _add(x, raw1).reshape(-1, c)
    return _add(x1, _swiglu_plain(wts, x1)).reshape(b, h, w, c)


class CompressPlan(NamedTuple):
    """Per-window token routing of a compressed block (the part that stays
    outside the kernel, as in the JAX package)."""
    slow_idx: torch.Tensor      # (W, k) window-local token indices
    fast_idx: torch.Tensor      # (W, n - k)
    fast_score: torch.Tensor    # (W, n - k)
    k: int
    has_rep: bool


def compress_plan(scores, b: int, h: int, w: int, window_size: int,
                  ratio: float, use_represent: bool,
                  align_k: bool) -> CompressPlan:
    """Window the scores (pads at -1e6, toc3d_vit.py:131), keep count
    (keep_count, with the mxu_align_k option) and the stable descending
    top-k (sample_topk)."""
    from ...models.token_select import keep_count, sample_topk
    ws = window_size
    n = ws * ws
    sw, _ = window_partition(scores.reshape(b, h, w, 1), ws, pad_value=-1e6)
    sw = sw.reshape(-1, n)
    k = keep_count(n, ratio, n_rep=1 if use_represent else 0,
                   mxu_align=align_k)
    _, fast_score, slow_idx, fast_idx = sample_topk(sw, ratio, k=k)
    return CompressPlan(slow_idx, fast_idx, fast_score, k,
                        bool(use_represent and n - k > 0))


def _gather_rows_plain(x, plan: CompressPlan, ws: int):
    """Window x and gather each window's slow rows, plus the representative
    row when the plan has one. Returns (xw (W, n, C), xs (W, kr, C), fast
    (W, n - k, C), pos (W, kr) RoPE rows, padded)."""
    c = x.shape[-1]
    dt = x.dtype
    xw, padded = window_partition(x, ws)
    nw = xw.shape[0]
    xw = xw.reshape(nw, ws * ws, c)
    xs = batch_index_select(xw, plan.slow_idx)
    fast = batch_index_select(xw, plan.fast_idx)
    pos = plan.slow_idx
    if plan.has_rep:
        fs = plan.fast_score.float()
        denom = fs.sum(dim=1, keepdim=True).to(dt).float()
        wgt = (fs / denom).to(dt).float()
        rep = (wgt[..., None] * fast.float()).sum(dim=1, keepdim=True)
        xs = torch.cat([xs, rep.to(dt)], dim=1)
        pos = torch.cat([pos, torch.full_like(pos[:, :1], plan.k)], dim=1)
    return xw, xs, fast, pos, padded


def _rows_attention_plain(wts: BlockWeights, xs, pos, num_heads: int,
                          rope_tables):
    """Attention delta of the compressed rows xs (W, kr, C)."""
    hid = layer_norm(xs, wts.ln1w, wts.ln1b, LN_EPS)
    return _attention_plain(wts, hid, num_heads, rope_tables, pos)


def compressed_block_plain(wts: BlockWeights, x, plan: CompressPlan,
                           num_heads: int, window_size: int, rope_tables):
    b, h, w, c = x.shape
    ws = window_size
    k = plan.k
    xw, xs, fast, pos, padded = _gather_rows_plain(x, plan, ws)
    nw, kr = xs.shape[0], xs.shape[1]
    raw1 = _rows_attention_plain(wts, xs, pos, num_heads, rope_tables)
    s1 = _add(xs, raw1)
    raw2 = _swiglu_plain(wts, s1.reshape(-1, c)).reshape(nw, kr, c)
    y = _add(s1, raw2)
    if plan.has_rep:
        delta = _add(raw1[:, k:k + 1], raw2[:, k:k + 1])
        fast = _add(fast, delta.expand_as(fast))
    out = batch_index_fill(torch.zeros_like(xw), y[:, :k], fast,
                           plan.slow_idx, plan.fast_idx)
    return window_unpartition(out.reshape(nw, ws, ws, c), ws, padded, (h, w))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# the widest row the LayerNorm kernel's instances hold in registers (four
# warps of four accesses of 8 bf16 a thread, or eight warps of eight of 2;
# csrc/vit_block.cu toc3d_layernorm)
LN_MAX_WIDTH = 4096


def ln_access(ld: int, npad: int, *ptrs) -> int:
    """Elements per access of the LayerNorm kernel: 8 (16 bytes) when every
    row stride (ld for x, res and sum_out, npad for the output) is a
    multiple of 8 elements and every base pointer (0 for an absent one) lies
    on 16 bytes, else 2 (4-byte pairs)."""
    if ld % 8 or npad % 8 or any(p % 16 for p in ptrs):
        return 2
    return 8


def _ln(x, ld, wgt, bias, rows, valid_rows, n, npad, y=None, res=None,
        sum_out=None, yq=None, ys=None, sscale=None):
    """Launch the LayerNorm kernel: rows of x (row stride ld; rows past
    valid_rows read as zero) over n columns, + res first, into y or yq
    (rows of npad columns, zero past n)."""
    ptr = lambda t: 0 if t is None else t.data_ptr()
    out = y if y is not None else yq
    vec = ln_access(ld, npad, x.data_ptr(), ptr(res), ptr(sum_out),
                    out.data_ptr(), wgt.data_ptr(), bias.data_ptr())
    call("vit_block", "toc3d_layernorm", x.data_ptr(), ld,
         None if res is None else res.data_ptr(), ld,
         None if sum_out is None else sum_out.data_ptr(), ld,
         wgt.data_ptr(), bias.data_ptr(),
         None if y is None else y.data_ptr(), npad,
         None if yq is None else yq.data_ptr(),
         None if ys is None else ys.data_ptr(),
         None if sscale is None else sscale.data_ptr(), rows, valid_rows, n,
         npad, LN_EPS, vec, stream_of(x))
    layernorm.launches += 1


def gemm_bf16_plain(a, w, bias=None, res=None, out_f32=False, gate=False):
    """Plain version of ``gemm_bf16``: the f32 product of a (M, K) and w
    (N, K)^T plus the f32 bias, then the epilogue at the kernel's rounding
    points in a.dtype: f32 out as is; gate: columns (2j, 2j + 1) rounded,
    silu of the first rounded, times the second, (M, N/2); residual:
    bf16(bf16(v) + res); else bf16(v)."""
    dt = a.dtype
    v = a.float() @ w.float().t()
    if bias is not None:
        v = v + bias.float()
    if gate:
        x1, x2 = v[:, 0::2].to(dt), v[:, 1::2].to(dt)
        return (F.silu(x1.float()).to(dt).float() * x2.float()).to(dt)
    if out_f32:
        return v
    return v.to(dt) if res is None else _add(res, v.to(dt))


def _gemm(a, w, bias, out, m, n, k, res=None, out_f32=False, gate=False):
    """Launch kernel G: out = epilogue(a[:m, :k] @ w^T + bias) with w (n,
    k). TMA reads a and w and writes out, so each needs a 16-byte aligned
    base and a row stride of a multiple of 16 bytes (out may be a column
    slice of a wider matrix; None allocates it); the epilogue works on
    column pairs, reading the f32 bias 8 bytes at a time, so the bias needs
    an 8-byte aligned base. Returns out."""
    check_cuda("gemm_bf16", a, w, dtype=torch.bfloat16)
    if (a.dim() != 2 or w.dim() != 2 or tuple(w.shape) != (n, k)
            or a.shape[0] < m or a.shape[1] < k or a.shape[1] % 8 or k % 8
            or n % 2):
        raise ValueError(
            f"gemm_bf16: unsupported shapes a {tuple(a.shape)}, w "
            f"{tuple(w.shape)} for m {m}, n {n}, k {k} (16-byte rows, K a "
            "multiple of 8, N even)")
    out = tma_out("gemm_bf16", out, m, n // 2 if gate else n,
                  torch.float32 if out_f32 else torch.bfloat16, a.device)
    if bias is not None:
        check_pairs("gemm_bf16", bias, n)
    if res is not None:
        check_res("gemm_bf16", res, m, n)
    call("vit_block", "toc3d_gemm", a.data_ptr(), a.shape[1], w.data_ptr(),
         k, None if bias is None else bias.data_ptr(),
         None if res is None else res.data_ptr(),
         0 if res is None else res.shape[1], out.data_ptr(), out.stride(0),
         m, n, k, int(out_f32), int(gate), stream_of(a))
    _gemm.launches += 1
    return out


def gemm_bf16(a, w, bias=None, res=None, out_f32=False, gate=False,
              out=None):
    """Kernel G alone: a (M, K) bf16 @ w (N, K)^T bf16 + bias (N,) f32,
    then the epilogue: ``out_f32`` (M, N) f32; ``gate`` (M, N/2) bf16 from
    the interleaved SwiGLU pairs; else (M, N) bf16, plus ``res`` (M, N)
    bf16 when given. On a CPU tensor, the plain version."""
    if a.device.type == "cpu":
        return gemm_bf16_plain(a, w, bias, res, out_f32, gate)
    return _gemm(a, w, bias, out, a.shape[0], w.shape[0], a.shape[1],
                 res=res, out_f32=out_f32, gate=gate)


def _ln_in(wts: BlockWeights, which: str, x, ld, wgt, bias, rows, valid_rows,
           n, npad, res=None, sum_out=None, out=None):
    """LayerNorm of the (rows, n) rows of x (row stride ld) as the input of
    matrix ``which``: bf16 (rows, npad) (into ``out`` when given), or for
    an int8 pack the (int8 (rows, npad), scales) pair the int8 GEMM takes,
    quantized by the same kernel."""
    dev = x.device
    if not is_quantized(wts):
        y = out if out is not None else torch.empty(rows, npad, dtype=x.dtype,
                                                    device=dev)
        _ln(x, ld, wgt, bias, rows, valid_rows, n, npad, y=y, res=res,
            sum_out=sum_out)
        return y
    q = torch.empty(rows, npad, dtype=torch.int8, device=dev)
    st = _site_scale(wts, which)
    s = torch.empty(rows, dtype=torch.float32, device=dev) if st is None \
        else st
    _ln(x, ld, wgt, bias, rows, valid_rows, n, npad, res=res,
        sum_out=sum_out, yq=q, ys=None if st is not None else s, sscale=st)
    return q, s


def layernorm_plain(x, weight, bias, res=None, rows=None, n=None):
    """Plain version of ``layernorm``: layers.layer_norm of the first n
    columns of x (+ res, rounded to x.dtype), rows past x's own as zero,
    columns n.. of the output zero."""
    if res is not None:
        x = _add(x, res)
    npad = x.shape[1]
    n = npad if n is None else n
    rows = x.shape[0] if rows is None else rows
    x = F.pad(x[:, :n], (0, 0, 0, rows - x.shape[0]))
    y = layer_norm(x, weight[:n], bias[:n], LN_EPS)
    return F.pad(y, (0, npad - n))


def _ln_check(name, x, weight, bias, res, rows, n, sum_out):
    """The (rows, n) of a standalone LayerNorm call on the card; raises on
    what the kernel does not take."""
    check_cuda(name, x, dtype=torch.bfloat16, aligned=False)
    if x.dim() != 2 or x.data_ptr() % 4:
        raise ValueError(f"{name}: x must be a (rows, width) matrix on a "
                         "4-byte boundary")
    npad = x.shape[1]
    n = npad if n is None else n
    rows = x.shape[0] if rows is None else rows
    if n % 2 or npad % 2 or not 0 < n <= npad or npad > LN_MAX_WIDTH \
            or rows < x.shape[0]:
        raise ValueError(f"{name}: width {n} of {npad} columns for {rows} "
                         f"rows (even widths up to {LN_MAX_WIDTH}, at least "
                         "x's rows)")
    for t in (res, sum_out):
        if t is not None:
            check_cuda(name, t, dtype=torch.bfloat16, aligned=False)
            if t.shape != x.shape or t.data_ptr() % 4:
                raise ValueError(f"{name}: {tuple(t.shape)} beside x "
                                 f"{tuple(x.shape)}")
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    check_cuda(name, w, b, dtype=torch.float32, aligned=False)
    if w.numel() < n or b.numel() < n:
        raise ValueError(f"{name}: weight / bias of {w.numel()} / "
                         f"{b.numel()} for width {n}")
    return rows, n, w, b


def layernorm(x, weight, bias, res=None, rows=None, n=None, sum_out=None,
              out=None):
    """The LayerNorm of B, C, B8 and C8 alone in bf16 (LN1, LN2 and the
    SwiGLU sub-LN): LN of the first n columns (default all) of x (R, npad)
    bf16, of x + res rounded to bf16 when res is given (stored to
    ``sum_out`` when given), for ``rows`` >= R output rows (rows past R
    read as zero, so they are LN(0) = bias) -> (rows, npad) bf16 with zero
    columns past n, into ``out`` when given (``out`` may be x itself:
    in place). Plain version on the CPU. ``layernorm.launches`` counts
    every launch of the LayerNorm kernel, the blocks' own included."""
    if x.device.type == "cpu":
        y = layernorm_plain(x, weight, bias, res, rows, n)
        if sum_out is not None:
            sum_out.copy_(x if res is None else _add(x, res))
        return y if out is None else out.copy_(y)
    rows, n, w, b = _ln_check("layernorm", x, weight, bias, res, rows, n,
                              sum_out)
    npad = x.shape[1]
    if out is None:
        out = torch.empty(rows, npad, dtype=x.dtype, device=x.device)
    elif (out.shape != (rows, npad) or out.dtype != x.dtype
          or not out.is_contiguous() or out.data_ptr() % 4):
        raise ValueError(f"layernorm: out must be a contiguous ({rows}, "
                         f"{npad}) {x.dtype} matrix")
    _ln(x, npad, w, b, rows, x.shape[0], n, npad, y=out, res=res,
        sum_out=sum_out)
    return out


def layernorm_int8_plain(x, weight, bias, static_scale=None, res=None,
                         rows=None, n=None):
    """Plain version of ``layernorm_int8``."""
    y = layernorm_plain(x, weight, bias, res, rows, n)
    if static_scale is None:
        q, s = rowquant(y)
        return q, s.reshape(-1)
    return statquant(y, static_scale)


def layernorm_int8(x, weight, bias, static_scale=None, res=None, rows=None,
                   n=None):
    """The quantizing LayerNorm alone (the attn_in / mlp_in / ffn_in sites
    of B8 and C8): ``layernorm``'s output, as rounded to bf16, quantized
    -> (int8 (rows, npad), f32 scale: per row (rows,), or
    ``static_scale``). Plain version on the CPU."""
    if x.device.type == "cpu":
        return layernorm_int8_plain(x, weight, bias, static_scale, res, rows,
                                    n)
    rows, n, w, b = _ln_check("layernorm_int8", x, weight, bias, res, rows,
                              n, None)
    npad = x.shape[1]
    q = torch.empty(rows, npad, dtype=torch.int8, device=x.device)
    if static_scale is None:
        s = torch.empty(rows, dtype=torch.float32, device=x.device)
    else:
        check_cuda("layernorm_int8", static_scale, dtype=torch.float32,
                   aligned=False)
        s = static_scale
    _ln(x, npad, w, b, rows, x.shape[0], n, npad, res=res, yq=q,
        ys=None if static_scale is not None else s, sscale=static_scale)
    return q, s


def _o_in(wts: BlockWeights, attn):
    """The O-projection's input: the merged attention output, row-quantized
    for an int8 pack (the proj_in site)."""
    return row_quant(attn, _site_scale(wts, "o")) if is_quantized(wts) \
        else attn


def _proj(wts: BlockWeights, inp, which: str, m: int, out, res=None,
          out_f32=False, gate=False):
    """out = epilogue(inp @ matrix ``which`` + bias) over m rows, by kernel
    G or, for an int8 pack, kernel G8 on inp = (int8, scales)."""
    w, s, b = _matrix(wts, which)
    if s is None:
        _gemm(inp, w, b, out, m, w.shape[0], w.shape[1], res=res,
              out_f32=out_f32, gate=gate)
    else:
        gemm_s8_sm90(inp[0], inp[1], w, s, b, res=res, out_f32=out_f32,
                     gate=gate, out=out)
    return out


def _rope_args(rope_tables, n: int, x):
    if rope_tables is None:
        return None, None
    cos, sin = rope_tables
    cos = cos[:n].to(device=x.device, dtype=torch.float32).contiguous()
    sin = sin[:n].to(device=x.device, dtype=torch.float32).contiguous()
    return cos, sin


def _check_block(name, wts: BlockWeights, x, num_heads):
    check_cuda(name, x, dtype=torch.bfloat16)
    check_cuda(name, wts.wqkv, wts.wo, wts.w12, wts.w3,
               dtype=torch.int8 if is_quantized(wts) else torch.bfloat16)
    c = x.shape[-1]
    d = c // num_heads
    align = 16 if is_quantized(wts) else 8
    if c % num_heads or d not in (32, 64) or c % align:
        raise ValueError(f"{name}: unsupported width {c} / {num_heads} "
                         f"heads (head_dim 32 or 64, C % {align} == 0)")
    # the LayerNorm kernel reads bf16 pairs, so the sub-LN width must be even
    if wts.hidden % 2:
        raise ValueError(f"{name}: SwiGLU hidden width {wts.hidden} must be "
                         "even")


def _mlp_chain(wts: BlockWeights, x, m: int, c: int, res=None, ln_res=None,
               sum_out=None):
    """LN2 -> gate GEMM -> sub-LN -> w3 GEMM (+ residual ``res`` when
    given). x: (m, C); with ln_res, LN2 reads x + ln_res and stores that sum
    to sum_out in the same pass. Returns the (m, C) output."""
    dev = x.device
    hp = wts.w3.shape[1]
    h2 = _ln_in(wts, "w12", x, c, wts.ln2w, wts.ln2b, m, m, c, c, res=ln_res,
                sum_out=sum_out)
    g = torch.empty(m, hp, dtype=x.dtype, device=dev)
    _proj(wts, h2, "w12", m, g, gate=True)
    gin = _ln_in(wts, "w3", g, hp, wts.flw, wts.flb, m, m, wts.hidden, hp,
                 out=g)
    out = torch.empty(m, c, dtype=x.dtype, device=dev)
    return _proj(wts, gin, "w3", m, out, res=res)


def window_attention_launch(qkv, out, map_shape, ws: int, nw: int, n: int,
                            num_heads: int, image: bool, pos=None, cos=None,
                            sin=None):
    """Launch the window attention kernel of B, C, B8 and C8 on the f32
    (rows, 3C) qkv of an attention chain into the bf16 (rows, C) ``out``:
    nw windows of n rows of the (B, H, W) map ``map_shape``, by window
    geometry (``image``; qkv's last row is LN(0)'s projection) or as dense
    rows at RoPE positions ``pos``; cos / sin the f32 RoPE tables or None.
    Returns out."""
    b, h, w = map_shape
    c = out.shape[1]
    call("vit_block", "toc3d_window_attention", qkv.data_ptr(),
         None if pos is None else pos.data_ptr(),
         None if cos is None else cos.data_ptr(),
         None if sin is None else sin.data_ptr(), out.data_ptr(), nw, n,
         num_heads, c // num_heads, int(image), b, h, w, ws, stream_of(qkv))
    return out


def _full_attention(wts: BlockWeights, x, num_heads: int, ws: int,
                    rope_tables):
    """LN1 -> QKV -> window attention of the full block on the contiguous
    CUDA map x (B, H, W, C): the (B*H*W, C) attention output before the
    O-projection."""
    b, h, w, c = x.shape
    m, n = b * h * w, ws * ws
    hp_, wp_ = pad_hw(h, w, ws)
    nw = b * (hp_ // ws) * (wp_ // ws)
    dev = x.device
    # row m of the LN output and of qkv is LN(0): the projection every
    # zero-padded edge token reads (the TPU kernel zeroes out-of-image
    # tokens before LN1)
    hin = _ln_in(wts, "qkv", x, c, wts.ln1w, wts.ln1b, m + 1, m, c, c)
    qkv = torch.empty(m + 1, 3 * c, dtype=torch.float32, device=dev)
    _proj(wts, hin, "qkv", m + 1, qkv, out_f32=True)
    cos, sin = _rope_args(rope_tables, n, x)
    attn = torch.empty(m, c, dtype=x.dtype, device=dev)
    return window_attention_launch(qkv, attn, (b, h, w), ws, nw, n,
                                   num_heads, True, cos=cos, sin=sin)


def _rows_attention(wts: BlockWeights, x, plan: CompressPlan, num_heads: int,
                    ws: int, rope_tables):
    """Gather/merge -> LN1 -> QKV -> window attention -> O-proj + bias of the
    compressed block on the contiguous CUDA map x. Returns (xs, raw1, slow,
    fast): the gathered rows and their attention delta, both (W*kr, C), and
    the int32 slow / fast indices."""
    b, h, w, c = x.shape
    n = ws * ws
    k = plan.k
    nw = plan.slow_idx.shape[0]
    nf = plan.fast_idx.shape[1]
    hr = int(plan.has_rep)
    kr = k + hr
    rows = nw * kr
    dev = x.device
    slow32 = plan.slow_idx.to(torch.int32).contiguous()
    fast32 = plan.fast_idx.to(torch.int32).contiguous()
    fscore = plan.fast_score.float().contiguous()
    xs = torch.empty(rows, c, dtype=x.dtype, device=dev)
    call("vit_block", "toc3d_gather_merge", x.data_ptr(), slow32.data_ptr(),
         fast32.data_ptr(), fscore.data_ptr(), xs.data_ptr(), nw, h, w, c, ws,
         k, nf, hr, stream_of(x))
    hin = _ln_in(wts, "qkv", xs, c, wts.ln1w, wts.ln1b, rows, rows, c, c)
    qkv = torch.empty(rows, 3 * c, dtype=torch.float32, device=dev)
    _proj(wts, hin, "qkv", rows, qkv, out_f32=True)
    cos, sin = _rope_args(rope_tables, n, x)
    pos = None
    if cos is not None:
        pos = slow32
        if hr:
            pos = torch.cat([slow32, torch.full_like(slow32[:, :1], k)], 1)
        pos = pos.contiguous()
    attn = torch.empty(rows, c, dtype=x.dtype, device=dev)
    window_attention_launch(qkv, attn, (b, h, w), ws, nw, kr, num_heads,
                            False, pos, cos, sin)
    raw1 = torch.empty(rows, c, dtype=x.dtype, device=dev)
    _proj(wts, _o_in(wts, attn), "o", rows, raw1)
    return xs, raw1, slow32, fast32


def attention_delta_plain(wts: BlockWeights, x, num_heads: int,
                          window_size: int, rope_tables, plan=None):
    """Plain version of ``attention_delta``."""
    if plan is None:
        return _full_attention_plain(wts, x, num_heads, window_size,
                                     rope_tables)
    _, xs, _, pos, _ = _gather_rows_plain(x, plan, window_size)
    return _rows_attention_plain(wts, xs, pos, num_heads, rope_tables)


def attention_delta(blk, x, num_heads: int, window_size: int, rope_tables,
                    plan=None, int8: bool = False):
    """The attention delta (LN1 -> QKV -> RoPE -> window softmax -> O-proj
    + bias, no residual) that fused_full_block (plan None; a (B, H, W, C)
    map) or fused_compressed_block (the (W, kr, C) rows of ``plan``)
    computes on the way, or with int8 their B8 / C8 forms, through the same
    kernels. The block output is mostly residual and MLP, so this is what
    holds the window attention against its plain version. Not counted as a
    block launch."""
    wts = pack_block_weights_int8(blk, num_heads, x.dtype) if int8 else \
        pack_block_weights(blk, num_heads, x.dtype)
    if x.device.type == "cpu":
        return attention_delta_plain(wts, x, num_heads, window_size,
                                     rope_tables, plan)
    x = x.contiguous()
    _check_block("attention_delta", wts, x, num_heads)
    b, h, w, c = x.shape
    if plan is None:
        attn = _full_attention(wts, x, num_heads, window_size, rope_tables)
        raw1 = torch.empty_like(attn)
        _proj(wts, _o_in(wts, attn), "o", b * h * w, raw1)
        return raw1.reshape(b, h, w, c)
    _, raw1, _, _ = _rows_attention(wts, x, plan, num_heads, window_size,
                                    rope_tables)
    return raw1.reshape(plan.slow_idx.shape[0], -1, c)


def _full_block(name, wts: BlockWeights, x, num_heads: int, ws: int,
                rope_tables):
    """The full block's chain of launches on a CUDA map x."""
    x = x.contiguous()
    _check_block(name, wts, x, num_heads)
    b, h, w, c = x.shape
    m = b * h * w
    attn = _full_attention(wts, x, num_heads, ws, rope_tables)
    x1 = torch.empty(m, c, dtype=x.dtype, device=x.device)
    _proj(wts, _o_in(wts, attn), "o", m, x1, res=x.reshape(m, c))
    return _mlp_chain(wts, x1, m, c, res=x1).reshape(b, h, w, c)


def fused_full_block(blk, x, num_heads: int, window_size: int, rope_tables):
    """One full EVA-02 block on x: (B, H, W, C) -> (B, H, W, C).
    blk: models.eva_vit.Block; rope_tables: (cos, sin) (n, d) tensors or
    None."""
    wts = pack_block_weights(blk, num_heads, x.dtype)
    if x.device.type == "cpu":
        return full_block_plain(wts, x, num_heads, window_size, rope_tables)
    out = _full_block("fused_full_block", wts, x, num_heads, window_size,
                      rope_tables)
    fused_full_block.launches += 1
    return out


def fused_full_block_int8(blk, x, num_heads: int, window_size: int,
                          rope_tables):
    """Kernel B8: fused_full_block with the int8 pack
    (pack_block_weights_int8): dynamic per-row activation quantization, or
    static when the block carries calibrated ``act_scales``."""
    wts = pack_block_weights_int8(blk, num_heads, x.dtype)
    if x.device.type == "cpu":
        return full_block_plain(wts, x, num_heads, window_size, rope_tables)
    out = _full_block("fused_full_block_int8", wts, x, num_heads, window_size,
                      rope_tables)
    fused_full_block_int8.launches += 1
    return out


def _compressed_block(name, wts: BlockWeights, x, plan: CompressPlan,
                      num_heads: int, ws: int, rope_tables):
    """The compressed block's chain of launches on a CUDA map x."""
    x = x.contiguous()
    _check_block(name, wts, x, num_heads)
    b, h, w, c = x.shape
    xs, raw1, slow32, fast32 = _rows_attention(wts, x, plan, num_heads, ws,
                                               rope_tables)
    rows = xs.shape[0]
    # one LN2 pass stores s1 = xs + raw1 and normalizes it
    s1 = torch.empty(rows, c, dtype=x.dtype, device=x.device)
    raw2 = _mlp_chain(wts, raw1, rows, c, ln_res=xs, sum_out=s1)
    out = torch.empty_like(x)
    call("vit_block", "toc3d_scatter_update", x.data_ptr(), s1.data_ptr(),
         raw1.data_ptr(), raw2.data_ptr(), slow32.data_ptr(),
         fast32.data_ptr(), out.data_ptr(), plan.slow_idx.shape[0], h, w, c,
         ws, plan.k, plan.fast_idx.shape[1], int(plan.has_rep), stream_of(x))
    return out


def fused_compressed_block(blk, x, scores, num_heads: int, window_size: int,
                           ratio: float, rope_tables, use_represent: bool,
                           rope_acc: bool, align_k: bool, plan=None):
    """Token-compressed ToC3D block: x (B, H, W, C), scores (B, H*W) ->
    (B, H, W, C). Math of models/toc3d_vit.toc3d_block_forward. plan: the
    routing (compress_plan) when the caller has taken it, as the trainable
    form does, to route its backward the same way."""
    b, h, w, c = x.shape
    wts = pack_block_weights(blk, num_heads, x.dtype)
    if plan is None:
        plan = compress_plan(scores, b, h, w, window_size, ratio,
                             use_represent, align_k)
    rope = rope_tables if rope_acc else None
    if x.device.type == "cpu":
        return compressed_block_plain(wts, x, plan, num_heads, window_size,
                                      rope)
    out = _compressed_block("fused_compressed_block", wts, x, plan,
                            num_heads, window_size, rope)
    fused_compressed_block.launches += 1
    return out


def fused_compressed_block_int8(blk, x, scores, num_heads: int,
                                window_size: int, ratio: float, rope_tables,
                                use_represent: bool, rope_acc: bool,
                                align_k: bool):
    """Kernel C8: fused_compressed_block with the int8 pack, dynamic or
    static as for fused_full_block_int8."""
    b, h, w, c = x.shape
    wts = pack_block_weights_int8(blk, num_heads, x.dtype)
    plan = compress_plan(scores, b, h, w, window_size, ratio, use_represent,
                         align_k)
    rope = rope_tables if rope_acc else None
    if x.device.type == "cpu":
        return compressed_block_plain(wts, x, plan, num_heads, window_size,
                                      rope)
    out = _compressed_block("fused_compressed_block_int8", wts, x, plan,
                            num_heads, window_size, rope)
    fused_compressed_block_int8.launches += 1
    return out


fused_full_block.launches = 0
fused_compressed_block.launches = 0
fused_full_block_int8.launches = 0
fused_compressed_block_int8.launches = 0
_gemm.launches = 0
layernorm.launches = 0
