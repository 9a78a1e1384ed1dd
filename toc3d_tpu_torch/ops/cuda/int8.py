"""int8 quantization and the int8 kernels: kernel G8 (``gemm_s8_sm90``, the
TMA + wgmma GEMM of csrc/gemm_sm90.cuh, built in csrc/vit_block.cu) behind
the weight matmuls of the int8 blocks B8 and C8 (ops/cuda/vit_block.py),
fed by row quantization (``row_quant``) at their proj_in site; kernel H8
(``int8_linear``, csrc/int8_linear.cu: one wgmma launch a call, the row
quantization of its input fused) behind the head decoder's int8 linears;
and ``gemm_s8``, csrc/gemm.cuh's mma.sync tile, on no main path: the
bit-for-bit oracle that the card tests and chip_smoke.py hold G8 and H8 to.

Plain versions of toc3d_tpu/ops/pallas/vit_block.py :: quantize_block_params
(:201, the weight half), _rowquant (:247), _statquant (:259) and _qmm
(:277), and of toc3d_tpu/layers.py :: quantize_linear (:91) and
_int8_matmul (:110), with the same f32 arithmetic:

* weights: per output channel (dim 1 of a torch (out, in) weight), scale
  max(|w|, 1e-8) / 127, wq = clip(round(w / s)) — a division;
* dynamic activations, per row: a = max(amax, 1e-6), q = clip(round(x *
  (127 / a))), scale a * (1/127) — a multiply by the reciprocal;
* static activations: q = clip(round(x * (1 / s))) for the site's
  calibrated scale s;
* rounding half to even (torch.round), clipping to +-127;
* the int8 products summed exactly (in float64, exact below 2^53; the ViT-L
  sums reach 127^2 * 2736 = 4.4e7, past float32's 2^24) and rounded once to
  f32, as the int32 accumulator converts;
* dequantization float(acc) * (xs * ws) in the blocks, (float(acc) * xs) *
  ws in the head (layers.py:120-121), whose linear then casts to the
  activation dtype before it adds the bias (layers.py:83-87).

Every division here goes through ``_div`` on two full tensors: torch's CUDA
division by a scalar multiplies by the scalar's reciprocal, and ``c / t``
for a Python number c is ``t.reciprocal() * c``; neither is the IEEE
quotient that jnp computes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import check_cuda, check_device, check_pairs, check_res, tma_out
from .build import call, stream_of

# static activation-scale sites of a block, in the order of
# toc3d_tpu/ops/pallas/vit_block.py _ACT_SITES
SITES = ("attn_in", "proj_in", "mlp_in", "ffn_in")


class QuantLinear(NamedTuple):
    """An int8 linear: weight (out, in) int8, per-output-channel f32 scale
    (out,), f32 bias (out,) or None."""
    w: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor]


# kernel H8's tile and shared-memory plan (csrc/int8_linear.cu, namespace
# h8): 64-row tiles, K in blocks of 128 (one 128-byte swizzle row of int8,
# one x chunk of 128 bf16 in one TMA box), BN from H8_BNS
H8_BM, H8_KB, H8_BNS, H8_K_MAX = 64, 128, (128, 256), 2048
H8_X_BYTES = H8_BM * H8_KB * 2       # one bf16 x chunk
H8_STREAM_BUFS = 4                   # x chunk buffers above K 256
H8_STREAM_SLOTS = 4                  # quantized k block slots above K 256
H8_STAGE_OUT = 64 * 128              # one output staging buffer
H8_MAX_BARS = 48
H8_BN_MAX = 256
H8_SMEM_MAX = 232448                 # a block's shared memory on sm_90


class H8Plan(NamedTuple):
    """One H8 launch: bn columns a tile, ``grid`` blocks over ``tiles``
    tiles (``tiles_n`` along N; block b takes tiles b, b + grid, ...),
    ``nkb`` k blocks of 128, ``nas`` slots of quantized k blocks, ``nxb`` x
    chunk buffers, ``wst`` weight stages (each a ring); ``panel`` (K <= 256:
    a tile's x chunks read once, kept in registers between the amax and the
    quantizing pass) and ``resident`` (the weight tile loaded once a block)
    as the kernel derives them; ``smem`` its dynamic shared memory in
    bytes."""
    bn: int
    grid: int
    tiles_n: int
    tiles: int
    nkb: int
    nas: int
    nxb: int
    wst: int
    panel: bool
    resident: bool
    smem: int


def h8_bars(nas, nxb, wst):
    """An H8 launch's barriers (int8_linear.cu bars): weight stages full, x
    buffers full and free, k block slots quantized and free, the rows'
    scales of two tiles free."""
    return wst + 2 * nxb + 2 * nas + 2


def h8_smem(bn, nas, nxb, wst):
    """Dynamic shared memory of an H8 launch (int8_linear.cu smem_bytes)."""
    return (1024 + wst * bn * H8_KB + nas * H8_BM * H8_KB
            + nxb * H8_X_BYTES + 4 * H8_STAGE_OUT + 2 * H8_BM * 4
            + 2 * H8_BN_MAX * 4 + h8_bars(nas, nxb, wst) * 8)


def h8_plan(m: int, n: int, k: int, sms: int) -> H8Plan:
    """The launch of kernel H8 for x (m, k) @ w (n, k)^T on ``sms`` SMs.
    BN (split between the two consumer warpgroups): the smallest of H8_BNS
    whose tiles fit in one wave, else the smallest that covers N (at most
    256) on a persistent grid whose size is a multiple of the column tiles,
    so that a block keeps one weight tile.
    K <= 256: every k block of a tile in its slot and the weight tile
    resident, and with several tiles a block, the slots of two tiles and x
    buffers for three, so that the quantizer runs a tile ahead. Above: 4
    slots, 4 x buffers and as many weight stages as fit. Raises ValueError
    for a width the kernel does not take: k a multiple of 16 from 16 to
    H8_K_MAX, n a positive multiple of 8 (16-byte output rows for the TMA
    store)."""
    if k % 16 or not 16 <= k <= H8_K_MAX or n <= 0 or n % 8 or m < 0:
        raise ValueError(f"int8_linear: unsupported shape ({m}, {k}) -> {n}"
                         f" (in a multiple of 16 from 16 to {H8_K_MAX}, out "
                         "a multiple of 8)")
    rows = -(-m // H8_BM)
    bn = next((b for b in H8_BNS if rows * -(-n // b) <= sms), None)
    if bn is None:
        bn = next((b for b in H8_BNS if b >= n), H8_BNS[-1])
    tiles_n = -(-n // bn)
    tiles = rows * tiles_n
    grid = tiles if tiles <= sms else max(sms // tiles_n, 1) * tiles_n
    nkb = -(-k // H8_KB)
    panel = k <= 2 * H8_KB
    several = tiles > grid

    def fits(nas, nxb, wst):
        return (h8_smem(bn, nas, nxb, wst) <= H8_SMEM_MAX
                and h8_bars(nas, nxb, wst) <= H8_MAX_BARS)

    wst = nkb
    if panel:
        nas, nxb = nkb * (2 if several else 1), nkb * (3 if several else 1)
        while not fits(nas, nxb, wst) and nxb > nkb:
            nxb -= 1
        while not fits(nas, nxb, wst) and wst > 1:
            wst -= 1
    else:
        nas, nxb = min(nkb, H8_STREAM_SLOTS), H8_STREAM_BUFS
        while not fits(nas, nxb, wst):
            if wst > 4:
                wst -= 1
            elif nxb > 2:
                nxb -= 1
            elif wst > 2:
                wst -= 1
            else:
                nas -= 1
    resident = wst >= nkb and (tiles <= grid or grid % tiles_n == 0)
    return H8Plan(bn, grid, tiles_n, tiles, nkb, nas, nxb, wst, panel,
                  resident, h8_smem(bn, nas, nxb, wst))


def _div(a, b):
    """IEEE f32 quotient a / b elementwise, either side a tensor or a
    number."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    a, b = torch.broadcast_tensors(a, b)
    return torch.div(a.contiguous(), b.contiguous())


def quantize_weight(w, pre_scale: float = 1.0):
    """(out, in) float weight -> (int8 (out, in), f32 (out,) scale)."""
    w = w.detach().float()
    if pre_scale != 1.0:
        w = w * pre_scale
    s = _div(w.abs().amax(dim=1).clamp_min(1e-8), 127.0)
    q = torch.round(_div(w, s[:, None])).clamp(-127, 127).to(torch.int8)
    return q.contiguous(), s.contiguous()


def rowquant(x):
    """Dynamic per-row quantization: x (..., K) -> (int8 (..., K), f32
    (..., 1) scale)."""
    x32 = x.float()
    a = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    q = torch.round(x32 * _div(127.0, a)).clamp(-127, 127).to(torch.int8)
    return q, a * (1.0 / 127.0)


def statquant(x, s):
    """Static quantization at the calibrated scale s (a 1-element f32
    tensor): -> (int8 like x, s)."""
    s = s.float().reshape(1)
    q = torch.round(x.float() * _div(1.0, s)).clamp(-127, 127)
    return q.to(torch.int8), s


def int8_dot(q, wq):
    """int8 (..., K) @ int8 (N, K)^T summed exactly, rounded once to f32."""
    return (q.double() @ wq.double().t()).float()


def int8_matmul(x, wq, w_scale):
    """layers.py _int8_matmul: (..., in) float @ int8 (out, in) -> f32,
    dynamic per-row activation quantization, (y * xs) * w_scale."""
    q, s = rowquant(x)
    return int8_dot(q, wq) * s * w_scale


def int8_linear_plain(x, p: QuantLinear):
    """Plain version of ``int8_linear``: the head's int8 linear, cast to
    x.dtype before the bias is added in x.dtype."""
    y = int8_matmul(x, p.w, p.scale).to(x.dtype)
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def gemm_s8_plain(aq, xs, wq, ws, bias=None, res=None, out_f32=False,
                  gate=False, head=False, dtype=torch.bfloat16):
    """Plain version of ``gemm_s8`` and ``gemm_s8_sm90``: aq (M, K) int8,
    xs (M,) row scales or a 1-element static scale, wq (N, K) int8, ws
    (N,); the epilogues of csrc/gemm.cuh in the activation dtype
    ``dtype``."""
    v = int8_dot(aq, wq)
    xs = xs.float().reshape(-1, 1)
    v = v * xs * ws if head else v * (xs * ws)
    if bias is not None:
        v = (v.to(dtype) + bias.to(dtype)).float() if head else v + bias
    if gate:
        a, b = v[:, 0::2].to(dtype), v[:, 1::2].to(dtype)
        return (F.silu(a.float()).to(dtype).float() * b.float()).to(dtype)
    if out_f32:
        return v
    if res is not None:
        return (v.to(dtype).float() + res.float()).to(dtype)
    return v.to(dtype)


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def row_quant(x, static_scale=None):
    """x (rows, n) bf16 on the card -> (int8 (rows, n), f32 scale): the
    rows' scales (rows,), or ``static_scale`` (a 1-element f32 tensor on the
    card) when given. On the CPU, the plain rowquant / statquant."""
    if x.device.type == "cpu":
        if static_scale is None:
            q, s = rowquant(x)
            return q, s.reshape(-1)
        return statquant(x, static_scale)
    check_cuda("row_quant", x, dtype=torch.bfloat16)
    rows, n = x.shape
    if n % 2:
        raise ValueError(f"row_quant: width {n} must be even")
    q = torch.empty(rows, n, dtype=torch.int8, device=x.device)
    if static_scale is None:
        s = torch.empty(rows, dtype=torch.float32, device=x.device)
        sp, st = s.data_ptr(), None
    else:
        check_cuda("row_quant", static_scale, dtype=torch.float32,
                   aligned=False)
        s, sp, st = static_scale, None, static_scale.data_ptr()
    call("vit_block", "toc3d_rowquant", x.data_ptr(), n, rows, n, st,
         q.data_ptr(), n, sp, stream_of(x))
    return q, s


def gemm_s8(aq, xs, wq, ws, bias=None, res=None, out_f32=False, gate=False,
            head=False, out=None):
    """The int8 GEMM on csrc/gemm.cuh's mma.sync tile, on no main path: the
    oracle that kernel G8 (``gemm_s8_sm90``) and, after ``row_quant``,
    kernel H8 (``int8_linear``) are held to bit for bit on the card. aq (M,
    K) int8 @ wq (N, K)^T, dequantized by xs (M,) row scales or a
    1-element static scale and ws (N,) channel scales, then the epilogue
    (head: the head's product order and bias rounding; or bias, residual,
    SwiGLU gate or f32 out, the blocks' epilogues). Returns ``out`` ((M, N)
    bf16, (M, N) f32 with out_f32, (M, N/2) bf16 with gate)."""
    check_cuda("gemm_s8", aq, wq, dtype=torch.int8)
    check_cuda("gemm_s8", xs, ws, dtype=torch.float32, aligned=False)
    m, k = aq.shape
    n = wq.shape[0]
    if wq.shape[1] != k or k % 16 or n % 2:
        raise ValueError(f"gemm_s8: unsupported shapes {tuple(aq.shape)} x "
                         f"{tuple(wq.shape)} (K % 16 == 0, N even)")
    if out is None:
        shape = (m, n // 2) if gate else (m, n)
        out = torch.empty(shape, device=aq.device,
                          dtype=torch.float32 if out_f32 else torch.bfloat16)
    if bias is not None:
        check_cuda("gemm_s8", bias, dtype=torch.float32, aligned=False)
    if res is not None:
        check_cuda("gemm_s8", res, dtype=torch.bfloat16)
    call("vit_block", "toc3d_gemm_s8", aq.data_ptr(), k, xs.data_ptr(),
         int(xs.numel() > 1), wq.data_ptr(), k, ws.data_ptr(),
         None if bias is None else bias.data_ptr(),
         None if res is None else res.data_ptr(),
         0 if res is None else res.shape[-1], out.data_ptr(), out.shape[-1],
         m, n, k, int(out_f32), int(gate), int(head), stream_of(aq))
    return out


def gemm_s8_sm90(aq, xs, wq, ws, bias=None, res=None, out_f32=False,
                 gate=False, out=None):
    """Kernel G8, the int8 form of kernel G (csrc/gemm_sm90.cuh: TMA loads
    into a shared-memory ring, wgmma m64n256k32 s32.s8.s8, a producer and
    two consumer warpgroups, a persistent grid) behind every weight matmul
    of B8 and C8: aq (M, K) int8 @ wq (N, K)^T, dequantized by xs (M,) row
    scales or a 1-element static scale and ws (N,) channel scales, then the
    epilogue (bias, residual, SwiGLU gate or f32 out) at ``gemm_s8``'s
    rounding points. Returns ``out`` ((M, N) bf16, (M, N) f32 with
    out_f32, (M, N/2) bf16 with gate; out may be a column slice of a wider
    matrix). On a CPU tensor, the plain version.

    TMA reads aq and wq and writes out, so each needs a 16-byte aligned
    base and a row stride of a multiple of 16 bytes (K a multiple of 16);
    the epilogue works on column pairs (N even), reading the f32 bias and
    channel scales 8 bytes at a time, so both need an 8-byte aligned base.
    Anything else raises ValueError."""
    if aq.device.type == "cpu":
        return gemm_s8_plain(aq, xs, wq, ws, bias, res, out_f32, gate)
    name = "gemm_s8_sm90"
    check_cuda(name, aq, wq, dtype=torch.int8)
    check_cuda(name, xs, dtype=torch.float32, aligned=False)
    m, k, n = aq.shape[0], aq.shape[-1], wq.shape[0]
    if (aq.dim() != 2 or wq.dim() != 2 or wq.shape[1] != k or k % 16
            or n % 2 or xs.numel() not in (1, m)):
        raise ValueError(f"{name}: unsupported shapes {tuple(aq.shape)} x "
                         f"{tuple(wq.shape)} with {xs.numel()} row scales "
                         "(K a multiple of 16, N even)")
    check_pairs(name, ws, n)
    out = tma_out(name, out, m, n // 2 if gate else n,
                  torch.float32 if out_f32 else torch.bfloat16, aq.device)
    if bias is not None:
        check_pairs(name, bias, n)
    if res is not None:
        check_res(name, res, m, n)
    call("vit_block", "toc3d_gemm_s8_sm90", aq.data_ptr(), k, xs.data_ptr(),
         int(xs.numel() > 1), wq.data_ptr(), k, ws.data_ptr(),
         None if bias is None else bias.data_ptr(),
         None if res is None else res.data_ptr(),
         0 if res is None else res.shape[1], out.data_ptr(), out.stride(0),
         m, n, k, int(out_f32), int(gate), stream_of(aq))
    gemm_s8_sm90.launches += 1
    return out


@torch.library.custom_op(
    "toc3d::int8_linear", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor w, Tensor scale, Tensor? bias) -> Tensor")
def _int8_linear_op(x, w, scale, bias):
    return int8_linear_plain(x, QuantLinear(w, scale, bias)).contiguous()


@_int8_linear_op.register_fake
def _int8_linear_fake(x, w, scale, bias):
    return x.new_empty(*x.shape[:-1], w.shape[0])


@_int8_linear_op.register_kernel("cuda")
def _int8_linear_cuda(x, w, scale, bias):
    """H8's one launch (csrc/int8_linear.cu), on the plan of ``h8_plan``;
    counted in ``launches``."""
    name = "int8_linear"
    check_cuda(name, w, dtype=torch.int8)
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    check_cuda(name, x2, dtype=torch.bfloat16)
    m, k = x2.shape
    n = w.shape[0]
    if w.dim() != 2 or w.shape[1] != k:
        raise ValueError(f"{name}: weight {tuple(w.shape)} for input width "
                         f"{k}")
    plan = h8_plan(m, n, k, torch.cuda.get_device_properties(
        x2.device).multi_processor_count)
    check_pairs(name, scale, n)
    if bias is not None:
        check_pairs(name, bias, n)
    y = torch.empty(m, n, dtype=torch.bfloat16, device=x2.device)
    if m:
        call("int8_linear", "toc3d_int8_linear", x2.data_ptr(), w.data_ptr(),
             scale.data_ptr(), None if bias is None else bias.data_ptr(),
             y.data_ptr(), m, n, k, plan.bn, plan.grid, plan.nas, plan.nxb,
             plan.wst, stream_of(x2))
        int8_linear.launches += 1
    return y.reshape(*x.shape[:-1], n)


def int8_linear(x, p: QuantLinear):
    """Kernel H8, the head decoder's int8 linear (layers.py:81-121), through
    the op ``toc3d::int8_linear``: on a bf16 CUDA tensor x (..., in) one
    launch of csrc/int8_linear.cu (the rows' quantization, the s8 wgmma
    product and the head's epilogue) -> (..., out) bf16; the plain version
    on a CPU tensor. The widths it takes (``h8_plan``): in a multiple of 16
    from 16 to 2048, out a multiple of 8; any other raises ValueError."""
    check_device("int8_linear", x)
    return torch.ops.toc3d.int8_linear(x, p.w, p.scale, p.bias)


int8_linear.launches = 0
gemm_s8_sm90.launches = 0
