"""Patch embedding kernel (kernel A; source csrc/patch_embed.cu).

Replaces toc3d_tpu/ops/pallas/patch_embed.py :: patchify_matmul (:60). The
16x16 stride-16 3->C convolution is two launches behind one C entry point:
an im2col copy of the channel-last image into the (B*h*w, ps*ps*3) patch
matrix, then kernel G's TMA + wgmma GEMM (csrc/gemm_sm90.cuh) with the bias
epilogue; see the note in csrc/patch_embed.cu for the bound and the design.
"""
from __future__ import annotations

import torch

from . import (cached_pack, check_cuda, check_device, check_pairs,
               param_key)
from .build import call, stream_of
from .vit_block import gemm_bf16_plain


def pack_patch_weight(conv, dtype):
    """Conv2d weight (C, 3, ps, ps) -> (C, ps*ps*3) in (row, col, channel)
    order, the K order of the image's patch rows; bias as f32."""
    def build():
        w = conv.weight.detach()
        wm = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).to(dtype)
        return wm.contiguous(), conv.bias.detach().float().contiguous()
    return cached_pack(conv, "patchify", param_key(conv, dtype), build)


def patch_im2col_plain(x, patch_size: int):
    """Plain version of ``patch_im2col``: x (B, H, W, c) -> the patch
    matrix (B*h*w, ps*ps*c), row (b, i, j), K in (row, col, channel)
    order."""
    b, hh, ww, c = x.shape
    ps = patch_size
    h, w = hh // ps, ww // ps
    p = x.reshape(b, h, ps, w, ps, c).permute(0, 1, 3, 2, 4, 5)
    return p.reshape(b * h * w, ps * ps * c)


def patchify_plain(x, wmat, bias, patch_size: int):
    """Plain version: the patch matrix, then kernel G's plain product (f32
    accumulation, + bias, cast to x.dtype)."""
    b, hh, ww, _ = x.shape
    ps = patch_size
    y = gemm_bf16_plain(patch_im2col_plain(x, ps), wmat, bias)
    return y.reshape(b, hh // ps, ww // ps, -1)


def _check_image(name, x, ps):
    b, hh, ww, cin = x.shape
    if cin != 3 or hh % ps or ww % ps:
        raise ValueError(f"{name}: image {tuple(x.shape)} must be (B, H, W, "
                         f"3) with H, W multiples of {ps}")


def _check_image_cuda(name, x, ps):
    check_cuda(name, x, dtype=torch.bfloat16)
    if x.shape[2] % 8 or (ps * 3) % 8:
        raise ValueError(f"{name} needs W % 8 == 0 and ps*3 % 8 == 0 "
                         "(16-byte image rows and patch runs)")


def patch_im2col(x, patch_size: int):
    """The first of kernel A's two launches alone: x (B, H, W, 3) -> the
    (B*h*w, ps*ps*3) patch matrix. Not counted as a launch of A."""
    ps = patch_size
    _check_image("patch_im2col", x, ps)
    if x.device.type == "cpu":
        return patch_im2col_plain(x, ps)
    _check_image_cuda("patch_im2col", x, ps)
    b, hh, ww, _ = x.shape
    cols = torch.empty(b * (hh // ps) * (ww // ps), ps * ps * 3,
                       dtype=x.dtype, device=x.device)
    call("patch_embed", "toc3d_patch_im2col", x.data_ptr(), cols.data_ptr(),
         b, hh, ww, ps, stream_of(x))
    return cols


@torch.library.custom_op(
    "toc3d::patchify_matmul", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor wmat, Tensor bias, int patch_size) -> Tensor")
def _patchify_op(x, wmat, bias, patch_size):
    _check_image("patchify_matmul", x, patch_size)
    return patchify_plain(x, wmat, bias, patch_size).contiguous()


@_patchify_op.register_fake
def _patchify_fake(x, wmat, bias, patch_size):
    b, hh, ww, _ = x.shape
    ps = patch_size
    return x.new_empty(b, hh // ps, ww // ps, wmat.shape[0])


@_patchify_op.register_kernel("cuda")
def _patchify_cuda(x, wmat, bias, patch_size):
    """Kernel A's launches: the im2col copy, then kernel G's GEMM into the
    output (C a multiple of 8, for the output's 16-byte TMA rows; the bias
    on 8 bytes, read in pairs); counted once in ``launches``."""
    ps = patch_size
    name = "patchify_matmul"
    _check_image(name, x, ps)
    _check_image_cuda(name, x, ps)
    b, hh, ww, _ = x.shape
    c, k = wmat.shape
    check_cuda(name, wmat, dtype=torch.bfloat16)
    check_pairs(name, bias, c)
    if k != ps * ps * 3 or c % 8:
        raise ValueError(f"{name}: weight {tuple(wmat.shape)} must "
                         f"be (C, {ps * ps * 3}) with C % 8 == 0")
    m = b * (hh // ps) * (ww // ps)
    cols = torch.empty(m, k, dtype=x.dtype, device=x.device)
    out = torch.empty(b, hh // ps, ww // ps, c, dtype=x.dtype,
                      device=x.device)
    call("patch_embed", "toc3d_patchify", x.data_ptr(), wmat.data_ptr(),
         bias.data_ptr(), cols.data_ptr(), out.data_ptr(), b, hh, ww, ps, c,
         stream_of(x))
    patchify_matmul.launches += 1
    return out


def patchify_matmul(x, wmat, bias, patch_size: int):
    """x: (B, H, W, 3) normalized image; wmat: (C, ps*ps*3) from
    ``pack_patch_weight``; bias: (C,) f32. Returns (B, H/ps, W/ps, C) in
    x.dtype, through the op ``toc3d::patchify_matmul``: on the card kernel
    A's two launches, on the CPU the plain version."""
    check_device("patchify_matmul", x)
    return torch.ops.toc3d.patchify_matmul(x, wmat, bias, patch_size)


patchify_matmul.launches = 0
