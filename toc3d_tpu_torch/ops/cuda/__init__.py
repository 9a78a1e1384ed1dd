"""Hopper kernels of the port, one module per TPU kernel family of
toc3d_tpu/ops/pallas/: patch_embed (patchify_matmul), vit_block
(fused_full_block, fused_compressed_block and their int8 forms) and
cross_attn (flash_attention_core); int8 holds the quantization math, the
int8 GEMM and row quantization those int8 forms and the head's int8
linears share; auction the training matcher (toc3d_tpu/core/auction.py,
plain jnp in JAX).

Each wrapper takes its plain PyTorch version only for tensors that lie on the
CPU; for a CUDA tensor it launches the kernel or raises. Each wrapper counts
its launches in an integer attribute ``launches``.
"""
from __future__ import annotations


def check_cuda(name: str, *tensors, dtype=None, aligned: bool = True) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor (of dtype), on
    a 16-byte boundary unless ``aligned`` is False: the kernels load rows
    in 16-byte chunks (scale vectors, read one element at a time, need no
    alignment)."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got "
                             f"{t.device}")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous() or (aligned and t.data_ptr() % 16):
            raise ValueError(f"{name}: expected a contiguous tensor on a "
                             "16-byte boundary")


def tma_out(name: str, out, rows: int, width: int, dtype, device):
    """The (rows, width) output matrix that a GEMM's TMA stores write:
    ``out`` when given (a column slice of a wider matrix will do), else a new
    one whose rows are padded to 16 bytes, returned as a view. Raises unless
    it is a CUDA matrix of ``dtype`` with a 16-byte aligned base and a row
    stride of a multiple of 16 bytes, as TMA needs."""
    import torch
    if out is None:
        step = 16 // torch.empty(0, dtype=dtype).element_size()
        out = torch.empty(rows, -(-width // step) * step, dtype=dtype,
                          device=device)[:, :width]
    if (not out.is_cuda or out.dtype != dtype or out.dim() != 2
            or out.shape[0] < rows or out.shape[1] < width
            or out.stride(1) != 1 or out.data_ptr() % 16
            or out.stride(0) * out.element_size() % 16):
        raise ValueError(f"{name}: out must be a CUDA {dtype} matrix of at "
                         f"least ({rows}, {width}) with a 16-byte aligned "
                         "base and rows")
    return out


def check_pairs(name: str, v, n: int) -> None:
    """Raise unless v, an f32 vector that a GEMM epilogue reads in pairs
    (8-byte loads: the bias, the int8 channel scales), is a contiguous CUDA
    tensor of at least n elements on an 8-byte boundary."""
    import torch
    check_cuda(name, v, dtype=torch.float32, aligned=False)
    if v.numel() < n or v.data_ptr() % 8:
        raise ValueError(f"{name}: a vector of {v.numel()} for {n} columns, "
                         "or not on an 8-byte boundary")


def check_res(name: str, res, rows: int, n: int) -> None:
    """Raise unless res, the bf16 residual a GEMM epilogue adds, is a
    contiguous CUDA matrix of at least (rows, n), read in column pairs."""
    import torch
    check_cuda(name, res, dtype=torch.bfloat16)
    if res.dim() != 2 or res.shape[0] < rows or res.shape[1] < n \
            or res.shape[1] % 2:
        raise ValueError(f"{name}: residual {tuple(res.shape)} for "
                         f"({rows}, {n})")


def cached_pack(module, name: str, key, build):
    """Per-module cache of kernel-ready weights, rebuilt when ``key``
    changes. Callers key on the parameters' storage and version counters,
    so an in-place update or a reload of the module's weights is never
    served stale packed weights."""
    cache = module.__dict__.setdefault("_toc3d_packed", {})
    hit = cache.get(name)
    if hit is not None and hit[0] == key:
        return hit[1]
    value = build()
    cache[name] = (key, value)
    return value


def param_key(module, *extra):
    """``extra`` and the storage, version, dtype and device of every
    parameter and buffer of ``module`` and its submodules, in one walk of
    the module tree: any reload, in-place update, cast, replacement or new
    buffer changes it."""
    return extra + tuple((t.data_ptr(), t._version, t.dtype, t.device)
                         for m in module.modules()
                         for slots in (m._parameters, m._buffers)
                         for t in slots.values() if t is not None)


def counted_wrappers():
    """Every kernel wrapper that counts its launches in ``launches``: A,
    B, C, D, B8, C8, H8, then G (every bf16 matmul of B and C), G8 (every
    int8 matmul of B8 and C8), the blocks' LayerNorm and the training
    matcher's auction (one launch a cost tensor)."""
    from . import auction, cross_attn, int8, patch_embed, vit_block
    return (patch_embed.patchify_matmul, vit_block.fused_full_block,
            vit_block.fused_compressed_block, cross_attn.flash_attention_core,
            vit_block.fused_full_block_int8,
            vit_block.fused_compressed_block_int8, int8.int8_linear,
            vit_block._gemm, int8.gemm_s8_sm90, vit_block.layernorm,
            auction.auction_match)
