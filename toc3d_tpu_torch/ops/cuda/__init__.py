"""Hopper kernels of the port, one module per TPU kernel family of
toc3d_tpu/ops/pallas/: patch_embed (patchify_matmul), vit_block
(fused_full_block, fused_compressed_block and their int8 forms) and
cross_attn (flash_attention_core); int8 holds the quantization math, the
int8 GEMM and row quantization those int8 forms and the head's int8
linears share.

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
    tensors = list(module.parameters()) + list(module.buffers())
    return extra + tuple((t.data_ptr(), t._version, t.dtype, t.device)
                         for t in tensors)
