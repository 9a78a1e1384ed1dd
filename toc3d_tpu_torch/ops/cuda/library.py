"""The ``toc3d`` custom-op registry: importing this module registers every
``torch.library`` op of the serving path, one per kernel entry point, each
beside its wrapper. ``torch.export.load`` needs them registered before it
reads a program that calls them (runtime/export.load_detector imports this
module first); it imports no model module.

Each op takes tensors, ints, floats and bools only (a block's packed
weights as a tensor list, its routing as index tensors) and returns a new
contiguous tensor that aliases no input, so none mutates its arguments.
"""
from __future__ import annotations

from . import cross_attn, int8, patch_embed, vit_block  # noqa: F401

# op name -> the kernel it launches on the card
OPS = {
    "toc3d::patchify_matmul": "A",
    "toc3d::fused_full_block": "B",
    "toc3d::fused_compressed_block": "C",
    "toc3d::flash_attention_core": "D",
    "toc3d::fused_full_block_int8": "B8",
    "toc3d::fused_compressed_block_int8": "C8",
    "toc3d::int8_linear": "H8",
}
