"""PETRHeadDN: the non-streaming DN-PETR head, with no temporal memory bank
(counterpart of toc3d_tpu/models/petr_head_dn.py; reference
dense_heads/petr_head_dn.py). It is StreamPETRHead without the memory
updates, the temporal alignment, the ego-motion conditioning and the
propagated queries: the decoder's self-attention sees the queries only.

The parameters are a StreamPETRHead's with num_propagated 0 and no ego
pos, so convert.head_state_from_jax serves it, and head_forward's
prologue and epilogue (streampetr_head.head_queries, head_outputs,
split_dn) are this head's. Both attention cores run on kernel D
(ops/attention.mha) unless the DN mask is given; the masked
self-attention is written out, as JAX fuses only without a mask
(attention.py:165).
"""
from __future__ import annotations

import torch

from .petr_transformer import decoder_forward
from .streampetr_head import (StreamPETRHead, StreamPETRHeadConfig,
                              head_outputs, head_queries, split_dn)


def petr_head_dn_config(**kw) -> StreamPETRHeadConfig:
    """petr_head_dn.py:28-32: 900 queries, no bank, no propagated queries,
    no ego pos."""
    defaults = dict(num_query=900, memory_len=0, num_propagated=0,
                    topk_proposals=0, with_ego_pos=False)
    defaults.update(kw)
    return StreamPETRHeadConfig(**defaults)


class PETRHeadDN(StreamPETRHead):
    """Head parameters with the reference names (StreamPETRHead's, without
    pseudo_reference_points and the ego-pose MLNs)."""

    def __init__(self, cfg: StreamPETRHeadConfig):
        if cfg.num_propagated or cfg.with_ego_pos:
            raise ValueError("PETRHeadDN has no propagated queries and no "
                             "ego pos (petr_head_dn_config)")
        super().__init__(cfg)


def build_petr_head_dn(cfg: StreamPETRHeadConfig, device="cuda",
                       state_dict=None, seed: int = 0) -> PETRHeadDN:
    """The head on ``device``: the weights of ``state_dict`` (e.g.
    convert.head_state_from_jax) or random ones from ``seed`` with the
    head's init (init_petr_head_dn, petr_head_dn.py:35-37)."""
    from .detector import build_module, init_head_weights_, \
        init_module_weights_

    def init(head, g):
        init_module_weights_(head, g)
        init_head_weights_(head, g)
    return build_module(lambda: PETRHeadDN(cfg), device, state_dict, seed,
                        init)


def petr_head_dn_forward(head: PETRHeadDN, cfg: StreamPETRHeadConfig, feats,
                         data, topk_indexes=None, dn=None, drop_masks=None,
                         remat: bool = False):
    """One frame (petr_head_dn.py:40-99). feats (B, N, h, w, C); data:
    intrinsics, img2lidar and 'pad_shape'. dn: 'padded_reference_points'
    (core/dn.dn_reference_points), 'attn_mask' and 'pad_size'
    (core/dn.prepare_for_dn); topk_indexes, drop_masks and remat as for
    streampetr_head.head_forward. With compute_dtype 'bfloat16' the memory
    and the decoder run in bf16, as head_forward's do. Returns every
    layer's all_cls_scores / all_bbox_preds and, with dn, dn_cls_scores /
    dn_bbox_preds."""
    (memory, pos_embed, tgt, query_pos, reference_points, attn_mask,
     pad_size) = head_queries(head, cfg, feats, data, topk_indexes, dn)
    if cfg.compute_dtype == "bfloat16":
        tgt, query_pos = (t.to(torch.bfloat16) for t in (tgt, query_pos))
    outs_dec = decoder_forward(head.transformer.decoder, cfg.decoder, tgt,
                               memory, query_pos, pos_embed,
                               attn_mask=attn_mask, drop_masks=drop_masks,
                               remat=remat)
    outs_dec = torch.nan_to_num(outs_dec.float())
    return split_dn(*head_outputs(head, cfg, outs_dec, reference_points),
                    pad_size)
