"""PETR temporal transformer decoder (counterpart of
toc3d_tpu/models/petr_transformer.py; reference petr_transformer.py:194-760).

Post-norm layer order (self_attn, norm, cross_attn, norm, ffn, norm). Both
attention cores run on kernel D through ops/attention.mha, unless training
gives the self-attention the DN mask or dropout its explicit masks
(``draw_drop_masks``); with ``remat`` each layer runs under
torch.utils.checkpoint.
Module names follow the reference: attentions.{0,1}.attn, ffns.0.layers,
norms.{0,1,2}.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..layers import lin, ln, quantized
from ..ops.attention import MultiheadAttention, dropout, mha, quantize_mha

LN_EPS = 1e-5


@dataclass(frozen=True)
class DecoderConfig:
    """Field names of petr_transformer.py:29-51 (dropout is read by
    training only; fused_attn is not carried: the attention core runs the
    kernel on the card wherever no mask and no dropout is asked for).
    quant 'int8': serving int8 for the decoder layers' linears (q/k/v/out
    projections and the FFN), quantized once by quantize_decoder_params
    (detector.precast_backbone_ calls it); the flash core, the LNs and the
    branches stay as they are."""
    embed_dims: int = 256
    num_heads: int = 8
    num_layers: int = 6
    feedforward_channels: int = 2048
    dropout: float = 0.1
    quant: str = "none"


class AttnWrapper(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.attn = MultiheadAttention(cfg.embed_dims, cfg.num_heads)


class FFN(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        e, f = cfg.embed_dims, cfg.feedforward_channels
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(e, f), nn.ReLU(), nn.Dropout(cfg.dropout)),
            nn.Linear(f, e), nn.Dropout(cfg.dropout))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.attentions = nn.ModuleList([AttnWrapper(cfg), AttnWrapper(cfg)])
        self.ffns = nn.ModuleList([FFN(cfg)])
        self.norms = nn.ModuleList(
            nn.LayerNorm(cfg.embed_dims, eps=LN_EPS) for _ in range(3))


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.post_norm = nn.LayerNorm(cfg.embed_dims, eps=LN_EPS)


class Transformer(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.decoder = Decoder(cfg)


def ffn(f: FFN, x, quant: str = "none", masks=None, rate: float = 0.0):
    """x + FFN(x), with dropout at the hidden and the output where
    ``masks`` has their keep masks ('ffn0', 'ffn1')."""
    m = masks or {}
    h = dropout(F.relu(lin(f.layers[0][0], x, quant)), m.get("ffn0"), rate)
    return x + dropout(lin(f.layers[1], h, quant), m.get("ffn1"), rate)


def quantize_decoder_params(dec: Decoder) -> None:
    """Per-output-channel int8 packs of every decoder layer's linears
    (self/cross-attention q/k/v/out projections and the two FFN matmuls),
    built once and cached on the modules (petr_transformer.py:100-122);
    the LNs and the post-norm stay f32."""
    for layer in dec.layers:
        for a in layer.attentions:
            quantize_mha(a.attn)
        quantized(layer.ffns[0].layers[0][0])
        quantized(layer.ffns[0].layers[1])


def decoder_layer_forward(layer: DecoderLayer, cfg: DecoderConfig, query,
                          key, value, query_pos, key_pos, temp_memory,
                          temp_pos, self_attn_mask=None, masks=None):
    """One PETRTemporalDecoderLayer (petr_transformer.py:125-167).
    self_attn_mask: the self-attention's mask (training's DN mask);
    masks: the keep masks of the six dropout sites (draw_drop_masks), None
    for none."""
    m = masks or {}
    rate = cfg.dropout
    if temp_memory is not None:
        tk = torch.cat([query, temp_memory], dim=1)
        tp = torch.cat([query_pos, temp_pos], dim=1)
    else:
        tk, tp = query, query_pos
    out = mha(layer.attentions[0].attn, query + query_pos, tk + tp, tk,
              cfg.num_heads, cfg.quant, self_attn_mask, m.get("self_attn"),
              rate)
    query = ln(layer.norms[0], query + dropout(out, m.get("res0"), rate),
               LN_EPS)
    out = mha(layer.attentions[1].attn, query + query_pos, key + key_pos,
              value, cfg.num_heads, cfg.quant, None, m.get("cross_attn"),
              rate)
    query = ln(layer.norms[1], query + dropout(out, m.get("res1"), rate),
               LN_EPS)
    query = ffn(layer.ffns[0], query, cfg.quant, m, rate)
    return ln(layer.norms[2], query, LN_EPS)


def drop_mask_shapes(cfg: DecoderConfig, b: int, nq: int, nk_self: int,
                     nk_cross: int):
    """The shape of each dropout site of one layer
    (petr_transformer.py:141-166): the self- and cross-attention
    probabilities, the two attention residuals, the FFN's hidden and its
    output."""
    h, c, f = cfg.num_heads, cfg.embed_dims, cfg.feedforward_channels
    return {"self_attn": (b, h, nq, nk_self), "res0": (b, nq, c),
            "cross_attn": (b, h, nq, nk_cross), "res1": (b, nq, c),
            "ffn0": (b, nq, f), "ffn1": (b, nq, c)}


def draw_drop_masks(cfg: DecoderConfig, shapes, generator, device):
    """One dict of bool keep masks (True = kept, probability 1 - dropout)
    per decoder layer, drawn from ``generator``; None at dropout 0."""
    if cfg.dropout <= 0.0:
        return None
    keep = 1.0 - cfg.dropout
    return [{k: torch.rand(s, generator=generator, device=device) < keep
             for k, s in shapes.items()} for _ in range(cfg.num_layers)]


def decoder_forward(dec: Decoder, cfg: DecoderConfig, tgt, memory, query_pos,
                    pos_embed, temp_memory=None, temp_pos=None,
                    attn_mask=None, drop_masks=None, remat: bool = False):
    """Full decoder stack -> per-layer post-normed outputs (L, B, Q, C).
    attn_mask: the self-attention mask; drop_masks: per layer, its dropout
    keep masks (training); remat: each layer under torch.utils.checkpoint
    (its masks are tensors, so the recompute draws nothing)."""
    outs = []
    query = tgt
    for li, layer in enumerate(dec.layers):
        args = (layer, cfg, query, memory, memory, query_pos, pos_embed,
                temp_memory, temp_pos, attn_mask,
                None if drop_masks is None else drop_masks[li])
        query = (checkpoint(decoder_layer_forward, *args,
                            use_reentrant=False) if remat
                 else decoder_layer_forward(*args))
        outs.append(ln(dec.post_norm, query, LN_EPS))
    return torch.stack(outs)
