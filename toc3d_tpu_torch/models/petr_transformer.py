"""PETR temporal transformer decoder, eval path (counterpart of
toc3d_tpu/models/petr_transformer.py; reference petr_transformer.py:194-760).

Post-norm layer order (self_attn, norm, cross_attn, norm, ffn, norm); both
attention cores run on kernel D through ops/attention.mha. Module names
follow the reference: attentions.{0,1}.attn, ffns.0.layers, norms.{0,1,2}.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import lin, ln, quantized
from ..ops.attention import MultiheadAttention, mha, quantize_mha

LN_EPS = 1e-5


@dataclass(frozen=True)
class DecoderConfig:
    """Field names of petr_transformer.py:29-51 that inference reads
    (dropout is training only; fused_attn is not carried: the attention
    core always runs the kernel on the card). quant 'int8': serving int8
    for the decoder layers' linears (q/k/v/out projections and the FFN),
    quantized once by quantize_decoder_params (detector.precast_backbone_
    calls it); the flash core, the LNs and the branches stay as they are."""
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


def ffn(f: FFN, x, quant: str = "none"):
    h = F.relu(lin(f.layers[0][0], x, quant))
    return x + lin(f.layers[1], h, quant)


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
                          temp_pos):
    """One PETRTemporalDecoderLayer (petr_transformer.py:125-167, eval)."""
    if temp_memory is not None:
        tk = torch.cat([query, temp_memory], dim=1)
        tp = torch.cat([query_pos, temp_pos], dim=1)
    else:
        tk, tp = query, query_pos
    out = mha(layer.attentions[0].attn, query + query_pos, tk + tp, tk,
              cfg.num_heads, cfg.quant)
    query = ln(layer.norms[0], query + out, LN_EPS)
    out = mha(layer.attentions[1].attn, query + query_pos, key + key_pos,
              value, cfg.num_heads, cfg.quant)
    query = ln(layer.norms[1], query + out, LN_EPS)
    query = ffn(layer.ffns[0], query, cfg.quant)
    return ln(layer.norms[2], query, LN_EPS)


def decoder_forward(dec: Decoder, cfg: DecoderConfig, tgt, memory, query_pos,
                    pos_embed, temp_memory=None, temp_pos=None):
    """Full decoder stack -> per-layer post-normed outputs (L, B, Q, C)."""
    outs = []
    query = tgt
    for layer in dec.layers:
        query = decoder_layer_forward(layer, cfg, query, memory, memory,
                                      query_pos, pos_embed, temp_memory,
                                      temp_pos)
        outs.append(ln(dec.post_norm, query, LN_EPS))
    return torch.stack(outs)
