"""Operations and bytes of one frame, counted from the configuration file
and the traffic alone (never from what the program launches), and the
card's published peaks.

A product of an (M, K) and a (K, N) matrix is 2 M N K operations.
Elementwise work (softmax, LayerNorm, activations, RoPE) is not counted, so
every count is a floor of what the model needs and a share of a peak built
on it cannot pass 100% by the counting.

A frame's count is the image encoder's (perfbench/encoders: the
configuration file's ``encoder`` gives its ``flops``) and the head's, which
every encoder shares. The head reads one level of the neck: a token a
``stride`` x ``stride`` cell of the padded image (``pad_shape``).
"""
from __future__ import annotations

from . import encoders

# NVIDIA H100 SXM, dense (NVIDIA's data sheet), at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def least_time(flops: float, nbytes: float) -> float:
    """Seconds the card needs at least: the larger of the operations over
    the bf16 peak and the bytes over the memory bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def mm(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def model_flops(cfg: dict, views: int, batch: int) -> float:
    """Operations of one steady frame (prev_exists 1): the encoder's, then
    the head's position and memory embeddings, its decoder and the last
    layer's branches."""
    hc = cfg["head"]
    hh, ww = cfg["pad_shape"]
    tokens = batch * views * (hh // cfg["stride"]) * (ww // cfg["stride"])
    total = encoders.load(cfg).flops(cfg, views, batch)
    e = hc["embed_dims"]
    total += mm(tokens, 4 * e, hc["depth_num"] * 3) + mm(tokens, e, 4 * e)
    total += 2 * mm(tokens, e, hc["in_channels"])          # memory_embed
    total += 2 * mm(tokens, e, e) + 2 * mm(tokens, e, e)   # MLN, SE gate
    qs = hc["num_query"] + hc["num_propagated"]             # a lane's
    keys = qs + hc["memory_len"] - hc["num_propagated"]
    q = qs * batch
    dc = hc["decoder"]
    per_layer = (mm(q, e, e) + 2 * mm(keys * batch, e, e)  # self q, k, v
                 + 2 * mm(q, keys, e) + mm(q, e, e)         # core, out
                 + mm(q, e, e) + 2 * mm(tokens, e, e)       # cross q, k, v
                 + 2 * mm(q, tokens // batch, e) + mm(q, e, e)
                 + mm(q, dc["feedforward_channels"], e) * 2)
    total += dc["num_layers"] * per_layer
    total += mm(q, e, e) * 4 + mm(q, hc["num_classes"], e) + \
        mm(q, hc["code_size"], e)
    return total
