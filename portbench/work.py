"""The yardstick's arithmetic: the chip's peaks and the work of each part
of a served call, counted from the configuration's shapes.

FLOPs are those of the products (2 m n k for every matrix product,
attention's two products, the BiLSTM's input and recurrent products, the
convolutions): elementwise work is not counted. The served model's work is
counted at each pair's true length (sentence L, the prompted encoder at
offset - 2 + 2 * prompt_len + L): padding and the rows a server repeats to
fill a batch do no useful work. Kernel bounds count each input byte read
once and each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, at 700 W)
PEAK_BF16 = 989e12          # FLOP/s
PEAK_INT8 = 1979e12         # OP/s
PEAK_HBM = 3.35e12          # bytes/s


def _layer(L, Lk, H, I):
    """One attention layer: L queries over Lk keys and values."""
    return (2 * L * H * H * 2 + 2 * Lk * H * H * 2 + 2 * L * Lk * H * 2
            + 2 * L * H * I * 2)


def _encoder(L, E, layers=None):
    n = E["num_hidden_layers"] if layers is None else layers
    return n * _layer(L, L, E["hidden_size"], E["intermediate_size"])


def icka_flops(L: int, m: dict, offset: int) -> int:
    """The flagship's product FLOPs for one pair of sentence length L."""
    E, Ll = m["embedding"], m["last_encoder"]
    H, I, R, C = (E["hidden_size"], E["intermediate_size"], m["region_dim"],
                  m["clip_dim"])
    P, W, Hl, T = (m["prompt_len"], m["prompt_hidden"], m["last_hidden"],
                   m["num_labels"])
    V = m["num_regions"]
    n1 = m["layer_num1"]
    f = _encoder(L, E)
    f += 2 * V * R * H                                   # vismap2text
    f += n1 * _layer(L, V, H, I)                         # txt2img
    f += 2 * C * H                                       # vismapping
    f += 2 * n1 * _layer(1, L, H, I)                     # align_0, align_1
    f += 2 * (H * W * P + W * P * H * P)                 # map_alignment
    f += 2 * (R * W * P + W * P * H * P)                 # map_vision
    if H != Hl:
        f += 2 * 2 * P * H * Hl
    f += _encoder(offset - 2 + 2 * P + L, Ll)            # prompted encoder
    f += 2 * H * H + 2 * H                               # gate
    f += 2 * L * Hl * 8 * Hl + 2 * L * 2 * Hl * 4 * Hl   # BiLSTM
    f += 2 * L * 2 * Hl * T                              # classifier
    return f


def gate_cl_flops(L: int, m: dict, offset: int = 0) -> int:
    """gate_cl's product FLOPs for one pair of length L."""
    E = m["encoder"]
    H, I, R, T = (E["hidden_size"], E["intermediate_size"], m["region_dim"],
                  m["num_labels"])
    V = m["num_regions"]
    f = _encoder(L, E) + 2 * H * H                       # BERT, pooler
    f += 2 * V * R * H + m["layer_num1"] * _layer(L, V, H, I)
    f += 2 * L * 2 * H * 2                               # relation classifier
    f += 2 * 2 * L * H * H                               # gate_text, image
    f += 2 * L * 2 * H * T                               # classifier
    f += 2 * (3 * H * H + R * H)                         # contrastive heads
    return f


TEXT_FLOPS = {"icka": icka_flops, "gate_cl": gate_cl_flops}


def resnet_convs(layers, size: int):
    """(kernel, stride, Cin, Cout, Hout) of every convolution of one image
    of `size` squared, in forward order."""
    out = [(7, 2, 3, 64, (size + 1) // 2)]
    h = out[0][4] // 2
    cin = 64
    for s, n in enumerate(layers):
        w = 64 * 2 ** s
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            ho = h // stride
            out += [(1, 1, cin, w, h), (3, stride, w, w, ho),
                    (1, 1, w, 4 * w, ho)]
            if b == 0:
                out.append((1, stride, cin, 4 * w, ho))
            h, cin = ho, 4 * w
    return out


def resnet_ops(layers, size: int) -> int:
    """Integer operations (2 per multiply-add) of one image."""
    return sum(2 * ho * ho * k * k * ci * co
               for k, _, ci, co, ho in resnet_convs(layers, size))


def attention_bound_s(B, S, heads, d, elem_bytes=2) -> float:
    """Least time of one self-attention call: q, k, v read and the output
    written once, the fp32 key bias read once; QK^T and PV at the bf16
    peak."""
    nbytes = 4 * B * S * heads * d * elem_bytes + B * S * 4
    flops = 4 * B * heads * S * S * d
    return max(nbytes / PEAK_HBM, flops / PEAK_BF16)


def bottleneck_bound_s(B, H, Cw, last: bool) -> float:
    """Least time of one integer-resident identity block: the int8 input
    read, the output (bf16 for a stage's last block) written, the three
    int8 weights and their fp32 scales and biases read once."""
    C = 4 * Cw
    w = C * Cw + 9 * Cw * Cw + Cw * C
    nbytes = (B * H * H * C * (1 + (2 if last else 1)) + w
              + 4 * 2 * (Cw + Cw + C))
    ops = 2 * B * H * H * w
    return max(nbytes / PEAK_HBM, ops / PEAK_INT8)


def stem_bound_s(B, size: int) -> float:
    """Least time of the stem kernel: its int8 patches (B, S/4, S/4, 432)
    read, the weight and vectors read, the pooled bf16 (B, S/4, S/4, 64)
    written; the 7x7/s2 convolution's operations."""
    ob = size // 4
    nbytes = B * ob * ob * 432 + 432 * 256 + 4 * 2 * 256 \
        + B * ob * ob * 64 * 2
    ops = 2 * B * ((size + 1) // 2) ** 2 * 147 * 64
    return max(nbytes / PEAK_HBM, ops / PEAK_INT8)


def backbone_kernel_bounds(layers, B: int, size: int) -> dict:
    """{"stem": s, "bottleneck": s} least times of one backbone call's
    kernel launches: the stem once, every identity block once."""
    h = size // 4
    total = 0.0
    for s, n in enumerate(layers):
        if s > 0:
            h //= 2
        for b in range(1, n):
            total += bottleneck_bound_s(B, h, 64 * 2 ** s, b == n - 1)
    return {"stem": stem_bound_s(B, size), "bottleneck": total}


def k1_calls(family: str, m: dict, offset: int, bucket: int, rows: int):
    """[(B, S, heads, head_dim, launches)] of the self-attention calls one
    device batch of `bucket` hands the fused attention kernel (the stacks
    whose configuration routes self-attention through it)."""
    def stack(E, S):
        if not E.get("use_pallas"):
            return []
        N = E["num_attention_heads"]
        return [(rows, S, N, E["hidden_size"] // N, E["num_hidden_layers"])]

    if family == "icka":
        return (stack(m["embedding"], bucket)
                + stack(m["last_encoder"],
                        offset - 2 + 2 * m["prompt_len"] + bucket))
    return stack(m["encoder"], bucket)
