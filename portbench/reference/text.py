"""Plain reference of the two text models the benchmark serves: the
flagship ICKA model and the gate_cl family's "gate_cl" variant, in
inference mode, on a state dict keyed as the served models' are.

A frozen copy of the served models' arithmetic with everything else
stripped: no kernels, no int8 modes, no dropout, no model axis, no packed
layout. Every product runs through `Precision.mm`, in float32 for the
reference (TF32 off) or in a lower precision for the control. It imports
nothing of the program.

Semantics kept from the published models, departures none:
  - legacy-BERT layers, post-LN, TF-style LayerNorm (eps inside the square
    root, fp32 statistics), erf-gelu, additive -10000 key masks;
  - RoBERTa pad-aware position ids (`position_offset > 0`), BERT 0-based
    positions otherwise;
  - ICKA: txt2img cross-attention over the mapped 7x7 grid, CLIP
    alignment, two prompt prefixes spliced at the two mask positions of
    the prompted RoBERTa, the relevance gate, the BiLSTM over the whole
    padded width (torch nn.LSTM parity), the classifier;
  - gate_cl: BERT, txt2img, the relation classifier over the
    (max_seq_length, 2H) flatten, the sigmoid gate, the classifier;
  - the CRF's Viterbi path and the score of any path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -10000.0
FP8_MAX = 448.0


class Precision:
    """How a product's operands are rounded before an fp32 product:
    "fp32" leaves them, "fp8" rounds each operand to float8 e4m3 under a
    per-tensor abs-max scale (the precision below bf16)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def round(self, x):
        x = x.float()
        if self.kind == "fp32":
            return x
        s = x.abs().amax().clamp_min(1e-12) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, a, b):
        """a @ b in fp32 on rounded operands."""
        return torch.matmul(self.round(a), self.round(b))

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.round(a), self.round(b))


def dense(p, name, x, prec):
    return prec.mm(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


def layer_norm(p, name, x, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p[f"{name}.scale"] \
        + p[f"{name}.bias"]


def key_bias(mask):
    """{0,1} (B, S) -> additive (B, 1, 1, S)."""
    return (1.0 - mask.float())[:, None, None, :] * NEG


def attention(p, name, x, kv, bias, heads, prec):
    q, k, v = (dense(p, f"{name}.{n}", t, prec)
               for n, t in (("query", x), ("key", kv), ("value", kv)))
    B, Sq, D = q.shape
    Sk, d = k.shape[1], D // heads
    q = q.reshape(B, Sq, heads, d)
    k = k.reshape(B, Sk, heads, d)
    v = v.reshape(B, Sk, heads, d)
    s = prec.einsum("bqnh,bknh->bnqk", q, k) * d ** -0.5
    if bias is not None:
        s = s + bias
    probs = torch.softmax(s, dim=-1)
    return prec.einsum("bnqk,bknh->bqnh", probs, v).reshape(B, Sq, D)


def attention_layer(p, name, x, kv, bias, cfg, prec):
    """attn -> attn_out (dense, residual, LN) -> ffn (wi, gelu, wo,
    residual, LN); `kv` None is self-attention."""
    eps = cfg["layer_norm_eps"]
    a = attention(p, f"{name}.attn", x, x if kv is None else kv, bias,
                  cfg["num_attention_heads"], prec)
    x = layer_norm(p, f"{name}.attn_out.norm",
                   dense(p, f"{name}.attn_out.dense", a, prec) + x, eps)
    h = dense(p, f"{name}.ffn.wo",
              F.gelu(dense(p, f"{name}.ffn.wi", x, prec)), prec)
    return layer_norm(p, f"{name}.ffn.norm", h + x, eps)


def depth(p, name) -> int:
    """Layers of the stack `name` in the state dict."""
    pre = f"{name}.layer_"
    return len({k[len(pre):].split(".")[0] for k in p if k.startswith(pre)})


def stack(p, name, x, kv, bias, cfg, prec):
    for i in range(depth(p, name)):
        x = attention_layer(p, f"{name}.layer_{i}", x, kv, bias, cfg, prec)
    return x


def position_ids(ids_or_mask, cfg, from_mask=False):
    """RoBERTa-style (pad-aware cumsum from pad + 1) when position_offset
    > 0, else 0..S-1."""
    B, S = ids_or_mask.shape
    if cfg["position_offset"] > 0:
        pad = cfg["pad_token_id"]
        m = (ids_or_mask.long() if from_mask
             else (ids_or_mask != pad).long())
        return torch.cumsum(m, dim=1) * m + pad
    return torch.arange(S, device=ids_or_mask.device).expand(B, S)


def embed(p, name, tok, pos, types, cfg):
    x = (tok + p[f"{name}.position_embeddings"][pos]
         + p[f"{name}.token_type_embeddings"][types])
    return layer_norm(p, f"{name}.norm", x, cfg["layer_norm_eps"])


def text_encoder(p, name, ids, mask, types, cfg, prec):
    emb = p[f"{name}.embeddings.word_embeddings"][ids]
    x = embed(p, f"{name}.embeddings", emb, position_ids(ids, cfg), types,
              cfg)
    return stack(p, f"{name}.encoder", x, None, key_bias(mask), cfg, prec)


def splice(seq, prompt, m1, m2):
    P = prompt.shape[1] // 2
    return torch.cat([seq[:, :m1], prompt[:, :P], seq[:, m1 + 1:m2],
                      prompt[:, P:], seq[:, m2 + 1:]], dim=1)


def prompt_encoder(p, name, ids, mask, types, prefix, prompt_mask,
                   mask_positions, cfg, prec):
    m1, m2 = mask_positions
    P = prefix.shape[1] // 2
    tok = p[f"{name}.embeddings.word_embeddings"][ids]
    x = splice(tok, prefix, m1, m2)
    smask = splice(mask.long(), prompt_mask.long(), m1, m2)
    stypes = torch.cat([types[:, :m1], types[:, m1:m1 + 1].expand(-1, P),
                        types[:, m1 + 1:m2], types[:, m2:m2 + 1].expand(-1, P),
                        types[:, m2 + 1:]], dim=1)
    x = embed(p, f"{name}.embeddings", x, position_ids(smask, cfg, True),
              stypes, cfg)
    return stack(p, f"{name}.encoder", x, None, key_bias(smask), cfg, prec)


def mapping(p, name, x, prompt_len, hidden, prec):
    x = torch.tanh(dense(p, f"{name}.wi", x, prec))
    x = dense(p, f"{name}.wo", x, prec)
    return x.reshape(x.shape[0], prompt_len, hidden)


def fusion_gate(p, lang, img, eps, prec):
    """flax LayerNorm (variance as E[x^2] - E[x]^2, clamped at 0) ->
    proj -> aux_head -> sigmoid."""
    x = lang + img
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    x = (x - mean) * (torch.rsqrt(var + eps) * p["gate.norm.scale"]) \
        + p["gate.norm.bias"]
    return torch.sigmoid(dense(p, "gate.aux_head",
                               dense(p, "gate.proj", x, prec), prec))


def bilstm(p, name, x, prec):
    """Single-layer bidirectional LSTM over the whole width, gate order
    i, f, g, o; the backward direction over the reversed sequence."""
    B, L, _ = x.shape
    outs = []
    for d in ("fwd", "bwd"):
        seq = x if d == "fwd" else x.flip(1)
        proj = prec.mm(seq, p[f"{name}.w_ih_{d}"].t()) + p[f"{name}.b_ih_{d}"]
        w_hh = p[f"{name}.w_hh_{d}"].t()
        H = w_hh.shape[0]
        h = x.new_zeros(B, H)
        c = x.new_zeros(B, H)
        hs = []
        for t in range(L):
            g = proj[:, t] + prec.mm(h, w_hh) + p[f"{name}.b_hh_{d}"]
            i, f, gg, o = g.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        hs = torch.stack(hs, dim=1)
        outs.append(hs if d == "fwd" else hs.flip(1))
    return torch.cat(outs, dim=-1)


def icka_emissions(p, cfg, batch, offset, mask_positions, prec):
    """The flagship's emissions (B, b, num_labels) on a bucket-padded batch
    laid out as the bucketed server lays it out (`layout.icka_batch`)."""
    emb, last = cfg["embedding"], cfg["last_encoder"]
    B = batch["ori_input_ids"].shape[0]
    seq = text_encoder(p, "embedding", batch["ori_input_ids"],
                       batch["ori_input_mask"], batch["ori_segment_ids"], emb,
                       prec)
    grid = batch["visual_grid"].reshape(B, -1, batch["visual_grid"].shape[-1])
    grid = dense(p, "vismap2text", grid, prec)
    cross = stack(p, "txt2img", seq, grid, key_bias(batch["img_mask"]), emb,
                  prec)
    text_bias = key_bias(batch["ori_input_mask"])
    clip_tok = dense(p, "vismapping", batch["clip_features"].reshape(B, -1),
                     prec)[:, None, :]
    for name in ("align_0", "align_1"):
        clip_tok = stack(p, name, clip_tok, cross, text_bias, emb, prec)
    H, P = emb["hidden_size"], cfg["prompt_len"]
    align_prompt = mapping(p, "map_alignment", clip_tok.reshape(B, -1), P, H,
                           prec)
    vision_prompt = mapping(p, "map_vision", batch["visual_mean"], P, H, prec)
    prefix = torch.cat([vision_prompt, align_prompt], dim=1)
    prompt_mask = batch["input_mask"][:, :1].expand(-1, 2 * P)
    out = prompt_encoder(p, "last_encoder", batch["input_ids"],
                         batch["input_mask"], batch["segment_ids"], prefix,
                         prompt_mask, mask_positions, last, prec)
    start = offset - 2 + 2 * P
    b = batch["ori_input_ids"].shape[1]
    tok = out[:, start:start + b]
    g = fusion_gate(p, cross[:, 0], tok[:, 0], emb["layer_norm_eps"],
                    prec).reshape(B, 1, 1)
    fused = g * tok + (1.0 - g) * cross
    return dense(p, "classifier", bilstm(p, "lstm", fused, prec), prec)


def gate_cl_emissions(p, cfg, batch, prec):
    """gate_cl's emissions (B, b, num_labels) on a bucket-padded batch laid
    out as the bucketed server lays it out (`layout.gate_cl_batch`)."""
    enc = cfg["encoder"]
    B = batch["input_ids"].shape[0]
    seq = text_encoder(p, "bert", batch["input_ids"], batch["input_mask"],
                       batch["segment_ids"], enc, prec)
    grid = batch["visual_grid"].reshape(B, -1, batch["visual_grid"].shape[-1])
    grid = dense(p, "vismap2text", grid, prec)
    cross = stack(p, "txt2img", seq, grid, key_bias(batch["img_mask"]), enc,
                  prec)
    crs_in = torch.cat([seq, cross], dim=-1)
    L = crs_in.shape[1]
    crs_in = F.pad(crs_in, (0, 0, 0, cfg["max_seq_length"] - L))
    logits = dense(p, "crs_classifier", crs_in.reshape(B, -1), prec)
    P = torch.softmax(logits, dim=-1)[:, -1]
    cross_p = P[:, None, None] * cross
    gate = torch.sigmoid(dense(p, "gate_text", seq, prec)
                         + dense(p, "gate_image", cross_p, prec))
    return dense(p, "classifier", torch.cat([seq, gate * cross_p], dim=-1),
                 prec)


def crf_params(p):
    return (p["crf.start_transitions"].float(),
            p["crf.end_transitions"].float(), p["crf.transitions"].float())


def viterbi(em, start, end, trans):
    """Best path (L,) of one sequence's emissions (L, T), first maximum on
    ties, and its score."""
    em = em.float()
    score = start + em[0]
    back = []
    for t in range(1, em.shape[0]):
        best, arg = (score[:, None] + trans).max(dim=0)
        score = best + em[t]
        back.append(arg)
    final = score + end
    tag = int(torch.argmax(final))
    best = float(final[tag])
    path = [tag]
    for arg in reversed(back):
        tag = int(arg[tag])
        path.append(tag)
    return path[::-1], best


def path_score(em, tags, start, end, trans) -> float:
    """Score of the tag path `tags` (L,) under emissions (L, T)."""
    em = em.float()
    t = torch.as_tensor(tags, dtype=torch.long, device=em.device)
    s = start[t[0]] + em.gather(1, t[:, None]).sum() + end[t[-1]]
    if t.numel() > 1:
        s = s + trans[t[:-1], t[1:]].sum()
    return float(s)


def fp32_strict():
    """TF32 off for every float32 product and convolution."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

