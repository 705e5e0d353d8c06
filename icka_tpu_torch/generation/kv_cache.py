"""KV-cached incremental decoding for the captioning model (port of
`icka_tpu.generation.kv_cache`).

`CaptionModel.decode_step` re-encodes the whole prefix every step. This
module decodes incrementally:

  - the Oscar seq2seq mask (`models.captioning.seq2seq_mask`) lets image
    rows attend only over image rows, so the image part of every layer is
    caption-independent: its per-layer K/V are computed once;
  - caption K/V live in preallocated (B, max_len, N, Hd) buffers, written
    at position t by an indexed write each step (the JAX package's
    `dynamic_update_slice`);
  - each step embeds one token, runs every layer on a (B, 1, D) query and
    attends over [caption cache <= t ; image K/V].

It reads the weights of the port's `CaptionModel` directly, so one module
serves training, full decode and cached decode. Everything is computed in
float32 on the plain attention core, as in the JAX package; the LM head is
the tied one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from icka_tpu_torch.generation.decoding import beam_search, greedy_decode
from icka_tpu_torch.nn.layers import gelu


def _dense(layer, x):
    return F.linear(x, layer.weight, layer.bias)


def _layernorm(norm, x, eps: float):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * norm.scale + norm.bias


def _split(x, n_heads: int):
    B, S, D = x.shape
    return x.reshape(B, S, n_heads, D // n_heads)


def _attend(q, k, v, bias):
    """(B, Sq, N, Hd) queries over (B, Sk, N, Hd) keys -> (B, Sq, N*Hd)."""
    scores = torch.einsum("bqnh,bknh->bnqk", q, k) * q.shape[-1] ** -0.5
    probs = torch.softmax(scores + bias, dim=-1)
    ctx = torch.einsum("bnqk,bknh->bqnh", probs, v)
    return ctx.reshape(q.shape[0], q.shape[1], -1)


def _ffn(layer, x, eps: float):
    h = _dense(layer.ffn.wo, gelu(_dense(layer.ffn.wi, x)))
    return _layernorm(layer.ffn.norm, h + x, eps)


# The cache is a dict whose leaves ALL lead with the batch (beam search
# re-gathers hypotheses by indexing dim 0):
#   {"layers": [{"cap_k": (B, max_len, N, Hd), "cap_v": ..., "img_k":
#     (B, Li, N, Hd), "img_v": ...} per layer], "img_bias": (B, 1, 1, Li)}


@torch.no_grad()
def precompute_image_cache(model, img_feats, img_mask, max_len: int) -> dict:
    """Run the image-only forward of `model` (a `CaptionModel`) once,
    recording each layer's K/V, beside empty caption buffers."""
    enc = model.cfg.encoder
    N = enc.num_attention_heads
    eps = enc.layer_norm_eps
    dev = model.lm_bias.device
    img_feats = torch.as_tensor(img_feats, device=dev).float()
    img_mask = torch.as_tensor(img_mask, device=dev)
    B, Li, _ = img_feats.shape
    Hd = enc.hidden_size // N

    x = _dense(model.img_embedding, img_feats)
    bias = ((1.0 - img_mask.float()) * -10000.0)[:, None, None, :]

    layers = []
    for layer in model.encoder.layers():
        attn = layer.attn
        k = _split(_dense(attn.key, x), N)
        v = _split(_dense(attn.value, x), N)
        layers.append({
            "img_k": k, "img_v": v,
            "cap_k": torch.zeros(B, max_len, N, Hd, device=dev),
            "cap_v": torch.zeros(B, max_len, N, Hd, device=dev),
        })
        q = _split(_dense(attn.query, x), N)
        a = _dense(layer.attn_out.dense, _attend(q, k, v, bias))
        x = _layernorm(layer.attn_out.norm, a + x, eps)
        x = _ffn(layer, x, eps)
    return {"layers": layers, "img_bias": bias}


@torch.no_grad()
def cached_caption_step(model, token_t, t: int, cache):
    """One incremental decode step: (B,) token ids at position t -> ((B,
    vocab) logits, the cache). The step writes position t of the caption
    buffers in place."""
    enc = model.cfg.encoder
    emb = model.embeddings
    N = enc.num_attention_heads
    eps = enc.layer_norm_eps
    B = token_t.shape[0]
    max_len = cache["layers"][0]["cap_k"].shape[1]
    Li = cache["layers"][0]["img_k"].shape[1]

    x = (emb.word_embeddings[token_t] + emb.position_embeddings[t]
         + emb.token_type_embeddings[0])[:, None, :]            # (B, 1, D)
    x = _layernorm(emb.norm, x, eps)

    # causal mask over the caption cache: positions <= t visible
    pos = torch.arange(max_len, device=x.device)
    cap_bias = torch.where(pos <= t, 0.0, -10000.0)[None, None, None, :]
    bias = torch.cat([cap_bias.expand(B, 1, 1, max_len),
                      cache["img_bias"].expand(B, 1, 1, Li)], dim=-1)

    for layer, lc in zip(model.encoder.layers(), cache["layers"]):
        attn = layer.attn
        q = _split(_dense(attn.query, x), N)                  # (B,1,N,Hd)
        lc["cap_k"][:, t] = _split(_dense(attn.key, x), N)[:, 0]
        lc["cap_v"][:, t] = _split(_dense(attn.value, x), N)[:, 0]
        k_all = torch.cat([lc["cap_k"], lc["img_k"]], dim=1)
        v_all = torch.cat([lc["cap_v"], lc["img_v"]], dim=1)
        a = _dense(layer.attn_out.dense, _attend(q, k_all, v_all, bias))
        x = _layernorm(layer.attn_out.norm, a + x, eps)
        x = _ffn(layer, x, eps)

    # LM head (tied)
    h = _layernorm(model.lm_norm, gelu(_dense(model.lm_transform, x)), eps)
    logits = h[:, 0] @ emb.word_embeddings.float().T
    return logits + model.lm_bias, cache


def generate_captions_cached(model, bos_id: int, eos_id: int, img_feats,
                             img_mask, max_len: int, mode: str = "greedy",
                             num_beams: int = 3, **kw):
    """KV-cached counterpart of `models.captioning.generate_captions`
    (greedy or beam): the same outputs, O(L) attention work a step instead
    of re-encoding the prefix."""
    cache = precompute_image_cache(model, img_feats, img_mask, max_len)
    dev = model.lm_bias.device
    B = cache["img_bias"].shape[0]

    def step(tokens_t, cache, t):
        return cached_caption_step(model, tokens_t, t, cache)

    init = torch.full((B,), bos_id, dtype=torch.long, device=dev)
    if mode == "greedy":
        return greedy_decode(step, init, cache, max_len, eos_id, **kw)
    if mode == "beam":
        return beam_search(step, init, cache, max_len, eos_id,
                           num_beams=num_beams, **kw)
    raise ValueError(f"unknown mode {mode!r}")
