"""KV-cached incremental decoding for the GPT-2 decoder stack (port of
`icka_tpu.generation.gpt2_cache`).

Counterpart of `generation.kv_cache` (the Oscar captioner) for
`models.gpt2.GPT2Decoder`, the decoder behind the ChunkAlign rationale
family (`modeling_vcr_chunkalign_v10.py:1322-2827`). The reference
re-encodes the whole buffer every step (its `beam_sample` passes the full
`input_ids` each iteration, :2255-2258); here a step is O(L):

  - cross-attention K/V over the (fixed) encoder memory are computed once
    per layer;
  - causal self-attention K/V live in preallocated (B, max_len, N, Hd)
    buffers, written at position t each step, so beam search re-gathers
    hypotheses by batch indexing;
  - each step embeds one token and runs every pre-LN block on a (B, 1, D)
    query.

It reads a `GPT2Decoder`'s weights directly: the same module serves the
full teacher-forced pass and cached decode. float32 throughout, as in the
JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from icka_tpu_torch.generation.kv_cache import (_attend, _dense, _layernorm,
                                                _split)


@torch.no_grad()
def precompute_gpt2_cache(decoder, memory, memory_mask, max_len: int) -> dict:
    """Per-layer cross-attention K/V over the encoder memory (for blocks
    with cross-attention) and empty causal self-attention buffers. All
    leaves lead with the batch."""
    cfg = decoder.cfg
    N = cfg.n_head
    dev = decoder.wte.device
    mem = torch.as_tensor(memory, device=dev).float()
    B = mem.shape[0]
    Hd = cfg.n_embd // N
    layers = []
    for block in decoder.blocks():
        entry = {"k": torch.zeros(B, max_len, N, Hd, device=dev),
                 "v": torch.zeros(B, max_len, N, Hd, device=dev)}
        if block.with_cross:
            entry["mem_k"] = _split(_dense(block.k_cross, mem), N)
            entry["mem_v"] = _split(_dense(block.v_cross, mem), N)
        layers.append(entry)
    memory_mask = torch.as_tensor(memory_mask, device=dev)
    mem_bias = ((1.0 - memory_mask.float()) * -10000.0)[:, None, None, :]
    return {"layers": layers, "mem_bias": mem_bias}


@torch.no_grad()
def cached_gpt2_step(decoder, lm_kernel, token_t, t: int, cache):
    """One incremental decode step: (B,) token ids at position t -> ((B,
    vocab) logits, the cache). `lm_kernel` is the LM head's (D, V) matrix:
    an untied head's, or `decoder.wte.T` for the tied one. The step writes
    position t of the self-attention buffers in place."""
    cfg = decoder.cfg
    N = cfg.n_head
    eps = cfg.layer_norm_eps
    max_len = cache["layers"][0]["k"].shape[1]

    x = (decoder.wte[token_t] + decoder.wpe[t])[:, None, :].float()
    pos = torch.arange(max_len, device=x.device)
    causal_bias = torch.where(pos <= t, 0.0, -10000.0)[None, None, None, :]

    for block, lc in zip(decoder.blocks(), cache["layers"]):
        q, k_t, v_t = _dense(block.c_attn, _layernorm(block.ln_1, x, eps)) \
            .split(cfg.n_embd, dim=-1)
        lc["k"][:, t] = _split(k_t, N)[:, 0]
        lc["v"][:, t] = _split(v_t, N)[:, 0]
        ctx = _attend(_split(q, N), lc["k"], lc["v"], causal_bias)
        x = x + _dense(block.c_proj, ctx)

        if "mem_k" in lc:
            h = _layernorm(block.ln_cross, x, eps)
            ctx = _attend(_split(_dense(block.q_cross, h), N), lc["mem_k"],
                          lc["mem_v"], cache["mem_bias"][:, :, :1, :])
            x = x + _dense(block.cross_proj, ctx)

        h = _layernorm(block.ln_2, x, eps)
        h = F.gelu(_dense(block.c_fc, h), approximate="tanh")
        x = x + _dense(block.mlp_proj, h)

    x = _layernorm(decoder.ln_f, x, eps)
    return x[:, 0] @ lm_kernel.float(), cache
