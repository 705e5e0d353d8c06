"""Autoregressive decoding (port of `icka_tpu.generation`): greedy,
sampled and beam search (`decoding`), constrained beam search
(`constrained`), and the KV caches of the Oscar captioner (`kv_cache`) and
the GPT-2 decoder (`gpt2_cache`)."""

from icka_tpu_torch.generation.decoding import (
    DecodeState,
    beam_search,
    greedy_decode,
    sample_decode,
    top_k_top_p_filter,
)

__all__ = [
    "DecodeState",
    "beam_search",
    "greedy_decode",
    "sample_decode",
    "top_k_top_p_filter",
]
