"""Typed configuration, a copy of `icka_tpu.core.config`'s encoder and ICKA
dataclasses and of the evaluation fields of its `TrainConfig`.

Field names and defaults are identical to the JAX package's, so a
``config.json`` written there loads here unchanged. In this package
``use_pallas`` routes self-attention through the hand-written Hopper kernel
(`icka_tpu_torch.kernels.attention`) instead of the plain PyTorch core.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


def _from_dict(cls, d: dict) -> Any:
    names = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue
        t = names[k].type
        if isinstance(v, dict) and t not in ("dict", dict):
            sub = _NESTED.get((cls.__name__, k))
            kwargs[k] = _from_dict(sub, v) if sub else v
        else:
            kwargs[k] = v
    return cls(**kwargs)


@dataclass(frozen=True)
class EncoderConfig:
    """Transformer encoder hyperparameters (legacy BERT and HF RoBERTa)."""

    vocab_size: int = 50265
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 514
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    # RoBERTa reserves position ids 0/1 for padding; BERT uses 0-based
    # positions. `position_offset` = pad_token_id + 1 for RoBERTa (=2), 0 for
    # BERT-style encoders.
    position_offset: int = 2
    pad_token_id: int = 1
    # route self-attention through the fused attention kernel
    # (`icka_tpu_torch.kernels.attention`) instead of the plain core
    use_pallas: bool = False
    # "none" only in this package so far: the encoders' int8 modes are not
    # ported (the visual backbone's are arguments of `VisualBackbone`)
    quant: str = "none"
    # training-only in the JAX package (activation rematerialisation);
    # inference here ignores both
    remat: bool = False
    remat_policy: str = "dots"
    # one fused (H, 3H) QKV projection; not ported yet
    fuse_qkv: bool = False
    # softmax dtype of the plain attention core (the kernel path is always
    # fp32 softmax)
    softmax_dtype: str = "float32"
    # >0 inserts a Pfeiffer adapter in every FFN; not ported yet
    adapter_size: int = 0

    @classmethod
    def roberta_large(cls) -> "EncoderConfig":
        return cls()

    @classmethod
    def roberta_base(cls) -> "EncoderConfig":
        return cls(hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, intermediate_size=3072)

    @classmethod
    def bert_base(cls) -> "EncoderConfig":
        return cls(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, intermediate_size=3072,
                   max_position_embeddings=512, layer_norm_eps=1e-12,
                   position_offset=0, pad_token_id=0)

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "EncoderConfig":
        """Small config for unit tests."""
        return cls(vocab_size=vocab_size, hidden_size=32,
                   num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=64, max_position_embeddings=192)


@dataclass(frozen=True)
class ICKAConfig:
    """The flagship ICKA model and its ablation flags (all True = full
    ICKA): use_txt2img, use_alignment, use_vision_prompt,
    use_alignment_prompt, use_gate (False blends with `gate_fixed`)."""

    embedding: EncoderConfig = field(default_factory=EncoderConfig.roberta_large)
    last_encoder: EncoderConfig = field(default_factory=EncoderConfig.roberta_large)
    num_labels: int = 15
    layer_num1: int = 5                  # txt2img fusion depth
    layer_num2: int = 2
    layer_num3: int = 2
    num_regions: int = 49                # 7x7 ResNet grid
    region_dim: int = 2048
    clip_dim: int = 512
    prompt_len: int = 5                  # per-prompt prefix slots
    prompt_hidden: int = 756             # mapping-network width
    last_hidden: int = 1024              # last_encoder output width
    max_seq_length: int = 128
    use_txt2img: bool = True
    use_alignment: bool = True
    use_vision_prompt: bool = True
    use_alignment_prompt: bool = True
    use_gate: bool = True
    gate_fixed: float = 0.5
    # Serving-exactness knob: padding timesteps hold the BiLSTM state, so
    # bucketed decode equals the 128-padded layout at valid positions.
    # False = torch nn.LSTM parity (the recurrence runs over the padding).
    masked_lstm: bool = False

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "ICKAConfig":
        enc = EncoderConfig.tiny(vocab_size)
        return cls(embedding=enc, last_encoder=enc, layer_num1=2,
                   num_regions=49, region_dim=64, clip_dim=32,
                   prompt_len=5, prompt_hidden=48, last_hidden=enc.hidden_size,
                   max_seq_length=32)


@dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX package's `TrainConfig` that evaluation reads,
    with its names and defaults; the optimiser and loop fields wait for
    training to be ported."""

    eval_batch_size: int = 1
    compute_dtype: str = "bfloat16"      # or "float32"


_NESTED = {
    ("ICKAConfig", "embedding"): EncoderConfig,
    ("ICKAConfig", "last_encoder"): EncoderConfig,
}


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)


def from_json(cls, text: str):
    return _from_dict(cls, json.loads(text))


def save_config(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_json(cfg))


def load_config(cls, path: str):
    with open(path) as f:
        return from_json(cls, f.read())
