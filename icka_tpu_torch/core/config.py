"""Typed configuration, a copy of `icka_tpu.core.config`'s dataclasses:
encoder, ICKA, gate_cl family, training and data.

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
    # every projection of the encoder's layers: "none", "int8" (dynamic
    # per-row activation scales, the calibration mode) or "int8_static"
    # (calibrated per-tensor scales); the visual backbone's modes are
    # arguments of `VisualBackbone`
    quant: str = "none"
    # activation rematerialisation of the self-attention stack, a training
    # knob (`icka_tpu_torch.nn.remat`: "dots", "dots_nb", "alternate",
    # "full"); a forward without grad ignores both
    remat: bool = False
    remat_policy: str = "dots"
    # one fused (H, 3H) QKV projection in every self-attention (the
    # serving layout; `models.convert.fuse_qkv_params` re-lays weights and
    # calibration); cross-attention keeps query, key and value
    fuse_qkv: bool = False
    # softmax dtype of the plain attention core (the kernel path is always
    # fp32 softmax)
    softmax_dtype: str = "float32"
    # >0 inserts a Pfeiffer bottleneck adapter in every self-attention
    # layer's FFN output sublayer (`nn.attention.FeedForward`), the
    # CoNLL-2000 chunker's (`models.chunker`: bert-base, 768 / 16 = 48)
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
class GateCLConfig:
    """The my_bert model family: one BERT encoder + txt2img fusion + gate +
    CRF, with optional contrastive knowledge alignment and relation-
    classifier gating.

    variant:
      - "ip":      plain concat fusion + CRF
      - "cl":      + InfoNCE contrastive, fixed mix cl_alpha
      - "gate_cl": + relation classifier P-gate + alpha
    """

    encoder: EncoderConfig = field(default_factory=EncoderConfig.bert_base)
    num_labels: int = 15
    layer_num1: int = 1
    num_regions: int = 49
    region_dim: int = 2048
    max_seq_length: int = 128
    variant: str = "gate_cl"
    alpha: float = 0.62                 # loss mix
    cl_alpha: float = 0.88              # the "cl" variant's fixed mix
    temp: float = 0.179                 # InfoNCE temperature
    temp_lamb: float = 0.7              # directional mix
    negative_rate: int = 16             # negative-pair swap count
    # Serving-exactness knob for variant="gate_cl": zero the masked
    # positions of the relation classifier's input before its (L*2H)
    # flatten, so bucketed decode equals the 128-padded layout. False =
    # reference parity: the flatten takes padding-position activations.
    masked_crs: bool = False

    @classmethod
    def tiny(cls, vocab_size: int = 128,
             variant: str = "gate_cl") -> "GateCLConfig":
        return cls(encoder=EncoderConfig.tiny(vocab_size), layer_num1=1,
                   region_dim=64, max_seq_length=16, variant=variant)


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (reference defaults), every field of
    the JAX package's `TrainConfig` with its name and default. The mesh
    (`icka_tpu_torch.core.mesh.MeshSpec`): `data_axis` is the number of
    data-parallel ranks (-1 or any value below 1: every rank of the
    process group over the model axis, one without a group), `model_axis`
    the number of tensor-parallel ranks that split each layer
    (`icka_tpu_torch.parallel.tensor`), and `zero1` splits Adam's moments
    over the data axis (`train.optimizer.Zero1`)."""

    learning_rate: float = 3e-5
    weight_decay: float = 0.01
    warmup_proportion: float = 0.1
    num_train_epochs: int = 25
    train_batch_size: int = 1
    eval_batch_size: int = 1
    gradient_accumulation_steps: int = 5
    max_grad_norm: float = 1.0
    seed: int = 19260817
    fine_tune_cnn: bool = False
    compute_dtype: str = "bfloat16"      # or "float32"
    data_axis: int = 1                  # mesh size along the data axis
    model_axis: int = 1                 # mesh size along the model (TP) axis
    # ZeRO-1: Adam moments split over the data axis
    zero1: bool = False
    # dtype of the Adam first moment (mu); bf16 halves its memory. The
    # second moment stays fp32 (sqrt(nu) precision gates the update).
    mu_dtype: str = "float32"


@dataclass(frozen=True)
class DataConfig:
    """Dataset locations and preprocessing."""

    data_dir: str = "data/twitter2015"
    path_image: str = "data/twitter2015_images"
    crop_size: int = 224
    max_seq_length: int = 128
    task_name: str = "twitter2015"


_NESTED = {
    ("ICKAConfig", "embedding"): EncoderConfig,
    ("ICKAConfig", "last_encoder"): EncoderConfig,
    ("GateCLConfig", "encoder"): EncoderConfig,
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
