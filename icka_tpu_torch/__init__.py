"""icka_tpu_torch: the ICKA multimodal NER framework in PyTorch, with all
six of its TPU kernels written by hand in CUDA C++ for NVIDIA Hopper
(sm_90a): short-sequence attention (K1) and blockwise attention (K2) in
`kernels.attention`, the four int8 conv kernels (K3-K6) in `kernels.conv`.

The module layout and names follow `icka_tpu`, the JAX package this one is
held against, so each module has a counterpart there. This package imports
nothing of `icka_tpu` or JAX. It covers:

  - serving, bucketed and sequence-packed, float and int8-static
    (calibration, `models.convert`'s quantisers, the fused-QKV layout),
    for the flagship `ICKAModel` (`serving.bucketed.BucketedICKAServer`,
    `serving.packing.PackedICKAServer`) and for the gate_cl family, the
    my_bert models (`models.gate_cl.GateCLModel` in its "ip", "cl" and
    "gate_cl" variants, `serving.bucketed.BucketedGateCLServer`,
    `serving.packing.PackedGateCLServer`) and the BERT text-only baseline
    (`models.token_classifier.TokenClassifier`);
  - the evaluation entry point, text to F1 (`cli.evaluate`);
  - training (`train.trainer.ICKATrainer`,
    `train.gate_cl_trainer.GateCLTrainer`, `cli.train`), with snapshots
    in the JAX package's layout;
  - the data axis of the JAX package's mesh on `torch.distributed`
    (`core.mesh`, `parallel`): data-parallel training with ZeRO-1 and
    data-parallel bucketed serving, one process per rank;
  - weights from files on disk (`models.pretrained`: HF directories with
    `pytorch_model.bin` or `model.safetensors`, native msgpack
    directories, TF-1.x BERT bundles, torchvision ResNet `.pth`;
    `cli.convert`);
  - the chunker and the generation stack (`models.chunker`,
    `generation`, `models.captioning`, `models.gpt2`), and the VCR task
    plane: ChunkAlign's classifiers and rationale decoders
    (`models.chunkalign`, `models.chunkalign_baselines`), the Oscar heads
    (`models.oscar`), ensembles (`models.ensemble`), the GPT-2 captioner,
    the task processors (`data.task_processors`), retrieval metrics
    (`evaluation.retrieval`) and TSV files (`utils.tsv_file`).

Public surface, imported lazily (no kernel is built on import; a kernel is
built at its first launch):

    icka_tpu_torch.ICKAConfig / GateCLConfig / TrainConfig / EncoderConfig
        / DataConfig
    icka_tpu_torch.ICKAModel / GateCLModel / VisualBackbone
    icka_tpu_torch.ICKATrainer / GateCLTrainer
    icka_tpu_torch.CRF
    icka_tpu_torch.BucketedGateCLServer / BucketedICKAServer
        / PackedGateCLServer
    icka_tpu_torch.load_text_encoder / load_backbone
    icka_tpu_torch.ChunkAlignConfig / ChunkAlignCLS / ChunkAlignRationale
        / GPT2Captioner / OscarMultipleChoice

Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version.
"""

_LAZY = {
    "ICKAConfig": "icka_tpu_torch.core.config",
    "GateCLConfig": "icka_tpu_torch.core.config",
    "TrainConfig": "icka_tpu_torch.core.config",
    "EncoderConfig": "icka_tpu_torch.core.config",
    "DataConfig": "icka_tpu_torch.core.config",
    "ICKAModel": "icka_tpu_torch.models.icka",
    "GateCLModel": "icka_tpu_torch.models.gate_cl",
    "VisualBackbone": "icka_tpu_torch.models.resnet",
    "ICKATrainer": "icka_tpu_torch.train.trainer",
    "GateCLTrainer": "icka_tpu_torch.train.gate_cl_trainer",
    "CRF": "icka_tpu_torch.nn.crf",
    "BucketedGateCLServer": "icka_tpu_torch.serving.bucketed",
    "BucketedICKAServer": "icka_tpu_torch.serving.bucketed",
    "PackedGateCLServer": "icka_tpu_torch.serving.packing",
    "load_text_encoder": "icka_tpu_torch.models.pretrained",
    "load_backbone": "icka_tpu_torch.models.pretrained",
    "ChunkAlignConfig": "icka_tpu_torch.models.chunkalign",
    "ChunkAlignCLS": "icka_tpu_torch.models.chunkalign",
    "ChunkAlignRationale": "icka_tpu_torch.models.chunkalign",
    "GPT2Captioner": "icka_tpu_torch.models.gpt2",
    "OscarMultipleChoice": "icka_tpu_torch.models.oscar",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(_LAZY[name])
        return getattr(module, name)
    raise AttributeError(f"module 'icka_tpu_torch' has no attribute "
                         f"{name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
