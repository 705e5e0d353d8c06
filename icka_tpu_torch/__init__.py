"""icka_tpu_torch: the ICKA multimodal NER framework in PyTorch, with all
six of its TPU kernels written by hand in CUDA C++ for NVIDIA Hopper
(sm_90a): short-sequence attention (K1) and blockwise attention (K2) in
`kernels.attention`, the four int8 conv kernels (K3-K6) in `kernels.conv`.

The module layout and names follow `icka_tpu`, the JAX package this one is
held against, so each module has a counterpart there. This package imports
nothing of `icka_tpu` or JAX. It covers, for the flagship model, serving
(bucketed and sequence-packed, float and int8-static):

    data.images.preprocess_images -> models.resnet.VisualBackbone
        -> serving.bucketed.BucketedICKAServer (or
           serving.packing.PackedICKAServer) -> models.icka.ICKAModel

the evaluation entry point, text to F1 (`cli.evaluate`):

    data.conll -> data.tokenization -> data.features -> data.loader
        -> train.trainer.ICKATrainer (VisualBackbone, ICKAModel "dev")
        -> train.trainer.filter_predictions -> evaluation

and training (`cli.train`, `train.trainer.ICKATrainer.fit`). The gate_cl
family (the my_bert models, `models.gate_cl.GateCLModel` in its "ip", "cl"
and "gate_cl" variants, and the BERT text-only baseline
`models.token_classifier.TokenClassifier`) is served by
`serving.bucketed.BucketedGateCLServer` and
`serving.packing.PackedGateCLServer`, and trained and evaluated by
`train.gate_cl_trainer.GateCLTrainer` (`cli.train --model gate_cl|cl|ip`).

Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version.
"""
