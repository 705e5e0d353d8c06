"""icka_tpu_torch: the ICKA multimodal NER framework in PyTorch, with its
attention kernel written by hand in CUDA C++ for NVIDIA Hopper (sm_90a).

The module layout and names follow `icka_tpu`, the JAX package this one is
held against, so each module has a counterpart there. This package imports
nothing of `icka_tpu` or JAX. It covers the inference path that serves:

    data.images.preprocess_images -> models.resnet.VisualBackbone
        -> serving.bucketed.BucketedICKAServer -> models.icka.ICKAModel

and the evaluation entry point, text to F1 (`cli.evaluate`):

    data.conll -> data.tokenization -> data.features -> data.loader
        -> train.trainer.ICKATrainer (VisualBackbone, ICKAModel "dev")
        -> train.trainer.filter_predictions -> evaluation

Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version.
"""
