"""Trainer for the gate_cl family (port of
`icka_tpu.train.gate_cl_trainer`).

The model reads the bare sentence (the loader's `ori_*` fields), trains on
alpha * CRF + (1 - alpha) * (relation loss + InfoNCE) ("ip": the CRF
alone) and evaluates with CRF decode and the flagship's chunk-F1 pipeline.
Everything else is `ICKATrainer`'s: the frozen backbone and
`model_inputs`, the train step with its seeded per-microbatch generators,
accumulation and non-finite true skip, the optimizer and its decay mask,
`fit` with best-F1 saves, step snapshots, `resume` and preemption, and the
JAX `ICKATrainState` layout of `state_tree` / `state_from_checkpoint`, so
snapshots resume in both directions with the JAX package's
`GateCLTrainer`.

Two behaviours follow `ICKATrainer`'s and are recorded there: `fit` sets
the loader's `epoch` when it resumes, so a run resumed in a later epoch
sees the uninterrupted run's batches (the JAX loader reshuffles it with
`seed + 0`: a deliberate difference). And, as in the JAX package, the
evaluation computes no dev loss for this family: `EvalResult.loss` is
0.0.

Data parallelism runs through `ICKATrainer`'s loop. The CRF and relation
terms are means over rows, so equal shares of a microbatch need no weight
(`loss_share` is 1). The in-batch terms see the whole microbatch, as the
JAX package's SPMD program does: each rank gathers the cross-modal
features for the relation classifier's swapped pairs and the contrastive
projections for InfoNCE from every rank (`core.mesh.RowSplit`, with their
gradients), so the ranks compute the one-rank step in every variant.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from icka_tpu_torch.core.config import GateCLConfig, TrainConfig
from icka_tpu_torch.core.mesh import Mesh, RowSplit
from icka_tpu_torch.data.labels import MNER_LABELS
from icka_tpu_torch.models.gate_cl import GateCLModel
from icka_tpu_torch.train.trainer import EvalResult, ICKATrainer


def model_args(inputs: Mapping) -> dict:
    """`GateCLModel`'s keyword inputs from `ICKATrainer.model_inputs`: the
    bare sentence, its segments and mask, and the image."""
    return {"input_ids": inputs["ori_input_ids"],
            "segment_ids": inputs["ori_segment_ids"],
            "input_mask": inputs["ori_input_mask"],
            "img_mask": inputs["img_mask"],
            "visual_mean": inputs["visual_mean"],
            "visual_grid": inputs["visual_grid"]}


class GateCLTrainer(ICKATrainer):
    """`GateCLModel` and the frozen float visual backbone on `device` (the
    card unless the caller asks for the CPU) or on `mesh`'s, computing in
    `train_cfg.compute_dtype` over fp32 parameters; the model's weights
    come from `train_cfg.seed`."""

    def __init__(self, model_cfg: GateCLConfig, train_cfg: TrainConfig,
                 label_list=None, mesh: Optional[Mesh] = None,
                 resnet_layers=(3, 8, 36, 3), device="cuda"):
        super().__init__(model_cfg, train_cfg, spec=None,
                         label_list=label_list or MNER_LABELS, mesh=mesh,
                         resnet_layers=resnet_layers, device=device)

    def _build_model(self, dtype):
        return GateCLModel(self.model_cfg, dtype=dtype, device=self.device,
                           seed=self.train_cfg.seed).eval()

    def loss(self, batch: Mapping, image_gen=None, dropout_gen=None,
             rows: Optional[RowSplit] = None):
        """The training loss of one microbatch: train-mode crop and flip
        drawn from `image_gen`, dropout from `dropout_gen`; either None
        runs that part deterministically. With `rows` (a rank's rows of a
        microbatch the data axis splits) the in-batch terms cover the
        whole microbatch (`GateCLModel.forward`)."""
        inputs = self.model_inputs(batch, image_gen)
        return self.model(**model_args(inputs), labels=inputs["label_ids"],
                          dropout_gen=dropout_gen, rows=rows)

    def loss_share(self, micro: Mapping, start: int, stop: int) -> float:
        """1: the CRF and relation terms are means over rows, and the
        data axis splits a microbatch into equal shares."""
        return 1.0

    def eval_step(self, batch: Mapping):
        """(tags (B, L), None): no dev loss for this family."""
        with torch.inference_mode():
            return self.model(**model_args(self.model_inputs(batch))), None

    def _dev_message(self, result: EvalResult) -> str:
        return f" dev f1={result.f1:.4f}"

    def evaluate(self, loader) -> EvalResult:
        """The JAX package's: P/R/F1, accuracy and the report; the loss is
        its 0.0 and there are no per-class scores."""
        return dataclasses.replace(super().evaluate(loader), per_class=None)
