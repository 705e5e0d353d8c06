"""Evaluation loop (port of the eval half of `icka_tpu.train.trainer`).

`ICKATrainer` holds the flagship model and the float visual backbone on
one device, takes their weights from a JAX `Checkpointer` state, and runs
the reference `test()` loop: images -> eval preprocessing -> backbone ->
`ICKAModel(mode="dev", loss_reduction="none")`, the padded tail rows
dropped, the exact token-mean loss, the reference's label filtering and the
chunk-F1 evaluator. The optimiser, the fit loop and checkpoint resume wait
for training to be ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from icka_tpu_torch.convert import backbone_state_dict, icka_state_dict
from icka_tpu_torch.core.config import ICKAConfig, TrainConfig
from icka_tpu_torch.core.device import resolve_device
from icka_tpu_torch.data.features import PromptSpec
from icka_tpu_torch.data.images import preprocess_images
from icka_tpu_torch.data.labels import FILTERED_LABELS, MNER_LABELS, id_to_label
from icka_tpu_torch.evaluation import (
    classification_report,
    evaluate_chunk_f1,
    evaluate_class_f1,
)
from icka_tpu_torch.models.icka import ICKAModel
from icka_tpu_torch.models.resnet import VisualBackbone

CROP_SIZE = 224
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                  "float32": torch.float32, "fp32": torch.float32}


def filter_predictions(pred_ids, label_ids, output_mask, label_list=None):
    """Reference-exact eval filtering (:882-903): walk each row until the first
    masked position, dropping X/<s>/</s>/[CLS]/[SEP] gold positions.
    Returns (y_true_tags, y_pred_tags, y_true_ids, y_pred_ids)."""
    id2lab = id_to_label(label_list)
    y_true, y_pred, y_true_idx, y_pred_idx = [], [], [], []
    for row in range(len(pred_ids)):
        t_tags, p_tags, t_idx, p_idx = [], [], [], []
        for j in range(len(output_mask[row])):
            if not output_mask[row][j]:
                break
            gold = id2lab[int(label_ids[row][j])]
            if gold in FILTERED_LABELS:
                continue
            t_tags.append(gold)
            t_idx.append(int(label_ids[row][j]))
            p_tags.append(id2lab[int(pred_ids[row][j])])
            p_idx.append(int(pred_ids[row][j]))
        y_true.append(t_tags)
        y_pred.append(p_tags)
        y_true_idx.append(t_idx)
        y_pred_idx.append(p_idx)
    return y_true, y_pred, y_true_idx, y_pred_idx


@dataclass
class EvalResult:
    f1: float
    precision: float
    recall: float
    acc: float
    loss: float
    report: str = ""
    per_class: dict = None  # {class: (f1, p, r)} — ner_evaluate
    #                         `evaluate_each_class` parity
    rows: int = 0           # rows evaluated, padded tail rows excluded
    batches: int = 0        # device batches run
    seconds: float = 0.0    # wall time of the loop, host clock


class ICKATrainer:
    """The flagship model and its visual backbone for evaluation, on
    `device` (the card unless the caller asks for the CPU). Both compute in
    `train_cfg.compute_dtype` with fp32 parameters, as the JAX trainer."""

    def __init__(self, model_cfg: ICKAConfig, train_cfg: TrainConfig,
                 spec: PromptSpec, label_list=None,
                 resnet_layers=(3, 8, 36, 3), device="cuda"):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.spec = spec
        self.label_list = label_list
        self.device = resolve_device(device)
        dtype = COMPUTE_DTYPES[train_cfg.compute_dtype]
        self.model = ICKAModel(model_cfg, dtype=dtype,
                               device=self.device).eval()
        self.backbone = VisualBackbone(resnet_layers, dtype=dtype,
                                       device=self.device).eval()

    def state_from_checkpoint(self, state: Mapping) -> None:
        """Load `params` and `backbone_variables` of a JAX train state (as
        `Checkpointer.restore_best` gives it) into the model and the
        backbone, every name checked; `opt_state` and `step` are not
        read."""
        self.model.load_state_dict(
            icka_state_dict({"params": state["params"]}), strict=True)
        self.backbone.load_state_dict(
            backbone_state_dict(state["backbone_variables"]), strict=True)

    def model_inputs(self, batch: Mapping) -> dict:
        """A loader batch -> the model's tensors on the device: the images
        through eval preprocessing and the backbone, `visual_mean` as fp32
        and the 7x7 grid. An image smaller than the crop passes whole, as
        the JAX package's slice passes the tiny CLI's 64x64 decode."""
        images = batch["images"]
        pixels = preprocess_images(images, min(CROP_SIZE, images.shape[1]),
                                   device=self.device)
        _, mean, att = self.backbone(pixels)
        out = {k: torch.from_numpy(np.asarray(v)).to(self.device)
               for k, v in batch.items() if k not in ("images", "row_valid")}
        for k, v in out.items():
            if not v.is_floating_point():
                out[k] = v.long()
        out["visual_mean"] = mean.float()
        out["visual_grid"] = att
        return out

    def eval_step(self, batch: Mapping):
        """(tags (B, L), each row's NLL (B,)) of a loader batch."""
        with torch.inference_mode():
            inputs = self.model_inputs(batch)
            labels = inputs.pop("label_ids")
            # loss_reduction="none": per-row NLL, so the eval loop can
            # aggregate an EXACT token-mean over the unpadded dataset
            return self.model(inputs, self.spec.mask_positions,
                              self.spec.offset, mode="dev", labels=labels,
                              loss_reduction="none")

    def evaluate(self, loader) -> EvalResult:
        y_true_all, y_pred_all = [], []
        yt_idx_all, yp_idx_all = [], []
        nll_sum = 0.0
        token_sum = 0.0
        rows = batches = 0
        t0 = time.perf_counter()
        label_map = {l: i for i, l in enumerate(
            self.label_list or MNER_LABELS, 1)}
        label_map["PAD"] = 0
        for batch in loader:
            batch = dict(batch)
            # padded-tail duplicates (the loader pads the last eval batch
            # by repeating the final row) are dropped before metrics AND
            # the loss: per-row NLLs + token counts aggregate to the exact
            # token-mean loss of the unpadded dataset
            row_valid = batch.pop("row_valid", None)
            n = (int(np.sum(row_valid)) if row_valid is not None
                 else len(batch["label_ids"]))
            pred, row_nll = self.eval_step(batch)
            nll_sum += float(np.sum(row_nll.cpu().numpy()[:n]))
            token_sum += float(
                np.sum(np.asarray(batch["output_mask"])[:n]))
            yt, yp, yt_idx, yp_idx = filter_predictions(
                pred.cpu().numpy()[:n], np.asarray(batch["label_ids"])[:n],
                np.asarray(batch["output_mask"])[:n], self.label_list)
            y_true_all += yt
            y_pred_all += yp
            yt_idx_all += yt_idx
            yp_idx_all += yp_idx
            rows += n
            batches += 1
        m = evaluate_chunk_f1(yp_idx_all, yt_idx_all, label_map)
        report = classification_report(y_true_all, y_pred_all)
        per_class = {
            cls: evaluate_class_f1(yp_idx_all, yt_idx_all, label_map, cls)
            for cls in ("PER", "LOC", "ORG", "MISC")}
        return EvalResult(f1=m.f1, precision=m.precision, recall=m.recall,
                          acc=m.acc,
                          loss=nll_sum / max(token_sum, 1.0),
                          report=report, per_class=per_class,
                          rows=rows, batches=batches,
                          seconds=time.perf_counter() - t0)
