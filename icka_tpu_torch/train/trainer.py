"""Training and evaluation loops (port of `icka_tpu.train.trainer`).

`ICKATrainer` holds the flagship model and the frozen float visual
backbone on one device (the card unless the caller asks for the CPU), or on
each rank of a data-parallel mesh (`icka_tpu_torch.core.mesh`).

Training (the reference's `train_and_dev`): a loader batch (accum,
micro_batch, ...) runs microbatch by microbatch through train-mode image
preprocessing (random crop and flip), the frozen backbone, `ICKAModel(mode=
"train")` with dropout and the CRF token-mean NLL; the microbatch gradients
are summed and divided by `accum`; a step whose loss or any gradient is not
finite is skipped outright (params, moments, step count and schedule stay
put); otherwise the port's AdamW (`train.optimizer`) clips by global norm
and updates the fp32 master weights in place. The backbone runs without
gradients and never joins the optimizer: the JAX package differentiates
`params` only, so `fine_tune_cnn` moves no backbone weight there either.
Each step's random draws come from generators seeded by (seed, epoch,
batch, microbatch), so a resumed run draws what the uninterrupted run drew.
`fit` checks preemption before each step, evaluates dev every epoch and
saves the best-F1 state and a step snapshot; `state_tree` is the JAX
`ICKATrainState`'s state dict, so both packages resume each other's
snapshots.

Data parallelism (`mesh` with more than one rank, the JAX trainers' data
axis): every rank gets the same global batch and runs its rows of each
microbatch. The crop, flip and dropout draws are made at the whole
microbatch's shape and cut to the rank's rows (`RowDraws`), and each
rank's token-mean loss is weighted by its share of the microbatch's
tokens, so the ranks together compute the step that one rank computes on
the whole batch. After accumulation the gradients are averaged over the
ranks in flat buckets; the finite flag is agreed by a MIN all-reduce, so
every rank applies or skips together; the reported loss is the global
mean. Under `TrainConfig.zero1` each rank keeps its slice of the moments
(`train.optimizer.Zero1`). `evaluate` splits each batch's rows and gathers
the tags, so every rank returns the same result; in `fit` only rank 0 logs
and writes, with barriers around each write, and a preemption request on
any rank stops every rank before the same step.

Tensor parallelism (`TrainConfig.model_axis` above 1, a (data, model)
mesh): the model is built whole from the seed and each rank keeps its
slices of the leaves `param_partition_specs` splits
(`icka_tpu_torch.parallel.tensor`); its layers run their collectives over
the model group, and the ranks of one data index compute the one-rank
step on their rows. Every data-axis agreement above runs over the data
group (the ranks of one model index); the finite flag, preemption and the
barriers over every rank. The gradients of replicated leaves a rank uses
in part (column-parallel biases) are summed over the model group before
the data mean, the global norm sums the split leaves' squares over the
model group, ZeRO-1 cuts the model slices over the data axis, and
`state_tree` gathers every leaf to the JAX layout (`state_from_checkpoint`
cuts it again), so snapshots resume across mesh shapes in both
directions. Dropout draws each mask at the whole batch and every head or
column and cuts it, so every mesh draws what one rank draws.

Evaluation (the reference's `test()`): images -> eval preprocessing ->
backbone -> `ICKAModel(mode="dev", loss_reduction="none")`, the padded
tail rows dropped, the exact token-mean loss, the reference's label
filtering and the chunk-F1 evaluator.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from icka_tpu_torch.convert import (backbone_state_dict,
                                    backbone_variables_from_state_dict,
                                    flax_tree_from_state_dict,
                                    state_dict_from_flax)
from icka_tpu_torch.core.checkpoint import Bfloat16Array
from icka_tpu_torch.core.config import ICKAConfig, TrainConfig
from icka_tpu_torch.core.dtypes import DTypePolicy
from icka_tpu_torch.core.mesh import (Mesh, MeshSpec, RowDraws, RowSplit,
                                      make_mesh, shard_batch)
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
from icka_tpu_torch.parallel.collectives import (all_gather_objects,
                                                 all_reduce_mean_)
from icka_tpu_torch.parallel.partitioning import (shard_params,
                                                  shard_train_state)
from icka_tpu_torch.parallel.tensor import CollectiveClock, tensor_parallel
from icka_tpu_torch.train.optimizer import AdamState, Zero1, make_optimizer

CROP_SIZE = 224


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


@dataclass
class StepRecord:
    """One train step: its global number before the step, the mean
    microbatch loss (over every rank), whether it was applied (False:
    skipped as not finite), the gradients' global norm before clipping
    (None when skipped), and host-clock seconds of the whole step, of the
    agreement across ranks (the all-reduces; 0 without a process group),
    of the optimizer update and, within it, of ZeRO-1's gather, each
    ending in a synchronise; and the tensor-parallel collectives the
    layers ran in the step (`TensorParallel.clock`: their count, and
    their seconds when it is timed, else 0)."""

    step: int
    loss: float
    applied: bool
    grad_norm: float | None
    seconds: float
    update_seconds: float
    reduce_seconds: float = 0.0
    gather_seconds: float = 0.0
    tp_calls: int = 0
    tp_seconds: float = 0.0


def _seed(*words: int) -> int:
    """A 63-bit seed from a tuple of integers (numpy's SeedSequence)."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ICKATrainer:
    """The flagship model and its frozen visual backbone on `device` (the
    card unless the caller asks for the CPU), or on `mesh`'s device (by
    default the mesh of `train_cfg.data_axis` and `train_cfg.model_axis`
    over the process group's ranks: one rank without a group). Both
    compute in `train_cfg.compute_dtype` with fp32 parameters, as the JAX
    trainer; the model's weights come from `train_cfg.seed`, the same on
    every rank (on a model axis each rank keeps its slices of them, laid
    out by `tp`). `init_state` (or `fit`) builds the optimizer; `step`
    counts the updates applied."""

    def __init__(self, model_cfg: ICKAConfig, train_cfg: TrainConfig,
                 spec: PromptSpec, label_list=None,
                 mesh: Optional[Mesh] = None,
                 resnet_layers=(3, 8, 36, 3), device="cuda"):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.spec = spec
        self.label_list = label_list
        self.mesh = mesh or make_mesh(
            MeshSpec(data=train_cfg.data_axis, model=train_cfg.model_axis),
            device=device)
        self.device = self.mesh.device
        dtype = DTypePolicy.from_str(train_cfg.compute_dtype).compute_dtype
        self.model = self._build_model(dtype)
        self.tp = (tensor_parallel(self.model, self.mesh)
                   if self.mesh.model > 1 else None)
        self.backbone = VisualBackbone(resnet_layers, dtype=dtype,
                                       device=self.device,
                                       seed=train_cfg.seed + 1).eval()
        self.backbone.requires_grad_(False)
        self.optimizer = None
        self.opt_state = None
        self.zero1 = None
        self.step = 0
        self.records: list[StepRecord] = []

    def _build_model(self, dtype):
        """The model, its weights from `train_cfg.seed`, in eval mode."""
        return ICKAModel(self.model_cfg, dtype=dtype, device=self.device,
                         seed=self.train_cfg.seed).eval()

    # -- state ---------------------------------------------------------------

    def params(self) -> dict:
        """{name: parameter} as this rank holds them (its slices on a
        model axis)."""
        return dict(self.model.named_parameters())

    def init_state(self, total_steps: int) -> None:
        """The optimizer of `total_steps` updates (the warmup-linear
        schedule's length) and its zero state (under ZeRO-1, this rank's
        slices); the step count restarts."""
        params = self.params()
        # ZeRO-1 cuts by the whole shapes (a rank's model slices have
        # the whole size along the data cut)
        shapes = (self.tp.shapes if self.tp is not None else
                  {n: tuple(p.shape) for n, p in params.items()})
        self.zero1 = (Zero1(self.mesh, shapes)
                      if self.train_cfg.zero1 else None)
        self.optimizer = make_optimizer(self.train_cfg, total_steps, params,
                                        zero1=self.zero1, tp=self.tp)
        self.opt_state = self.optimizer.init(params)
        self.step = 0

    def state_tree(self) -> dict:
        """The JAX `ICKATrainState`'s state dict: `step`, `params`,
        `opt_state` in optax's chain layout ((clip), (adam, masked decay,
        schedule)) and `backbone_variables`, as numpy trees with flax's
        leaf names and layouts (a bf16 first moment as bf16). Under ZeRO-1
        the moments are gathered over the data axis first, and on a model
        axis every split leaf over the model axis: every rank calls it."""
        count = np.asarray(int(self.opt_state.count), np.int32)
        mu, nu = self.opt_state.mu, self.opt_state.nu
        params = self.model.state_dict()
        if self.zero1 is not None:
            shapes = {n: tuple(p.shape) for n, p in self.params().items()}
            mu, nu = (self.zero1.gathered(m, shapes) for m in (mu, nu))
        if self.tp is not None:
            params, mu, nu = (self.tp.gathered(t) for t in (params, mu, nu))
        mu = flax_tree_from_state_dict(mu)
        if self.optimizer.mu_dtype == torch.bfloat16:
            mu = _map_leaves(Bfloat16Array.from_float32, mu)
        return {
            "step": np.asarray(self.step, np.int32),
            "params": flax_tree_from_state_dict(params),
            "opt_state": {"0": {}, "1": {
                "0": {"count": count, "mu": mu,
                      "nu": flax_tree_from_state_dict(nu)},
                "1": {"inner_state": {}},
                "2": {"count": count}}},
            "backbone_variables": backbone_variables_from_state_dict(
                self.backbone.state_dict()),
        }

    def save_state(self, checkpointer, metric=None) -> None:
        """`checkpointer.save` of `state_tree()` at the current step, by
        rank 0 only, between barriers (every rank calls it)."""
        gathers = self.zero1 is not None or self.tp is not None
        tree = self.state_tree() if self.mesh.leader or gathers else None
        self.mesh.barrier()
        if self.mesh.leader:
            checkpointer.save(tree, step=self.step, metric=metric)
        self.mesh.barrier()

    def state_from_checkpoint(self, state: Mapping) -> None:
        """Load a JAX train state (as `Checkpointer.restore_best` or
        `resume` gives it): `params` and `backbone_variables` into the model
        and the backbone, every name checked; and, once the optimizer
        exists, `step` and the moments and count of `opt_state` (this
        rank's slices on a model axis and under ZeRO-1)."""
        self.model.load_state_dict(
            shard_params(state_dict_from_flax(state["params"]), self.mesh),
            strict=True)
        self.backbone.load_state_dict(
            backbone_state_dict(state["backbone_variables"]), strict=True)
        if self.optimizer is None:
            return
        adam = state["opt_state"]["1"]["0"]
        params = self.params()
        moments = {key: state_dict_from_flax(adam[key]) for key in ("mu",
                                                                  "nu")}
        for key, m in moments.items():
            if m.keys() != params.keys():
                raise ValueError(f"opt_state {key} names differ from the "
                                 f"model's parameters")
        count = torch.tensor(int(adam["count"]), dtype=torch.int32)
        host = shard_train_state(AdamState(count, **moments), self.mesh,
                                 zero1=self.zero1 is not None)
        self.opt_state.mu = {n: host.mu[n].to(self.device,
                                              self.optimizer.mu_dtype)
                             for n in params}
        self.opt_state.nu = {n: host.nu[n].to(self.device, torch.float32)
                             for n in params}
        self.opt_state.count = count
        self.step = int(state["step"])

    # -- steps ---------------------------------------------------------------

    def model_inputs(self, batch: Mapping, image_gen=None) -> dict:
        """A loader batch -> the model's tensors on the device: the images
        through preprocessing (train-mode crop and flip drawn from
        `image_gen` when given, else eval) and the backbone, `visual_mean`
        as fp32 and the 7x7 grid. An image smaller than the crop passes
        whole, as the JAX package's slice passes the tiny CLI's 64x64
        decode."""
        images = batch["images"]
        pixels = preprocess_images(images, min(CROP_SIZE, images.shape[1]),
                                   device=self.device,
                                   train=image_gen is not None,
                                   generator=image_gen)
        with torch.no_grad():
            _, mean, att = self.backbone(pixels)
        out = {k: torch.from_numpy(np.asarray(v)).to(self.device)
               for k, v in batch.items() if k not in ("images", "row_valid")}
        for k, v in out.items():
            if not v.is_floating_point():
                out[k] = v.long()
        out["visual_mean"] = mean.float()
        out["visual_grid"] = att
        return out

    def loss(self, batch: Mapping, image_gen=None, dropout_gen=None,
             rows: Optional[RowSplit] = None):
        """The token-mean CRF NLL of one microbatch in train mode: crop and
        flip drawn from `image_gen` (a CPU generator) and dropout from
        `dropout_gen` (a generator on the device); either None runs that
        part deterministically (eval preprocessing, no dropout). `rows`
        places a rank's rows in the microbatch; this loss has no term
        across rows and does not read it."""
        inputs = self.model_inputs(batch, image_gen)
        labels = inputs.pop("label_ids")
        return self.model(inputs, self.spec.mask_positions, self.spec.offset,
                          mode="train", labels=labels,
                          deterministic=dropout_gen is None,
                          dropout_gen=dropout_gen)

    def loss_share(self, micro: Mapping, start: int, stop: int) -> float:
        """The weight on a rank's loss over rows [start, stop) of a
        microbatch that the data axis splits, for the mean over the ranks
        to be the whole microbatch's loss: the token-mean NLL's share of
        the microbatch's tokens, times the data size."""
        mask = np.asarray(micro["output_mask"])
        return (float(mask[start:stop].sum()) * self.mesh.data
                / float(mask.sum()))

    def local_gradients(self, batch: Mapping, key):
        """This rank's part of a step over a loader batch (accum,
        micro_batch, ...), whose draws `key` (epoch, batch index) seeds:
        its rows of every microbatch (`loss` gets their `RowSplit`), the
        gradients summed and divided by `accum`. Returns (the loss summed
        over microbatches, {name: gradient}, a 0-d bool tensor: loss and
        gradients finite)."""
        params = self.params()
        for p in params.values():
            p.grad = None
        accum = len(batch["input_ids"])
        total = len(batch["input_ids"][0])
        start, stop = self.mesh.rows(total)
        split = stop - start < total
        loss_sum = torch.zeros((), device=self.device)
        for a in range(accum):
            micro = {k: v[a] for k, v in batch.items()}
            seed = _seed(self.train_cfg.seed, *key, a)
            image_gen = torch.Generator().manual_seed(seed)
            dropout_gen = torch.Generator(self.device).manual_seed(seed)
            rows = None
            if split:
                image_gen = RowDraws(image_gen, start, stop, total)
                dropout_gen = RowDraws(dropout_gen, start, stop, total)
                rows = RowSplit(start, stop, total, self.mesh.group)
            loss = self.loss({k: v[start:stop] for k, v in micro.items()},
                             image_gen, dropout_gen, rows)
            if split:
                loss = loss * self.loss_share(micro, start, stop)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        grads = {}
        finite = torch.isfinite(loss_sum)
        for n, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[n] = g.div_(accum)
            finite = finite & torch.isfinite(g).all()
        return loss_sum, grads, finite

    def reduce_gradients(self, loss_sum, grads: Mapping, finite):
        """The ranks' agreement on a step (nothing to agree without a
        process group): the finite flag by a MIN all-reduce over every
        rank, so every rank applies or skips together; the loss sum and,
        when the step is applied, the gradients (in place, flat buckets)
        averaged over the data group, after the gradients of the leaves
        used in part are summed over the model group. A data axis of one
        beside a model axis has nothing to average. Returns (the global
        loss sum, applied)."""
        group = self.mesh.group
        if group is None:
            return loss_sum, bool(finite)
        flag = finite.to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN,
                        group=self.mesh.world_group)
        average = self.tp is None or self.mesh.data > 1
        loss = loss_sum.reshape(1).clone()
        if average:
            all_reduce_mean_([loss], group)
        applied = bool(flag.item())
        if applied:
            if self.tp is not None:
                self.tp.sum_partial_(grads)
            if average:
                all_reduce_mean_(list(grads.values()), group)
        return loss[0], applied

    def train_step(self, batch: Mapping, key) -> StepRecord:
        """One optimizer step over a loader batch (accum, micro_batch,
        ...). `key` (epoch, batch index) seeds its random draws. Returns
        (and appends to `records`) the step's record; the loss is the mean
        over the microbatches (and the ranks)."""
        t0 = time.perf_counter()
        params = self.params()
        clock = self.tp.clock if self.tp is not None else CollectiveClock()
        tp_calls, tp_seconds = clock.calls, clock.seconds
        loss_sum, grads, finite = self.local_gradients(batch, key)
        _sync(self.device)
        t1 = time.perf_counter()
        loss_sum, applied = self.reduce_gradients(loss_sum, grads, finite)
        # a step with a non-finite loss or gradient is a TRUE skip: params,
        # moments, step count and so the schedule stay put
        _sync(self.device)
        t2 = time.perf_counter()
        gathered = self.zero1.seconds if self.zero1 is not None else 0.0
        norm = None
        if applied:
            norm = float(self.optimizer.update(grads, self.opt_state,
                                               params))
            self.step += 1
        for p in params.values():
            p.grad = None
        record = StepRecord(
            step=self.step - applied,
            loss=float(loss_sum / len(batch["input_ids"])),
            applied=applied, grad_norm=norm,
            seconds=time.perf_counter() - t0,
            update_seconds=time.perf_counter() - t2,
            reduce_seconds=t2 - t1,
            gather_seconds=(self.zero1.seconds - gathered
                            if self.zero1 is not None else 0.0),
            tp_calls=clock.calls - tp_calls,
            tp_seconds=clock.seconds - tp_seconds)
        self.records.append(record)
        return record

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

    def fit(self, train_loader, dev_loader=None, epochs=None,
            total_steps=None, checkpointer=None, log=print,
            preemption_guard=None) -> list:
        """The JAX package's `fit`: `epochs` (default
        `num_train_epochs`) over `train_loader`, dev evaluation after each
        epoch and a best-F1 save (state and step snapshot) through
        `checkpointer`. A checkpointer that holds step snapshots resumes
        the latest one (params, moments and step) and continues at its
        epoch and batch; each epoch's shuffle is its own (the loader's
        `epoch` is set), so a resumed run sees the uninterrupted run's
        batches. A `preemption_guard` that is set before a step, on any
        rank, snapshots the last completed step and returns. On a mesh of
        several ranks only rank 0 logs and writes. Returns each epoch's
        mean train loss."""
        cfg = self.train_cfg
        epochs = epochs or cfg.num_train_epochs
        steps_per_epoch = len(train_loader)
        total_steps = total_steps or steps_per_epoch * epochs
        if self.optimizer is None:
            self.init_state(total_steps)
        start_epoch, skip_batches = 0, 0
        if not self.mesh.leader:
            log = _silent
        if checkpointer is not None and checkpointer.manifest["steps"]:
            tree, ck_step = checkpointer.resume()
            self.state_from_checkpoint(tree)
            del tree
            start_epoch, skip_batches = divmod(ck_step, steps_per_epoch)
            log(f"resumed from step {ck_step} "
                f"(epoch {start_epoch}, batch {skip_batches})")
        best_f1 = (checkpointer.manifest["best_metric"]
                   if checkpointer is not None
                   and checkpointer.manifest["best_metric"] is not None
                   else -1.0)
        history = []
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            losses = []
            train_loader.epoch = epoch
            for i, batch in enumerate(train_loader):
                if epoch == start_epoch and i < skip_batches:
                    continue                  # trained before the resume
                if preemption_guard is not None and \
                        self._any_rank(preemption_guard.requested):
                    if checkpointer is not None:
                        self.save_state(checkpointer)
                    log(f"preempted: saved step {self.step}, exiting fit")
                    return history
                losses.append(self.train_step(batch, (epoch, i)).loss)
            train_loss = (float(np.mean(np.asarray(losses, np.float32)))
                          if losses else float("nan"))
            msg = (f"epoch {epoch}: train_loss={train_loss:.4f} "
                   f"({time.time() - t0:.1f}s)")
            if dev_loader is not None:
                result = self.evaluate(dev_loader)
                msg += self._dev_message(result)
                if result.f1 > best_f1:
                    best_f1 = result.f1
                    if checkpointer is not None:
                        self.save_state(checkpointer, metric=result.f1)
            log(msg)
            history.append(train_loss)
        return history

    def _any_rank(self, flag: bool) -> bool:
        """`flag` agreed over the ranks: True on every rank when it is
        True on any."""
        if self.mesh.world_group is None:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX,
                        group=self.mesh.world_group)
        return bool(t.item())

    def _dev_message(self, result: EvalResult) -> str:
        return (f" dev_loss={result.loss:.4f} f1={result.f1:.4f} "
                f"p={result.precision:.4f} r={result.recall:.4f}")

    def evaluate(self, loader) -> EvalResult:
        """Every batch through `eval_step` (on a mesh, each rank its rows,
        the tags and NLLs gathered: every rank returns the same result),
        the padded tail rows dropped, the reference's label filtering and
        the chunk-F1 evaluator. The loss is the exact token mean of the
        rows' NLLs; 0.0 where `eval_step` gives none."""
        y_true_all, y_pred_all = [], []
        yt_idx_all, yp_idx_all = [], []
        nll_sum = 0.0
        token_sum = 0.0
        rows = batches = 0
        t0 = time.perf_counter()
        label_map = {l: i for i, l in enumerate(
            self.label_list or MNER_LABELS, 1)}
        label_map["PAD"] = 0
        hosts, outs = [], []
        for batch in loader:
            batch = dict(batch)
            # padded-tail duplicates (the loader pads the last eval batch
            # by repeating the final row) are dropped before metrics AND
            # the loss: per-row NLLs + token counts aggregate to the exact
            # token-mean loss of the unpadded dataset
            row_valid = batch.pop("row_valid", None)
            n = (int(np.sum(row_valid)) if row_valid is not None
                 else len(batch["label_ids"]))
            start, stop = self.mesh.rows(len(batch["label_ids"]))
            pred, row_nll = self.eval_step(shard_batch(self.mesh, batch))
            outs.append((pred.cpu().numpy(), None if row_nll is None
                         else row_nll.cpu().numpy()))
            hosts.append((n, stop - start < len(batch["label_ids"]),
                          np.asarray(batch["label_ids"]),
                          np.asarray(batch["output_mask"])))
        ranks = all_gather_objects(outs, self.mesh.group)
        for i, (n, split, label_ids, output_mask) in enumerate(hosts):
            # a split batch's rows are the ranks' rows in rank order; an
            # unsplit one ran whole on every rank
            pred, row_nll = ((np.concatenate([r[i][0] for r in ranks]),
                              None if ranks[0][i][1] is None else
                              np.concatenate([r[i][1] for r in ranks]))
                             if split else ranks[0][i])
            if row_nll is not None:
                nll_sum += float(np.sum(row_nll[:n]))
            token_sum += float(np.sum(output_mask[:n]))
            yt, yp, yt_idx, yp_idx = filter_predictions(
                pred[:n], label_ids[:n], output_mask[:n], self.label_list)
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


def _silent(*args) -> None:
    """The log of a rank other than 0."""


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)
