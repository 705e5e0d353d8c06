"""Tensor parallelism over the mesh's model axis, Megatron-style.

The JAX package gets every tensor-parallel collective from GSPMD, out of
its parameter shardings. The port writes them here, from the same specs:
`parallel.partitioning.param_partition_specs` alone decides which leaf is
split and on which dimension. `tensor_parallel(model, mesh)` cuts each
split parameter of a model built whole (from its seed, as one rank builds
it) to this rank's slice, and each layer reads from its own slices which
part it computes:

  - column (`Dense.mode`): attention q/k/v and a `wi` split on their
    output dimension compute their columns, with their slice of the bias;
    the layer after them consumes those (the attention core on local
    heads, the row-parallel `wo`);
  - row: the attention output and a `wo` split on their input dimension
    compute their partial product, sum it over the model group, then add
    the bias once;
  - gathered: a Dense split on its output dimension whose consumer needs
    the whole output computes its columns and gathers the others: a
    kernel the generic rule splits (output width >= 1024: a fused `qkv`,
    an adapter's `adapter_up`), and q/k/v where the axis does not divide
    the heads. A layer that then uses only its part of a whole activation
    (a rank's heads' columns of a fused q/k/v, its columns of a context
    every rank computed) takes it after `copy_to_model`, which sums the
    ranks' gradients of their parts into the whole one;
  - vocabulary-parallel: `word_embeddings` split over the vocabulary
    looks up the ids in the rank's range (zero elsewhere), summed over
    the model group.

The collectives are autograd functions over the model group:
`copy_to_model` (identity forward, the gradient summed backward: where a
replicated activation enters column-parallel layers), `reduce_from_model`
(sum forward, identity backward) and `gather_from_model` (each rank's
columns placed in zeros and summed, an exact copy; the rank's columns of
the gradient backward). They run `all_reduce` only, in fp32, which gloo
carries for CUDA tensors (ranks that share a card) as NCCL does.

Every rank holds every replicated leaf whole and computes the replicated
activations alike, bit for bit, so their gradients agree with no
collective, except where a rank uses only a slice of a replicated leaf (a
column-parallel layer's bias): `TensorParallel.partial` names those, whose
gradients the trainer sums over the model group. Every draw of a dropout
mask is made at the whole shape and cut (`core.mesh.draw`), so every rank
draws what one rank draws.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from icka_tpu_torch.core.mesh import MODEL_AXIS
from icka_tpu_torch.parallel.collectives import (all_gather_slices_,
                                                 all_reduce_sum_, buckets)
from icka_tpu_torch.parallel.partitioning import param_partition_specs


@dataclass
class CollectiveClock:
    """The collectives a model's layers ran: their count, elements and,
    when `timed` (each then synchronises the device before and after), the
    host-clock seconds they took."""

    calls: int = 0
    elements: int = 0
    seconds: float = 0.0
    timed: bool = False


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclass(frozen=True)
class ModelShard:
    """A rank's place on the model axis: its index, the axis's size, the
    model group, and the clock of the collectives run over it."""

    index: int
    size: int
    group: Any
    clock: CollectiveClock = field(default_factory=CollectiveClock,
                                   compare=False)

    def summed(self, x: torch.Tensor) -> torch.Tensor:
        """A new tensor: `x` summed over the model group in fp32, in x's
        dtype."""
        y = x.to(torch.float32, copy=True).contiguous()
        clock = self.clock
        clock.calls += 1
        clock.elements += y.numel()
        if clock.timed:
            _sync(y)
            t0 = time.perf_counter()
        dist.all_reduce(y, group=self.group)
        if clock.timed:
            _sync(y)
            clock.seconds += time.perf_counter() - t0
        return y.to(x.dtype)

    def cut(self, dim: int, local: int) -> tuple[int, int, int]:
        """`core.mesh.draw`'s cut of dimension `dim` whose slice on this
        rank has `local` entries."""
        return dim, self.index * local, local * self.size


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.summed(grad), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return shard.summed(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        n = x.shape[-1]
        ctx.cols = (shard.index * n, n)
        full = x.new_zeros(x.shape[:-1] + (n * shard.size,))
        full[..., shard.index * n:(shard.index + 1) * n] = x
        return shard.summed(full)

    @staticmethod
    def backward(ctx, grad):
        lo, n = ctx.cols
        return grad[..., lo:lo + n], None


def copy_to_model(x: torch.Tensor, shard: Optional[ModelShard]):
    """`x`; its gradient summed over the model group (None: `x`)."""
    return x if shard is None else _CopyToModel.apply(x, shard)


def reduce_from_model(x: torch.Tensor, shard: ModelShard):
    """`x` summed over the model group; the gradient passes unchanged."""
    return _ReduceFromModel.apply(x, shard)


def gather_from_model(x: torch.Tensor, shard: ModelShard):
    """The whole last dimension from every rank's columns `x` (rank i's
    are the i-th of `shard.size` equal parts); the gradient's own columns
    backward."""
    return _GatherFromModel.apply(x, shard)


def column_row_pair(wi, wo) -> Optional[ModelShard]:
    """For a layer whose Dense `wi` feeds its Dense `wo` through an
    elementwise function: where the specs split the pair (`wo` by its
    input, so `wi` by its output), `wi` made "column" (its columns feed
    `wo`'s input slice) and the shard returned; None otherwise."""
    if wo.mode != "row":
        return None
    wi.mode = "column"
    return wi.shard


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor,
                             shard: ModelShard) -> torch.Tensor:
    """`F.embedding(ids, whole table)` from this rank's rows `weight` of
    the table: ids outside them look up zeros, and the ranks' lookups are
    summed (each id's row comes from one rank: exact)."""
    rows = weight.shape[0]
    local = ids - shard.index * rows
    inside = (local >= 0) & (local < rows)
    found = F.embedding(torch.where(inside, local, 0), weight)
    return reduce_from_model(torch.where(inside[..., None], found, 0.0),
                             shard)


@dataclass
class TensorParallel:
    """A model's layout on the model axis: its parameters' whole shapes
    and specs (`param_partition_specs`), this rank's `shard`, the names
    of the split leaves (`split`) and of the replicated leaves a rank uses
    in part (`partial`), and the device to gather on."""

    shard: ModelShard
    shapes: dict
    specs: dict
    partial: frozenset
    device: torch.device

    @property
    def clock(self) -> CollectiveClock:
        return self.shard.clock

    @property
    def split(self) -> frozenset:
        return frozenset(n for n, s in self.specs.items() if MODEL_AXIS in s)

    def dim(self, name: str) -> int:
        return self.specs[name].index(MODEL_AXIS)

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole leaf (a view), or the leaf."""
        if name not in self.split:
            return t
        n = self.shapes[name][self.dim(name)] // self.shard.size
        return t.narrow(self.dim(name), self.shard.index * n, n)

    def sum_partial_(self, grads: Mapping[str, torch.Tensor]) -> None:
        """The partial leaves' gradients summed over the model group, in
        place."""
        names = sorted(n for n in self.partial if n in grads)
        if names:
            all_reduce_sum_([grads[n] for n in names], self.shard.group)

    def gathered(self, tensors: Mapping[str, torch.Tensor]) -> dict:
        """The leaves at their whole shapes, on the CPU, from every rank's
        slices (a collective: every rank of the model group calls it; all
        split leaves of one dtype), one flat bucket at a time, on the
        device under NCCL and on the CPU under gloo (which would stage a
        device tensor through the host). Replicated leaves pass as they
        are, moved to the CPU."""
        names = [n for n in tensors if n in self.split]
        dev = (torch.device("cpu")
               if dist.get_backend(self.shard.group) == "gloo"
               else self.device)
        whole = {}
        for idx in buckets([math.prod(self.shapes[names[i]])
                            for i in range(len(names))]):
            part = {}
            for i in idx:
                n, t = names[i], tensors[names[i]]
                part[n] = torch.empty(self.shapes[n], dtype=t.dtype,
                                      device=dev)
                self.local(n, part[n]).copy_(t)
            all_gather_slices_(
                list(part.values()),
                [(self.dim(n), self.shapes[n][self.dim(n)]
                  // self.shard.size) for n in part],
                self.shard.index, self.shard.group)
            whole.update({n: t.cpu() for n, t in part.items()})
        return {n: whole[n] if n in whole else t.cpu()
                for n, t in tensors.items()}


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def tensor_parallel(model: torch.nn.Module, mesh) -> TensorParallel:
    """Put `model` (built whole, as on one rank) on `mesh`'s model axis,
    in place: each parameter that `param_partition_specs` splits becomes
    this rank's slice, and every layer with a `shard_model_axis(shard,
    specs)` method (children before parents) gets its own parameters'
    specs and returns the names of those it uses only in part. Raises
    `NotImplementedError` for a split parameter that no such layer holds,
    and where a layer refuses the axis. Returns the layout, also kept as
    `model.tp_layout`."""
    params = dict(model.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    specs = param_partition_specs(shapes, mesh.model)
    shard = ModelShard(mesh.model_rank, mesh.model, mesh.model_group)
    modules = list(model.named_modules())
    owners = {_join(prefix, n): m for prefix, m in modules
              for n, _ in m.named_parameters(recurse=False)}
    partial = set()
    for name, spec in specs.items():
        if MODEL_AXIS in spec and not hasattr(owners[name],
                                               "shard_model_axis"):
            raise NotImplementedError(
                f"{name} is split over the model axis but its layer "
                f"({type(owners[name]).__name__}) has no tensor-parallel "
                f"mode")
    layout = TensorParallel(shard, shapes, specs, frozenset(), mesh.device)
    with torch.no_grad():
        for name in layout.split:
            params[name].data = layout.local(name, params[name].data).clone(
                memory_format=torch.contiguous_format)
    for prefix, module in reversed(modules):
        hook = getattr(module, "shard_model_axis", None)
        if hook is not None:
            own = {n: specs[_join(prefix, n)]
                   for n, _ in module.named_parameters(recurse=False)}
            partial.update(_join(prefix, n) for n in hook(shard, own))
    layout.partial = frozenset(partial)
    model.tp_layout = layout
    return layout
