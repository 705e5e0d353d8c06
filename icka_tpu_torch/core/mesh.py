"""The (data, model) mesh over `torch.distributed` (port of
`icka_tpu.core.mesh`).

One process per rank; a rank is the counterpart of a device on the JAX
mesh, whose row-major (data, model) grid it keeps: rank = d * model + m.
Every rank gets the same global batch (or the same requests), takes the
rows of its data index d, and ends holding the same answer, as the JAX SPMD
program does. The ranks of one data index split the model's layers between
them (tensor parallelism, `icka_tpu_torch.parallel.tensor`) over their
model group; the ranks of one model index average their gradients over
their data group.

`init_distributed` starts the process group from torchrun's environment
(or from explicit arguments): NCCL when every rank of the host owns a GPU
of its own, gloo otherwise, whether the ranks share a card (NCCL refuses
two ranks on one GPU; gloo carries CUDA tensors through the host for
`all_reduce` and `broadcast`) or run on the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional

import torch
import torch.distributed as dist

from icka_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world_size() -> int:
    """The ranks of the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclass(frozen=True)
class MeshSpec:
    data: int = -1     # -1 = every rank (one without a process group)
    model: int = 1

    def resolve(self, n_devices: int | None = None) -> tuple[int, int]:
        n = n_devices if n_devices is not None else world_size()
        model = max(1, self.model)
        data = self.data if self.data > 0 else max(1, n // model)
        return data, model


@dataclass(frozen=True)
class Mesh:
    """The port's mesh: its data and model sizes, this rank's index on the
    data axis (`rank`) and its data group (the ranks of its model index;
    None without a process group: a mesh of one rank), the device this
    rank computes on, and, where the model axis has more than one rank,
    its index on that axis (`model_rank`), its model group (the ranks of
    its data index) and the group of every rank (`world`; without it the
    data group is every rank)."""

    data: int
    model: int
    rank: int
    group: Any
    device: torch.device
    model_rank: int = 0
    model_group: Any = None
    world: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def world_group(self):
        """The group of every rank of the mesh (None without one)."""
        return self.world if self.world is not None else self.group

    @property
    def leader(self) -> bool:
        """Whether this is rank 0 of the grid, the one that logs and
        writes."""
        return self.rank == 0 and self.model_rank == 0

    def rows(self, n: int) -> tuple[int, int]:
        """This rank's rows [start, stop) of a dimension of `n` split over
        the data axis: its 1/data share when the axis divides `n`, else all
        of them (replicated, as the JAX package's `_put` replicates)."""
        if n % self.data:
            return 0, n
        share = n // self.data
        return self.rank * share, (self.rank + 1) * share

    def barrier(self) -> None:
        if self.world_group is not None:
            dist.barrier(group=self.world_group)


def make_mesh(spec: MeshSpec | None = None, device="cuda") -> Mesh:
    """The mesh of `spec` over the default process group's ranks (a
    world of one without a group), on `device` (the card unless the caller
    asks for the CPU; with a group, the rank's own card as
    `init_distributed` set it). Ranks form the JAX package's row-major
    grid: rank = d * model + m. Raises `ValueError` when the mesh needs
    more ranks than there are, as the JAX package does, or covers fewer
    (the port runs one rank per device of the mesh). With a model axis
    every rank calls it: it creates every data and model group."""
    spec = spec or MeshSpec()
    world = world_size()
    data, model = spec.resolve(world)
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, have {world}")
    if data * model < world:
        raise ValueError(f"mesh {data}x{model} covers {data * model} of "
                         f"{world} ranks; run one rank per device of the "
                         f"mesh")
    dev = resolve_device(device)
    if not dist.is_initialized():
        return Mesh(data, model, 0, None, dev)
    d, m = divmod(dist.get_rank(), model)
    if model == 1:
        return Mesh(data, model, d, dist.group.WORLD, dev)
    # every rank creates every group, in the same order
    data_groups = [dist.new_group([i * model + j for i in range(data)])
                   for j in range(model)]
    model_groups = [dist.new_group([i * model + j for j in range(model)])
                    for i in range(data)]
    return Mesh(data, model, d, data_groups[m], dev, model_rank=m,
                model_group=model_groups[d], world=dist.group.WORLD)


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world: Optional[int] = None) -> torch.device:
    """Start the default process group and return this rank's device.
    Rank and world size come from torchrun's environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`/`PORT`)
    unless given, with `init_method` (e.g. ``tcp://localhost:29500`` or
    ``file:///path``) in place of the environment's address.

    On CUDA (the default; the CPU only when the caller asks) the rank
    computes on card `LOCAL_RANK % device_count`, and the backend is NCCL
    when every rank of the host has a card of its own, else gloo. On the
    CPU it is gloo. Rank 0 prints which it chose and why."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= cards else "gloo"
        why = (f"{local_world} ranks on this host, {cards} CUDA devices: "
               + ("one each" if backend == "nccl" else
                  "ranks share a card, which NCCL refuses"))
    else:
        backend, why = "gloo", "the CPU"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    if rank == 0:
        print(f"init_distributed: {world} ranks, backend {backend} ({why})",
              flush=True)
    return dev


def _rows_of(mesh: Mesh, x, dim: int):
    """This rank's rows of `x` (a numpy array or tensor) along `dim`; all
    of them where the data axis does not divide that dimension or `x` has
    no such dimension (the JAX package's `_put`)."""
    if x.ndim <= dim:
        return x
    lo, hi = mesh.rows(x.shape[dim])
    return x[(slice(None),) * dim + (slice(lo, hi),)]


def shard_batch(mesh: Mesh, batch: Mapping) -> dict:
    """This rank's rows of every leaf of a host batch (leading dimension
    split over the data axis)."""
    return {k: _rows_of(mesh, v, 0) for k, v in batch.items()}


def shard_accum_batch(mesh: Mesh, batch: Mapping) -> dict:
    """Train batches are (accum, micro_batch, ...): this rank's rows of
    the micro-batch axis; the accumulation axis stays whole."""
    return {k: _rows_of(mesh, v, 1) for k, v in batch.items()}


@dataclass(frozen=True)
class RowDraws:
    """The random draws of one rank's rows [start, stop) of a batch of
    `total` rows: every draw is made at the whole batch's shape from
    `generator` and cut to the rows (`draw`), so each data-axis size draws
    what one rank draws (dropout masks, crop offsets and flips). It keeps
    the generator's state interface, which `nn.remat` saves and restores."""

    generator: torch.Generator
    start: int
    stop: int
    total: int

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows placed in a zero batch and summed over the group
    (an exact copy: each element is one rank's value plus zeros). The
    gradient of a row is its gradient summed over the ranks, returned to
    the rank that holds the row. Both collectives run in fp32."""

    @staticmethod
    def forward(ctx, x, start, total, group):
        ctx.rows, ctx.group = (start, start + x.shape[0]), group
        full = x.new_zeros((total,) + x.shape[1:], dtype=torch.float32)
        full[start:start + x.shape[0]] = x
        dist.all_reduce(full, group=group)
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        full = grad.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(full, group=ctx.group)
        lo, hi = ctx.rows
        return full[lo:hi].to(grad.dtype), None, None, None


@dataclass(frozen=True)
class RowSplit:
    """One rank's rows [start, stop) of a batch of `total` rows that the
    data axis splits over `group`'s ranks, for a loss with terms across
    rows (gate_cl's in-batch negatives): `gather` gives every rank the
    whole batch of a per-row tensor, differentiably. A rank whose loss
    holds such a term over the whole batch, beside the means over its own
    rows, computes with the ranks the one-rank loss and gradient once the
    losses and gradients are averaged over the ranks."""

    start: int
    stop: int
    total: int
    group: Any

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(total, ...) from this rank's rows `x` (stop - start, ...)."""
        return _GatherRows.apply(x, self.start, self.total, self.group)


def draw(sample: Callable, shape, generator, cut=None):
    """`sample(shape, generator)`, a torch sampling call; for `RowDraws`
    the same call at the whole batch's shape, cut to this rank's rows.
    `cut` (dim, start, total) says that dimension `dim` of `shape` is this
    rank's slice [start, start + shape[dim]) of a dimension of `total`
    that the model axis splits (attention heads, a column-parallel
    layer's columns): the draw is made at `total` there too and cut, so
    every model rank draws what one rank draws."""
    shape = list(shape)
    full, index = list(shape), [slice(None)] * len(shape)
    if cut is not None:
        dim, start, total = cut
        dim %= len(shape)
        full[dim], index[dim] = total, slice(start, start + shape[dim])
    if isinstance(generator, RowDraws):
        if shape[0] != generator.stop - generator.start:
            raise ValueError(f"a draw of {shape[0]} rows from RowDraws of "
                             f"rows [{generator.start}, {generator.stop})")
        full[0] = generator.total
        index[0] = slice(generator.start, generator.stop)
        generator = generator.generator
    if full == shape:
        return sample(tuple(shape), generator)
    return sample(tuple(full), generator)[tuple(index)]
