"""Collectives over `torch.distributed` (port of
`icka_tpu.parallel.collectives`), each with the JAX version's
single-process shortcut, and the two bulk collectives of data-parallel
training: the gradients' sum or mean in flat buckets (`all_reduce_sum_`,
`all_reduce_mean_`) and the gather of every rank's slices
(`all_gather_slices_`: ZeRO-1's updated slices, tensor-parallel leaves
gathered to their whole shape).

The bulk collectives use `all_reduce` and `broadcast` only, the two that
gloo carries for CUDA tensors (through the host), so ranks that share one
card run the same code as ranks on cards of their own under NCCL.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

# elements per flat bucket of the bulk collectives (256 MB of fp32): a few
# collectives a step in place of one per leaf, at a bounded extra buffer
BUCKET_ELEMENTS = 1 << 26


def _world(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_gather_objects(obj: Any, group=None) -> List[Any]:
    """Gather a picklable object from every rank (e.g. eval predictions),
    in rank order."""
    if _world(group) == 1:
        return [obj]
    out = [None] * _world(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj: Any, root: int = 0, group=None) -> Any:
    """`root`'s picklable object on every rank."""
    if _world(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root, group=group)
    return box[0]


def psum_across_hosts(x, group=None) -> np.ndarray:
    """Sum a small host array across ranks (eval counters)."""
    if _world(group) == 1:
        return np.asarray(x)
    return np.stack(all_gather_objects(np.asarray(x), group)).sum(axis=0)


def buckets(sizes: Sequence[int], limit: int = BUCKET_ELEMENTS) -> list:
    """Consecutive runs of leaves (as index ranges) of at most `limit`
    elements each; a larger leaf makes a bucket of its own."""
    out, lo, total = [], 0, 0
    for i, n in enumerate(sizes):
        if i > lo and total + n > limit:
            out.append(range(lo, i))
            lo, total = i, 0
        total += n
    if len(sizes):
        out.append(range(lo, len(sizes)))
    return out


def global_rank(group, rank: int) -> int:
    """The default group's rank of `group`'s rank `rank` (`broadcast`
    takes the former)."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None,
                    mean: bool = False) -> None:
    """Each tensor (all of one dtype) becomes its sum over the group's
    ranks (with `mean`, that sum divided by the group's size), in place:
    flat buckets, one SUM all-reduce each."""
    world = dist.get_world_size(group)
    for idx in buckets([t.numel() for t in tensors]):
        part = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in part])
        dist.all_reduce(flat, group=group)
        if mean:
            flat.div_(world)
        for t, piece in zip(part, flat.split([t.numel() for t in part])):
            t.copy_(piece.view_as(t))


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Each tensor (all of one dtype) becomes its mean over the group's
    ranks, in place: flat buckets, one SUM all-reduce each, then a
    division by the group's size."""
    all_reduce_sum_(tensors, group, mean=True)


def all_gather_slices_(tensors: Sequence[torch.Tensor],
                       cuts: Sequence[tuple[int, int]], rank: int,
                       group=None) -> None:
    """Every rank holds slice `rank` of each tensor up to date: tensor i
    is cut along dimension `cuts[i][0]` into slices of `cuts[i][1]`.
    Afterwards each holds every rank's slices. In flat buckets, each
    rank's slices packed and broadcast from that rank: a copy, no
    arithmetic. `rank` and the sources are ranks of `group`."""
    world = dist.get_world_size(group)
    for idx in buckets([t.numel() for t in tensors]):
        for src in range(world):
            views = [tensors[i].narrow(cuts[i][0], src * cuts[i][1],
                                       cuts[i][1]) for i in idx]
            if src == rank:
                flat = torch.cat([v.reshape(-1) for v in views])
            else:
                flat = torch.empty(sum(v.numel() for v in views),
                                   dtype=views[0].dtype,
                                   device=views[0].device)
            dist.broadcast(flat, src=global_rank(group, src), group=group)
            if src != rank:
                for v, piece in zip(views,
                                    flat.split([v.numel() for v in views])):
                    v.copy_(piece.view_as(v))
