"""Parameter partitioning (port of `icka_tpu.parallel.partitioning`): the
JAX package's rule-based PartitionSpecs as pure functions from parameter
names and shapes to tuples of axis names, one entry per dimension (None:
not split).

The rules are the JAX package's, applied to the flax path and layout of
each leaf: the port's names are the flax paths joined with "." and a
`weight` is the flax `kernel` transposed ((out, in) for (in, out), OIHW
for HWIO), so each spec is computed on the flax view and carried back to
the port's dimensions.

  - attention q/k/v and MLP `wi` kernels: output dimension over "model";
  - attention output and MLP `wo` kernels: input dimension over "model";
  - other kernels with an output width >= 1024 divisible by the axis:
    output dimension over "model";
  - `word_embeddings`: vocabulary dimension over "model";
  - everything else replicated.

`zero1_moment_specs` adds the data axis to each moment leaf's largest
remaining divisible dimension. Both give the JAX package's answer for every
mesh shape. `shard_params` and `shard_train_state` cut whole leaves to a
rank's slices by them (the model entries; ZeRO-1's data entries too), and
`moment_slices` gives ZeRO-1's data cuts, which hold on a model-local leaf
as on a whole one: the data axis never takes the model axis's dimension.
`icka_tpu_torch.parallel.tensor` runs the layers on those slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from icka_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS


def _flax_view(name: str, ndim: int) -> tuple[list, tuple]:
    """The flax path of a port parameter and the permutation `perm` with
    flax dimension j = port dimension perm[j]."""
    names = name.split(".")
    if names[-1] == "weight" and ndim in (2, 4):
        names[-1] = "kernel"
        return names, (1, 0) if ndim == 2 else (2, 3, 1, 0)
    return names, tuple(range(ndim))


def _tp_spec(names: list, shape: Sequence[int], model: int) -> list:
    """The JAX package's `_spec_for` on a flax path and shape, as a list of
    one entry per dimension."""
    spec = [None] * len(shape)
    if len(shape) < 2 or model <= 1:
        return spec
    last, joined = names[-1], "/".join(names)
    last_two = tuple(names[-2:])
    rows, cols = shape[-2], shape[-1]
    if last == "kernel":
        if any(f"attn/{proj}" in joined for proj in ("query", "key", "value")) \
                or last_two == ("wi", "kernel"):
            if cols % model == 0:
                spec[1] = MODEL_AXIS
                return spec
        if "attn_out/dense" in joined or last_two == ("wo", "kernel"):
            if rows % model == 0:
                spec[0] = MODEL_AXIS
                return spec
        if cols % model == 0 and cols >= 1024:
            spec[1] = MODEL_AXIS
        return spec
    if last == "word_embeddings" and rows % model == 0:
        spec[0] = MODEL_AXIS
    return spec


def _specs(shapes: Mapping[str, Sequence[int]], data: int,
           model: int) -> dict:
    out = {}
    for name, shape in shapes.items():
        names, perm = _flax_view(name, len(shape))
        flax_shape = [shape[p] for p in perm]
        spec = _tp_spec(names, flax_shape, model)
        if data > 1 and spec:
            free = [(flax_shape[i], i) for i in range(len(spec))
                    if spec[i] is None and flax_shape[i] % data == 0]
            if free:
                spec[max(free)[1]] = DATA_AXIS
        port = [None] * len(shape)
        for j, p in enumerate(perm):
            port[p] = spec[j]
        out[name] = tuple(port)
    return out


def param_partition_specs(shapes: Mapping[str, Sequence[int]],
                          model: int = 1) -> dict[str, tuple]:
    """{name: spec} of the parameters (`{name: shape}`) on a mesh whose
    model axis has `model` devices: the JAX package's tensor-parallel
    rules. Parameters stay replicated over the data axis."""
    return _specs(shapes, 1, model)


def zero1_moment_specs(shapes: Mapping[str, Sequence[int]], data: int = 1,
                       model: int = 1) -> dict[str, tuple]:
    """ZeRO-1 specs of the Adam moments: each leaf keeps its parameter's
    tensor-parallel spec and splits its largest remaining dimension that
    `data` divides over the data axis (ties go to the later flax
    dimension, as the JAX package's `max` picks). Leaves with no such
    dimension keep the parameter's spec."""
    return _specs(shapes, data, model)


def moment_slices(shapes: Mapping[str, Sequence[int]],
                  mesh) -> dict[str, tuple[int, int, int]]:
    """The moment leaves ZeRO-1 splits on `mesh`, from the parameters'
    whole shapes: {name: (dimension, this rank's first index on the data
    axis, slice length)}. The dimension is never one the model axis
    splits, so the cut holds on the rank's model slice of the leaf."""
    out = {}
    for name, spec in zero1_moment_specs(shapes, mesh.data,
                                         mesh.model).items():
        if DATA_AXIS in spec:
            dim = spec.index(DATA_AXIS)
            size = shapes[name][dim] // mesh.data
            out[name] = (dim, mesh.rank * size, size)
    return out


def cut(t, spec: Sequence, mesh):
    """This rank's slice (a view) of a whole leaf `t` under `spec`: along
    a "model" entry its index on the model axis, along a "data" entry its
    index on the data axis."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            size, index = ((mesh.model, mesh.model_rank) if axis == MODEL_AXIS
                           else (mesh.data, mesh.rank))
            n = t.shape[dim] // size
            t = t.narrow(dim, index * n, n)
    return t


def _cut_all(tensors: Mapping, specs: Mapping, mesh) -> dict:
    """Each split leaf as a contiguous copy of this rank's slice; the
    others as they are."""
    return {n: cut(t, specs[n], mesh).clone(
        memory_format=torch.contiguous_format) if any(specs[n]) else t
        for n, t in tensors.items()}


def shard_params(params: Mapping, mesh) -> dict:
    """Whole parameters ({name: tensor}) cut to this rank's model slices
    by `param_partition_specs` (replicated over the data axis)."""
    return _cut_all(params, param_partition_specs(
        {n: tuple(t.shape) for n, t in params.items()}, mesh.model), mesh)


def shard_train_state(state: Any, mesh, zero1: bool = False) -> Any:
    """A train state with whole moments (`mu`, `nu` by name, as
    `train.optimizer.AdamState`) cut as the parameters beside them: each
    leaf the model axis splits to this rank's model slice, and under
    `zero1` each leaf `zero1_moment_specs` splits over the data axis to
    its data slice of that; contiguous copies. Returns a new state (the
    state itself where nothing is cut)."""
    if not zero1 and mesh.model == 1:
        return state
    shapes = {n: tuple(t.shape) for n, t in state.mu.items()}
    specs = zero1_moment_specs(shapes, mesh.data if zero1 else 1, mesh.model)
    return dataclasses.replace(state, mu=_cut_all(state.mu, specs, mesh),
                               nu=_cut_all(state.nu, specs, mesh))
