"""Weight bridge: the JAX package's variables -> this package's state_dicts.

Input is what `jax.device_get(variables)` yields: nested dicts of numpy
arrays (flax FrozenDicts work too). This package names its submodules and
parameters with the flax names, so a flax path joined with "." is a
`state_dict` key, with two renames:

  - `.../kernel` (2-D, flax Dense, (in, out)) -> `.../weight`, transposed
    to torch's (out, in);
  - `.../kernel` (4-D, conv HWIO) -> `.../weight`, OIHW.

LayerNorm `scale`/`bias`, embedding tables, BiLSTM `w_ih_*`/`w_hh_*` (torch
layout already) and CRF transitions pass through unchanged. Load the result
with `load_state_dict(..., strict=True)`: a missing or extra name fails.

The int8-static backbone tree (`wq` int8 (k*k*Cin, F) tap major, `w_scale`,
`fused_bias`, 0-d `act_scale` and `out_scale`, no `batch_stats`) goes
through `backbone_static_state_dict`, which keeps int8 as int8; the port
stores these leaves in the same layout, as buffers.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _torch_entry(key: str, value: np.ndarray):
    if key == "kernel" or key.endswith(".kernel"):
        key = key[:-len("kernel")] + "weight"
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel {key} of rank {value.ndim}")
    return key, torch.from_numpy(np.array(value, np.float32))


def state_dict_from_flax(tree: Mapping) -> dict:
    """A flax parameter tree (one collection) -> a torch state_dict."""
    return dict(_torch_entry(k, v) for k, v in _flatten(tree).items())


def icka_state_dict(variables: Mapping) -> dict:
    """`ICKAModel` variables {"params": ...} -> `ICKAModel` state_dict.
    `ICKAModel.forward_packed` uses the parameters of `emissions`, so the
    packed path needs no further leaf."""
    return state_dict_from_flax(variables["params"])


def backbone_state_dict(variables: Mapping) -> dict:
    """`VisualBackbone` variables {"params", "batch_stats"} ->
    `VisualBackbone` state_dict (BN running mean/var become buffers)."""
    sd = state_dict_from_flax(variables["params"])
    sd.update(state_dict_from_flax(variables["batch_stats"]))
    return sd


def backbone_static_state_dict(variables: Mapping) -> dict:
    """`VisualBackbone(quant="int8_static")` variables {"params"} -> the
    static `VisualBackbone` state_dict: int8 weights stay int8, every other
    leaf is float32, shapes unchanged (0-d scales stay 0-d)."""
    if variables.get("batch_stats"):
        raise ValueError("the int8-static backbone has no batch_stats: they "
                         "are folded into wq and fused_bias")
    return {k: torch.from_numpy(np.array(
        v, np.int8 if v.dtype == np.int8 else np.float32))
        for k, v in _flatten(variables["params"]).items()}


def calib_from_flax(calib: Mapping) -> dict:
    """The JAX package's "calib" collection ({... {"amax": x}}) -> the
    port's calibration record {ConvBN path: x}."""
    return {k[:-len(".amax")]: np.float32(v)
            for k, v in _flatten(calib).items() if k.endswith(".amax")}
