"""Calibration and offline quantisation (port of the quantisers of
`icka_tpu.models.convert`), as numpy on state_dicts.

The flow is the JAX package's: run the `quant="int8"` (dynamic) model over
calibration batches, read the largest |x| each quantised module saw
(`calibration_amax`), then turn the float state_dict into the
`quant="int8_static"` one and load it with `strict=True`. The visual
backbone goes through `static_quantize_backbone`; the text half (`Dense`
and `BiLSTM` in `ICKAModel` and its encoders) through
`quantize_params_like` (the dynamic model's weights) and
`static_quantize_params_like`.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch


def _np32(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, np.float32)


def _quantize_cols(w: np.ndarray):
    """Per-output-column abs-max symmetric int8 quantisation of a 2-D
    (in, out) weight matrix. Returns (int8 weights, fp32 per-column scale)."""
    w = np.asarray(w, np.float32)
    scale = np.maximum(np.abs(w).max(axis=0), 1e-8) / 127.0
    wq = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return wq, scale.astype(np.float32)


def calibration_amax(module: torch.nn.Module) -> dict:
    """{module path: max |x|} of every module of a `quant="int8"` model that
    records one (`ConvBN`, `Dense`, `BiLSTM`), over all calls since
    construction."""
    return {name: np.float32(m.calib_amax.item())
            for name, m in module.named_modules()
            if "calib_amax" in m._buffers}


def merge_calib(*calibs: Mapping) -> dict:
    """Elementwise-max merge of calibration records taken separately (one
    model run over several batches merges by itself)."""
    out = dict(calibs[0])
    for c in calibs[1:]:
        for k, v in c.items():
            out[k] = np.maximum(out[k], v) if k in out else v
    return out


def static_quantize_backbone(target_keys: Iterable[str], fp32_state: Mapping,
                             calib: Mapping) -> dict:
    """Float `VisualBackbone` state_dict -> static int8 serving state_dict.

    `target_keys` are the state_dict keys of the model built with
    `quant="int8_static"` (they say which blocks carry an `out_scale`);
    `fp32_state` is the float model's state_dict (parameters and BatchNorm
    statistics); `calib` is `calibration_amax` of the dynamic model, keyed
    by `ConvBN` path. Each ConvBN's frozen statistics are folded into its
    conv weights, the folded (k*k*Cin, Cout) matrix is quantised per output
    channel, and `act_scale = max(amax, 1e-8) / 127`. `out_scale` of a
    fused block is the conv1 `act_scale` of the block after it."""
    target_keys = list(target_keys)
    out = {}
    for key in target_keys:
        if not key.endswith(".wq"):
            continue
        path = key[:-len(".wq")]
        kernel = _np32(fp32_state[f"{path}.conv.weight"]) \
            .transpose(2, 3, 1, 0)                                  # HWIO
        inv = (_np32(fp32_state[f"{path}.scale"])
               / np.sqrt(_np32(fp32_state[f"{path}.var"]) + 1e-5))
        folded = kernel * inv[None, None, None, :]
        wq, w_scale = _quantize_cols(folded.reshape(-1, kernel.shape[-1]))
        if path not in calib:
            raise ValueError(f"missing calibration amax for {path}")
        amax = float(np.asarray(calib[path]))
        out[f"{path}.wq"] = wq
        out[f"{path}.w_scale"] = w_scale
        out[f"{path}.fused_bias"] = (
            _np32(fp32_state[f"{path}.bias"])
            - _np32(fp32_state[f"{path}.mean"]) * inv)
        out[f"{path}.act_scale"] = np.float32(max(amax, 1e-8) / 127.0)
    for key in target_keys:
        if not key.endswith(".out_scale"):
            continue
        stage, b = key[:-len(".out_scale")].rsplit("_", 1)
        nxt = f"{stage}_{int(b) + 1}.conv1.act_scale"
        if nxt not in out:
            raise ValueError(f"fused block {stage}_{b} has out_scale but no "
                             f"successor block")
        out[key] = np.float32(out[nxt])
    missing = sorted(set(target_keys) - set(out))
    if missing:
        raise ValueError(f"no rule for target keys {missing}")
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


def _dense_kernel(fp32_state: Mapping, path: str) -> np.ndarray:
    """The flax (in, out) kernel of the float `Dense` at `path`."""
    return _np32(fp32_state[f"{path}.weight"]).T


def _text_quantize(target_keys: Iterable[str], fp32_state: Mapping,
                   calib: Mapping | None) -> dict:
    target_keys = list(target_keys)
    out = {}
    for key in target_keys:
        path, _, leaf = key.rpartition(".")
        if leaf == "kernel_q":
            out[key], out[f"{path}.kernel_scale"] = _quantize_cols(
                _dense_kernel(fp32_state, path))
        elif leaf == "w_ih_q":
            w = np.concatenate([_np32(fp32_state[f"{path}.w_ih_fwd"]).T,
                                _np32(fp32_state[f"{path}.w_ih_bwd"]).T],
                               axis=1)
            out[key], out[f"{path}.w_ih_scale"] = _quantize_cols(w)
        elif leaf in ("kernel_scale", "w_ih_scale"):
            continue              # produced together with the int8 weights
        elif leaf == "act_scale":
            if calib is None or path not in calib:
                raise ValueError(
                    f"static quantisation needs a calibration amax for "
                    f"{path}: run the quant='int8' model over calibration "
                    f"batches and pass calibration_amax(model)")
            amax = float(np.asarray(calib[path]))
            out[key] = np.float32(max(amax, 1e-8) / 127.0)
        elif key in fp32_state:
            out[key] = _np32(fp32_state[key])
        else:
            raise ValueError(f"no rule for target key {key}")
    missing = sorted(set(target_keys) - set(out))
    if missing:
        raise ValueError(f"no rule for target keys {missing}")
    return {k: torch.from_numpy(np.asarray(out[k])) for k in target_keys}


def quantize_params_like(target_keys: Iterable[str],
                         fp32_state: Mapping) -> dict:
    """Float text-model state_dict -> the `quant="int8"` (dynamic)
    state_dict, as the JAX package's `quantize_params_like`.

    `target_keys` are the state_dict keys of the model built with
    `quant="int8"`: wherever it holds `<path>.kernel_q`, the float
    `<path>.weight` (torch's (out, in); the flax kernel is its transpose)
    is quantised per output channel (abs-max / 127) into `kernel_q` (in,
    out) int8 and `kernel_scale`. Every other key is copied as float32
    (the dynamic `BiLSTM` keeps its float `w_ih_*`)."""
    return _text_quantize(target_keys, fp32_state, None)


def static_quantize_params_like(target_keys: Iterable[str],
                                fp32_state: Mapping,
                                calib: Mapping) -> dict:
    """Float text-model state_dict -> the `quant="int8_static"` serving
    state_dict, as the JAX package's `static_quantize_params_like`.

    As `quantize_params_like`, and besides: a `BiLSTM` gets `w_ih_q` (in,
    8H) int8 and `w_ih_scale`, the concatenated forward and backward input
    weights quantised per column; every `act_scale` is
    max(amax, 1e-8) / 127 of the module's entry in `calib`
    (`calibration_amax` of the dynamic model, or `calib_from_flax` of the
    JAX package's "calib" collection). A missing entry raises."""
    return _text_quantize(target_keys, fp32_state, calib)
