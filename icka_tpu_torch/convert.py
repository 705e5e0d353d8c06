"""Weight bridge: the JAX package's variables <-> this package's
state_dicts.

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

Every leaf becomes float32 except int8 leaves, which stay int8; shapes are
kept (0-d scales stay 0-d). So the quantised text trees go through the same
functions: a `Dense` in "int8" or "int8_static" holds `kernel_q` (in, out)
int8 and `kernel_scale` (and `act_scale`), an int8-static `BiLSTM`
`w_ih_q` (in, 8H), `w_ih_scale` and `act_scale`, all in the flax layout
(no transpose: only a float `kernel` is renamed). The int8-static backbone
tree (`wq` int8 (k*k*Cin, F) tap major, `w_scale`, `fused_bias`, 0-d
`act_scale` and `out_scale`, no `batch_stats`) goes through
`backbone_static_state_dict`; the port stores these leaves in the same
layout, as buffers.

The models' pairs (`icka_state_dict`, `gate_cl_state_dict`,
`token_classifier_state_dict` and their inverses, the VCR families'
functions and `vcr_variables_from_state_dict`) and the one-way
`chunk_tagger_state_dict`, `caption_state_dict` and
`gpt2_decoder_state_dict` differ only in the model they name: each
model's parameters are one flax collection, "params".
The inverse (`flax_tree_from_state_dict`, `icka_variables_from_state_dict`,
`backbone_variables_from_state_dict`, ...) turns a state_dict back into the
flax trees, `weight` back into `kernel` in (in, out) or HWIO and int8 kept,
so the port can write the JAX package's checkpoints where flax is not
installed.
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


def _leaf_dtype(value) -> np.dtype:
    """int8 stays int8; every other leaf is float32."""
    return np.int8 if value.dtype == np.int8 else np.float32


def _torch_entry(key: str, value: np.ndarray):
    # the transposes run in torch: a strided numpy copy of the flagship's
    # kernels takes tens of seconds on one core
    out = torch.from_numpy(np.array(value, _leaf_dtype(value)))
    if key == "kernel" or key.endswith(".kernel"):
        key = key[:-len("kernel")] + "weight"
        if value.ndim == 2:
            out = out.t().contiguous()
        elif value.ndim == 4:
            out = out.permute(3, 2, 0, 1).contiguous()
        else:
            raise ValueError(f"kernel {key} of rank {value.ndim}")
    return key, out


def state_dict_from_flax(tree: Mapping) -> dict:
    """A flax parameter tree (one collection) -> a torch state_dict."""
    return dict(_torch_entry(k, v) for k, v in _flatten(tree).items())


def icka_state_dict(variables: Mapping) -> dict:
    """`ICKAModel` variables {"params": ...} -> `ICKAModel` state_dict, in
    every quant mode (the int8 leaves stay int8).
    `ICKAModel.forward_packed` uses the parameters of `emissions`, so the
    packed path needs no further leaf."""
    return state_dict_from_flax(variables["params"])


def gate_cl_state_dict(variables: Mapping) -> dict:
    """`GateCLModel` variables {"params": ...} -> `GateCLModel` state_dict,
    every variant. `crs_classifier`'s kernel ((max_seq_length * 2H, 2)) is
    transposed like any Dense: its rows keep the flatten order of the
    (L, 2H) input on both sides. `forward_packed` needs no further leaf."""
    return state_dict_from_flax(variables["params"])


def token_classifier_state_dict(variables: Mapping) -> dict:
    """`TokenClassifier` or `SequenceClassifier` variables {"params": ...}
    -> its state_dict."""
    return state_dict_from_flax(variables["params"])


def chunk_tagger_state_dict(variables: Mapping) -> dict:
    """`ChunkTagger` variables {"params": ...} (the JAX module's, or
    {"params": chunker_params_from_torch(...)}) -> its state_dict: the
    encoder under `bert` with each layer's `ffn.adapter_down` and
    `ffn.adapter_up`, the tagging `head`."""
    return state_dict_from_flax(variables["params"])


def caption_state_dict(variables: Mapping) -> dict:
    """`CaptionModel` variables {"params": ...} -> its state_dict, tied or
    untied (`lm_decoder`); `lm_bias` passes through."""
    return state_dict_from_flax(variables["params"])


def gpt2_decoder_state_dict(variables: Mapping) -> dict:
    """`GPT2Decoder` variables {"params": ...} -> its state_dict: the
    tables `wte` and `wpe` pass through, `c_attn`'s (D, 3D) kernel becomes
    a (3D, D) weight like any Dense."""
    return state_dict_from_flax(variables["params"])


def chunkalign_state_dict(variables: Mapping) -> dict:
    """`ChunkAlignCLS` or `ChunkAlignRationale` variables {"params": ...}
    -> its state_dict, in either variant (no `seq_enc`/`cls_ensemble`
    without chunk alignment, no `cls_layer_*` without reasoning); the
    rationale's bias-free `lm_head` has a `weight` only."""
    return state_dict_from_flax(variables["params"])


def chunkalign_baseline_state_dict(variables: Mapping) -> dict:
    """`BaselineCLS`, `BaselineRationale` or `EnsembleRefiner` variables
    {"params": ...} -> its state_dict (`LyxClsLayer`'s `q_proj`, `k_proj`,
    `v_proj` and `out_proj` as Dense)."""
    return state_dict_from_flax(variables["params"])


def oscar_state_dict(variables: Mapping) -> dict:
    """`ImageBertSequenceClassifier`, `OscarMultipleChoice` or
    `ImageBertPreTraining` variables {"params": ...} -> its state_dict.
    The pretraining head's tied decoder is the encoder's
    `encoder.embeddings.word_embeddings`, one entry, beside its own
    `decoder_bias`."""
    return state_dict_from_flax(variables["params"])


def gpt2_captioner_state_dict(variables: Mapping) -> dict:
    """`GPT2Captioner` variables {"params": ...} -> its state_dict:
    `encoder` (a `GlobalVLEncoder`), `decoder`, `cls_head` if any."""
    return state_dict_from_flax(variables["params"])


def ensemble_gate_state_dict(variables: Mapping) -> dict:
    """`AbstractSpecificGate` variables {"params": ...} -> its state_dict."""
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
    return {k: torch.from_numpy(np.array(v, _leaf_dtype(v)))
            for k, v in _flatten(variables["params"]).items()}


def calib_from_flax(calib: Mapping) -> dict:
    """The JAX package's "calib" collection ({... {"amax": x}}) -> the
    port's calibration record {module path: x}: a `ConvBN`'s path, a text
    `Dense`'s (`embedding.encoder.layer_0.attn.query`, ...) or the
    BiLSTM's (`lstm`)."""
    return {k[:-len(".amax")]: np.float32(v)
            for k, v in _flatten(calib).items() if k.endswith(".amax")}


def _flax_entry(key: str, value) -> tuple[str, np.ndarray]:
    # a weight is transposed in torch, where it lies (on the card, before
    # it moves to the host), as `_torch_entry` does
    value = (value.detach() if isinstance(value, torch.Tensor)
             else torch.from_numpy(np.array(value)))
    if key == "weight" or key.endswith(".weight"):
        key = key[:-len("weight")] + "kernel"
        if value.ndim == 2:
            value = value.t().contiguous()
        elif value.ndim == 4:
            value = value.permute(2, 3, 1, 0).contiguous()
        else:
            raise ValueError(f"weight {key} of rank {value.ndim}")
    value = value.cpu()
    if value.dtype != torch.int8:
        value = value.float()
    return key, np.asarray(value.numpy(), order="C")


def flax_tree_from_state_dict(sd: Mapping) -> dict:
    """A state_dict -> one flax collection (nested dicts of float32 numpy
    arrays, int8 kept): the inverse of `state_dict_from_flax`."""
    tree: dict = {}
    for name, value in sd.items():
        key, value = _flax_entry(name, value)
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def icka_variables_from_state_dict(sd: Mapping) -> dict:
    """`ICKAModel` state_dict -> {"params": ...}, in every quant mode: the
    inverse of `icka_state_dict`."""
    return {"params": flax_tree_from_state_dict(sd)}


def gate_cl_variables_from_state_dict(sd: Mapping) -> dict:
    """`GateCLModel` state_dict -> {"params": ...}: the inverse of
    `gate_cl_state_dict`."""
    return {"params": flax_tree_from_state_dict(sd)}


def token_classifier_variables_from_state_dict(sd: Mapping) -> dict:
    """`TokenClassifier` or `SequenceClassifier` state_dict -> {"params":
    ...}: the inverse of `token_classifier_state_dict`."""
    return {"params": flax_tree_from_state_dict(sd)}


def vcr_variables_from_state_dict(sd: Mapping) -> dict:
    """The state_dict of any VCR-plane model (`ChunkAlignCLS`,
    `ChunkAlignRationale`, the baselines, `EnsembleRefiner`, the Oscar
    heads, `GPT2Captioner`, `AbstractSpecificGate`) -> {"params": ...}: the
    inverse of their `*_state_dict` functions."""
    return {"params": flax_tree_from_state_dict(sd)}


def backbone_variables_from_state_dict(sd: Mapping) -> dict:
    """Float `VisualBackbone` state_dict -> {"params", "batch_stats"}, the
    inverse of `backbone_state_dict`: BatchNorm running `mean`/`var` go to
    batch_stats."""
    stats = {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] in
             ("mean", "var")}
    return {"params": flax_tree_from_state_dict(
                {k: v for k, v in sd.items() if k not in stats}),
            "batch_stats": flax_tree_from_state_dict(stats)}
