"""Checkpoint conversion CLI (port of `icka_tpu.cli.convert`): PyTorch and
TF checkpoints -> msgpack param files, the files the JAX package's CLI
writes for the same source (this package's own msgpack writer; no flax).

    # HF RoBERTa/BERT directory (pytorch_model.bin + config.json)
    python -m icka_tpu_torch.cli.convert roberta --src encoder/roberta_large \
        --dst params/last_encoder.msgpack

    # torchvision ResNet-152 state dict
    python -m icka_tpu_torch.cli.convert resnet --src resnet152.pth \
        --dst params/resnet.msgpack

    # a reference best-checkpoint bundle (model.pth with {'net': ...}):
    # its BiLSTM and CRF as lstm.msgpack and crf.msgpack
    python -m icka_tpu_torch.cli.convert icka --src out/model.pth \
        --dst params/

    # a TF-1.x BERT checkpoint (model.ckpt.index + .data shards), read
    # without tensorflow
    python -m icka_tpu_torch.cli.convert tf_bert --src bert/model.ckpt \
        --dst params/encoder.msgpack

The outputs are flax-layout trees: `restore_pytree` reads them back and
`icka_tpu_torch.convert` (`state_dict_from_flax`, `backbone_state_dict`)
loads them into the port's modules. A host tool: it takes no device.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from icka_tpu_torch.core.checkpoint import save_pytree
from icka_tpu_torch.models.convert import (crf_params_from_torch,
                                           encoder_params_from_torch,
                                           lstm_params_from_torch)
from icka_tpu_torch.models.pretrained import tf_encoder_layers
from icka_tpu_torch.models.resnet import resnet_params_from_torch
from icka_tpu_torch.models.tf_convert import (encoder_params_from_tf,
                                              read_tf_checkpoint)


def _load_torch(path: str):
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "net" in obj:
        obj = obj["net"]
    return obj


def convert_roberta(src: str, dst: str):
    bin_path = os.path.join(src, "pytorch_model.bin") \
        if os.path.isdir(src) else src
    sd = _load_torch(bin_path)
    cfg_path = os.path.join(src, "config.json") if os.path.isdir(src) \
        else None
    layers = None
    if cfg_path and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            layers = json.load(f).get("num_hidden_layers")
    if layers is None:
        layers = 1 + max(int(k.split(".")[2])
                         for k in sd if k.startswith("encoder.layer."))
    prefix = ""
    if any(k.startswith("roberta.") for k in sd):
        prefix = "roberta."
    elif any(k.startswith("bert.") for k in sd):
        prefix = "bert."
    params = encoder_params_from_torch(sd, layers, prefix=prefix)
    save_pytree(dst, params)
    print(f"wrote {dst} ({layers} layers)")


def convert_resnet(src: str, dst: str):
    sd = _load_torch(src)
    variables = resnet_params_from_torch(sd)
    save_pytree(dst, variables)
    print(f"wrote {dst}")


def convert_lstm_crf(src: str, dst_dir: str):
    """Pull the BiLSTM + CRF weights out of a reference model bundle."""
    sd = _load_torch(src)
    os.makedirs(dst_dir, exist_ok=True)
    lstm_sd = {k[len("lstm."):]: v for k, v in sd.items()
               if k.startswith("lstm.")}
    crf_sd = {k[len("crf."):]: v for k, v in sd.items()
              if k.startswith("crf.")}
    if lstm_sd:
        save_pytree(os.path.join(dst_dir, "lstm.msgpack"),
                    lstm_params_from_torch(lstm_sd))
    if crf_sd:
        save_pytree(os.path.join(dst_dir, "crf.msgpack"),
                    crf_params_from_torch(crf_sd))
    print(f"wrote {dst_dir} (lstm={bool(lstm_sd)} crf={bool(crf_sd)})")


def convert_tf_bert(src: str, dst: str):
    """TF-1.x BERT checkpoint prefix -> TextEncoder msgpack params."""
    if src.endswith(".index"):
        src = src[:-len(".index")]
    tfvars = read_tf_checkpoint(src)
    layers = tf_encoder_layers(tfvars)
    params = encoder_params_from_tf(tfvars, layers)
    save_pytree(dst, params)
    print(f"wrote {dst} ({layers} layers, {len(tfvars)} TF variables)")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("kind",
                   choices=["roberta", "bert", "resnet", "icka", "tf_bert"])
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    args = p.parse_args(argv)
    if args.kind in ("roberta", "bert"):
        convert_roberta(args.src, args.dst)
    elif args.kind == "resnet":
        convert_resnet(args.src, args.dst)
    elif args.kind == "tf_bert":
        convert_tf_bert(args.src, args.dst)
    else:
        convert_lstm_crf(args.src, args.dst)


if __name__ == "__main__":
    main()
