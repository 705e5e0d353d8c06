"""The system under test: the port's served path for one configuration,
built from the benchmark's weights. Only this module and the timed loop
touch the program (`icka_tpu_torch`).

Served path of every call: `data.images.preprocess_images` (eval centre
crop) -> the int8-static `VisualBackbone` (calibrated by the program's
dynamic int8 mode on the benchmark's calibration images and quantised by
the program's `static_quantize_backbone`) -> the server that the
configuration names (`server.class`, a dotted import path), whose
protocol (`server.protocol`, `portbench/servers/<name>.py`) tells the
harness which device batch served each pair.
"""

from __future__ import annotations

import dataclasses
import importlib
import json

import torch

from icka_tpu_torch.core import config as port_config
from icka_tpu_torch.data.images import preprocess_images
from icka_tpu_torch.models.convert import (calibration_amax,
                                           static_quantize_backbone)
from icka_tpu_torch.models.gate_cl import GateCLModel
from icka_tpu_torch.models.icka import ICKAModel
from icka_tpu_torch.models.resnet import VisualBackbone

from portbench import weights

# a family is a model with its own weight layout and plain reference
FAMILIES = {"icka": (port_config.ICKAConfig, ICKAModel),
            "gate_cl": (port_config.GateCLConfig, GateCLModel)}


def model_config(cfg: dict):
    cls = FAMILIES[cfg["family"]][0]
    return port_config.from_json(cls, json.dumps(cfg["model"]))


def server_class(path: str):
    """The class at the dotted import path `path`."""
    module, _, name = path.rpartition(".")
    if not module:
        raise SystemExit(f"server class {path!r} is not a dotted path")
    return getattr(importlib.import_module(module), name)


class System:
    """The port's models and server for `cfg`, on `device`; `protocol` is
    the server's protocol module."""

    def __init__(self, cfg: dict, text_sd: dict, resnet_sd: dict,
                 calib_images, device, protocol):
        fam = cfg["family"]
        model_cls = FAMILIES[fam][1]
        dtype = getattr(torch, cfg["dtype"])
        vis = cfg["visual"]
        self.cfg, self.device, self.crop = cfg, device, vis["crop"]
        self.protocol = protocol
        mcfg = model_config(cfg)
        if dataclasses.asdict(mcfg) != _with_defaults(mcfg, cfg["model"]):
            raise SystemExit("the program's configuration dropped keys of "
                             "the configuration file")
        model = model_cls(mcfg, dtype=dtype, device=device).eval()
        weights.check_layout(weights.TEXT_TEMPLATES[fam](cfg["model"]),
                             model.state_dict(), cfg["name"])
        model.load_state_dict(text_sd, strict=True)
        self.model = model
        layers = tuple(vis["layers"])
        with torch.inference_mode():
            dyn = VisualBackbone(layers, dtype=dtype, quant="int8",
                                 device=device).eval()
            weights.check_layout(weights.resnet_template(layers),
                                 dyn.state_dict(), "ResNet")
            dyn.load_state_dict(resnet_sd, strict=True)
            dyn(preprocess_images(calib_images, self.crop, device=device))
        calib = calibration_amax(dyn)
        del dyn
        backbone = VisualBackbone(layers, dtype=dtype, quant=vis["quant"],
                                  fused_pallas=vis["fused_pallas"],
                                  device=device).eval()
        backbone.load_state_dict(static_quantize_backbone(
            backbone.state_dict().keys(), resnet_sd, calib), strict=True)
        self.backbone = backbone
        srv = {k: v for k, v in cfg["server"].items()
               if k not in ("class", "protocol")}
        if "mask_positions" in srv:
            srv["mask_positions"] = tuple(srv["mask_positions"])
        self.server = server_class(cfg["server"]["class"])(
            model, device=device, **srv)
        self.buckets = self.server.buckets
        self.emissions = []
        model.classifier.register_forward_hook(
            lambda mod, args, out: self.emissions.append(out))
        self.batches = []
        protocol.attach(self)

    def device_batches(self, stats) -> list:
        """[(rows, padded length)] of the device batches of the call that
        returned `stats`."""
        return self.protocol.device_batches(self.server, stats)

    def visual(self, images):
        """(fc, att) of a call's uint8 images."""
        with torch.inference_mode():
            _, fc, att = self.backbone(preprocess_images(
                images, self.crop, device=self.device))
        return fc, att

    def predict(self, examples):
        """(tags, stats); `emissions` and `batches` hold this call's
        device batches' emissions and what the protocol records."""
        self.emissions.clear()
        self.batches.clear()
        return self.server.predict(examples)


def _with_defaults(mcfg, model: dict) -> dict:
    """The configuration file's model section over the dataclass'
    defaults, as `asdict` gives it: a key the program ignores shows."""
    full = dataclasses.asdict(mcfg)

    def merge(base, over):
        out = dict(base)
        for k, v in over.items():
            out[k] = merge(base[k], v) if isinstance(v, dict) and \
                isinstance(base.get(k), dict) else v
        return out
    return merge(full, model)
