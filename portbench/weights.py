"""Seeded weights of a configuration, made by the benchmark on the device.

The layout (every key and shape) is worked out here from the
configuration's widths, and the program's own state dict must have
exactly that layout: a program that built other widths fails its set-up.
Values are drawn in a few large calls of one generator per part: standard
normals for the text and the convolutions, uniforms for the BiLSTM and the
CRF, each key's slice scaled by its rule:

  - dense weights, embeddings and biases: normal, std 0.02 (BERT's init);
  - LayerNorm scales 1 + 0.05 normal, LayerNorm biases 0.05 normal;
  - BiLSTM: uniform(-1/sqrt(H), 1/sqrt(H)) (torch's LSTM init);
  - CRF transitions: uniform(-0.1, 0.1) (torchcrf's init);
  - convolutions: normal, std sqrt(2 / fan_out); BatchNorm scale 1, bias
    0, and its statistics calibrated on seeded images (a random network's
    residual sums otherwise grow to about 1e7 over ResNet-152's blocks).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import visual as ref_visual


def _linear(key, n_out, n_in):
    return [(f"{key}.weight", (n_out, n_in)), (f"{key}.bias", (n_out,))]


def _norm(key, n):
    return [(f"{key}.scale", (n,)), (f"{key}.bias", (n,))]


def _layer(key, E):
    H, I = E["hidden_size"], E["intermediate_size"]
    out = []
    for n in ("query", "key", "value"):
        out += _linear(f"{key}.attn.{n}", H, H)
    out += _linear(f"{key}.attn_out.dense", H, H) + _norm(
        f"{key}.attn_out.norm", H)
    out += _linear(f"{key}.ffn.wi", I, H) + _linear(f"{key}.ffn.wo", H, I)
    return out + _norm(f"{key}.ffn.norm", H)


def _encoder(key, E, pooler=False):
    H = E["hidden_size"]
    out = [(f"{key}.embeddings.word_embeddings", (E["vocab_size"], H)),
           (f"{key}.embeddings.position_embeddings",
            (E["max_position_embeddings"], H)),
           (f"{key}.embeddings.token_type_embeddings",
            (E["type_vocab_size"], H))]
    out += _norm(f"{key}.embeddings.norm", H)
    for i in range(E["num_hidden_layers"]):
        out += _layer(f"{key}.encoder.layer_{i}", E)
    if pooler:
        out += _linear(f"{key}.pooler.dense", H, H)
    return out


def _stack(key, E, n):
    return [kv for i in range(n) for kv in _layer(f"{key}.layer_{i}", E)]


def _crf(T):
    return [("crf.start_transitions", (T,)), ("crf.end_transitions", (T,)),
            ("crf.transitions", (T, T))]


def icka_template(m: dict) -> dict:
    """{key: shape} of the flagship at the configuration's widths."""
    E, Ll = m["embedding"], m["last_encoder"]
    H, T, R = E["hidden_size"], m["num_labels"], m["region_dim"]
    W, P, Hl = m["prompt_hidden"], m["prompt_len"], m["last_hidden"]
    out = _encoder("embedding", E)
    out += _linear("vismapping", H, m["clip_dim"])
    out += _linear("vismap2text", H, R)
    for name in ("txt2img", "align_0", "align_1"):
        out += _stack(name, E, m["layer_num1"])
    for name, n_in in (("map_alignment", H), ("map_vision", R)):
        out += _linear(f"{name}.wi", W * P, n_in)
        out += _linear(f"{name}.wo", H * P, W * P)
    if H != Hl:
        out += _linear("lastproj", Hl, H)
    out += _encoder("last_encoder", Ll)
    out += _norm("gate.norm", H) + _linear("gate.proj", H, H)
    out += _linear("gate.aux_head", 1, H)
    for d in ("fwd", "bwd"):
        out += [(f"lstm.w_hh_{d}", (4 * Hl, Hl)), (f"lstm.b_ih_{d}", (4 * Hl,)),
                (f"lstm.b_hh_{d}", (4 * Hl,)), (f"lstm.w_ih_{d}", (4 * Hl, Hl))]
    out += _linear("classifier", T, 2 * Hl) + _crf(T)
    return dict(out)


def gate_cl_template(m: dict) -> dict:
    """{key: shape} of the "gate_cl" variant at the configuration's
    widths."""
    E = m["encoder"]
    H, T, R = E["hidden_size"], m["num_labels"], m["region_dim"]
    out = _encoder("bert", E, pooler=True)
    out += _linear("vismap2text", H, R) + _stack("txt2img", E, m["layer_num1"])
    out += _linear("classifier", T, 2 * H) + _crf(T)
    out += _linear("crs_classifier", 2, m["max_seq_length"] * 2 * H)
    for name in ("gate_text", "gate_image", "text_dense_cl",
                 "text_output_cl", "image_output_cl"):
        out += _linear(name, H, H)
    out += _linear("image_dense_cl", H, R)
    return dict(out)


TEXT_TEMPLATES = {"icka": icka_template, "gate_cl": gate_cl_template}


def resnet_template(layers) -> dict:
    out = []
    for path, k, _ in ref_visual.conv_paths(layers):
        name = path.split(".")[1]
        if path == "resnet.stem":
            c_in, f = 3, 64
        else:
            stage = int(name[5]) - 1
            width = 64 * 2 ** stage
            block = int(name.split("_")[1])
            first_in = (64 if stage == 0 else 128 * 2 ** stage)
            block_in = first_in if block == 0 else 4 * width
            conv = path.split(".")[-1]
            c_in, f = {"conv1": (block_in, width), "conv2": (width, width),
                       "conv3": (width, 4 * width),
                       "downsample": (block_in, 4 * width)}[conv]
        out += [(f"{path}.conv.weight", (f, c_in, k, k)),
                (f"{path}.scale", (f,)), (f"{path}.bias", (f,)),
                (f"{path}.mean", (f,)), (f"{path}.var", (f,))]
    return dict(out)


def check_layout(template: dict, state_dict, what: str) -> None:
    """Raise unless the program's state dict has exactly the template's
    keys and shapes."""
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    want = {k: tuple(s) for k, s in template.items()}
    if got != want:
        missing = sorted(set(want) - set(got))[:5]
        extra = sorted(set(got) - set(want))[:5]
        wrong = sorted(k for k in set(got) & set(want)
                       if got[k] != want[k])[:5]
        raise SystemExit(f"{what}: the program's layout differs from the "
                         f"configuration's: missing {missing}, extra "
                         f"{extra}, other shapes {wrong}")


def _rule(key, shape):
    """(distribution, scale, shift) of one key."""
    if key.startswith("lstm."):
        return "uniform", 1.0 / math.sqrt(shape[0] // 4), 0.0
    if key.startswith("crf."):
        return "uniform", 0.1, 0.0
    if key.endswith("norm.scale"):
        return "normal", 0.05, 1.0
    if key.endswith("norm.bias"):
        return "normal", 0.05, 0.0
    return "normal", 0.02, 0.0


def _generate(template, rule, gen, device):
    keys = sorted(template)
    plan = {k: rule(k, template[k]) for k in keys}
    sizes = {k: math.prod(template[k]) for k in keys}
    out = {}
    for kind in ("normal", "uniform"):
        ks = [k for k in keys if plan[k][0] == kind]
        if not ks:
            continue
        total = sum(sizes[k] for k in ks)
        if kind == "normal":
            flat = torch.randn(total, generator=gen, device=device)
        else:
            flat = torch.rand(total, generator=gen, device=device) * 2 - 1
        at = 0
        for k in ks:
            _, scale, shift = plan[k]
            out[k] = flat[at:at + sizes[k]].view(template[k]) * scale + shift
            at += sizes[k]
        del flat
    return out


def sub_seed(seed: int, part: str) -> int:
    """A generator seed for one part of a run, from the run's seed."""
    h = 1469598103934665603
    for ch in f"{seed}:{part}":
        h = ((h ^ ord(ch)) * 1099511628211) % 2 ** 64
    return h % 2 ** 63


def text_weights(family: str, model: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "text"))
    return _generate(TEXT_TEMPLATES[family](model), _rule, gen, device)


def _resnet_rule(key, shape):
    return "normal", math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])), 0.0


def resnet_weights(layers, seed: int, calib_pixels, device) -> dict:
    """The float ResNet state dict, BatchNorm statistics calibrated on
    `calib_pixels` (NCHW fp32): each convolution's mean and variance of
    its raw output, in forward order."""
    template = resnet_template(layers)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "resnet"))
    sd = _generate({k: s for k, s in template.items()
                    if k.endswith("conv.weight")}, _resnet_rule, gen, device)
    for k, s in template.items():
        if not k.endswith("conv.weight"):
            fill = 1.0 if k.endswith((".scale", ".var")) else 0.0
            sd[k] = torch.full(s, fill, device=device)
    with torch.no_grad():
        ref_visual.float_forward(sd, calib_pixels, layers, calibrate=True)
    return sd


def calibration_images(seed: int, n: int, size: int, device):
    """Seeded uint8 (n, size, size, 3) images, none of them served."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "calib"))
    return torch.randint(0, 256, (n, size, size, 3), generator=gen,
                         device=device, dtype=torch.uint8)


def checksum(sd: dict) -> float:
    """A cheap fingerprint of a state dict's values."""
    return float(sum(v.double().sum() for v in sd.values()))
