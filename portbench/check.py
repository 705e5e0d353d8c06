"""How `correct` is decided: the served outputs of a sample of the window's
pairs against the plain reference (`portbench/reference/`), which works
everything out again from the benchmark's float weights, calibration
images and inputs.

During the window, after each call (outside its latency), the sampler
keeps `PER_CALL` pairs drawn from the seed and the call's longest pair:
their token ids, image, CLIP features, the program's pooled and grid
features, the emissions of their rows of the device batches the server
ran, and their tags. After the window the sample is `pairs` of those
(config `check.pairs`), drawn from the seed, and the longest of all.

Numbers compared (each against its limit in `portbench/limits/<cell>.json`):
  - visual_err: relative rms distance of the program's pooled and grid
    features from the reference's int8-static backbone (the larger);
  - emis_err: relative rms distance of the program's emissions from the
    float32 reference's, over the sample's valid tokens;
  - tag_gap: the widest gap, over the sample, by which the reference's
    score of the served tag path lies below its Viterbi best.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights
from portbench.reference import text as ref_text
from portbench.reference import visual as ref_visual

PER_CALL = 4
# the control: the reference one precision below the configuration's
# (int4 for the int8 backbone, fp8 e4m3 for the bf16 text)
CONTROL_QMAX = 7
CONTROL_PRECISION = "fp8"


class Sampler:
    def __init__(self, seed: int):
        self.seed = seed
        self.kept = []          # (is_longest, record)

    def take(self, k: int, call: dict, sentences, system, fc, att,
             tags) -> None:
        n = len(sentences)
        rng = np.random.default_rng(weights.sub_seed(self.seed, f"pick{k}"))
        lengths = call["lengths"]
        longest = int(np.argmax(lengths))
        picks = [(False, int(i)) for i in
                 rng.choice(n, min(PER_CALL, n), replace=False)]
        rows = system.protocol.served_rows(system)
        for is_longest, i in picks + [(True, longest)]:
            emissions, b = rows[i]
            L = min(int(lengths[i]), b)
            self.kept.append((is_longest, {
                "ids": sentences[i], "bucket": b, "length": L,
                "image": call["images"][i].clone(),
                "clip": None if call["clip"] is None
                else call["clip"][i].clone(),
                "fc": fc[i].clone(), "att": att[i].clone(),
                "emissions": emissions[:L].clone(),
                "tags": np.asarray(tags[i]).copy()}))

    def sample(self, pairs: int) -> list:
        """`pairs` - 1 kept pairs drawn from the seed and the longest."""
        rand = [rec for is_long, rec in self.kept if not is_long]
        longs = [rec for is_long, rec in self.kept if is_long]
        rng = np.random.default_rng(weights.sub_seed(self.seed, "sample"))
        take = rng.choice(len(rand), min(pairs - 1, len(rand)),
                          replace=False) if rand else []
        out = [rand[int(i)] for i in take]
        if longs:
            out.append(max(longs, key=lambda r: r["length"]))
        return [{k: (v.cpu() if torch.is_tensor(v) else v)
                 for k, v in rec.items()} for rec in out]


def rel_rms(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


class Reference:
    """The reference's outputs for a sample, and the numbers of any
    candidate's outputs against them."""

    def __init__(self, cfg: dict, head, text_sd, resnet_sd, calib_images,
                 device, protocol, qmax: int = 127,
                 precision: str = "fp32"):
        ref_text.fp32_strict()
        self.cfg, self.head, self.protocol = cfg, head, protocol
        self.device, self.qmax = device, qmax
        self.prec = ref_text.Precision(precision)
        self.text_sd = text_sd
        vis = cfg["visual"]
        self.layers = tuple(vis["layers"])
        pixels = ref_visual.preprocess(calib_images.to(device), vis["crop"])
        calib = ref_visual.dynamic_calibration(
            {k: v.to(device) for k, v in resnet_sd.items()}, pixels,
            self.layers, qmax)
        self.state = ref_visual.static_state(resnet_sd, calib, self.layers,
                                             qmax)

    def visual(self, images):
        with torch.no_grad():
            return ref_visual.static_forward(
                self.state, ref_visual.preprocess(images.to(self.device),
                                                  self.cfg["visual"]["crop"]),
                self.layers, qmax=self.qmax)

    def outputs(self, recs) -> dict:
        """{"pooled", "grid", "emissions", "tags"} of this side for the
        records' inputs (tags: its own Viterbi paths)."""
        images = torch.stack([r["image"] for r in recs])
        pooled, grid = self.visual(images)
        em = self.protocol.reference_emissions(self, recs, pooled, grid)
        crf = [t.to(self.device) for t in ref_text.crf_params(self.text_sd)]
        tags = [ref_text.viterbi(e.to(self.device), *crf)[0] for e in em]
        return {"pooled": pooled.cpu(), "grid": grid.cpu(), "emissions": em,
                "tags": tags}


def numbers(ref_out: dict, crf, got: dict) -> dict:
    """The compared numbers of `got` ({"pooled", "grid", "emissions",
    "tags"}) against the reference's outputs."""
    visual = max(rel_rms(got["pooled"], ref_out["pooled"]),
                 rel_rms(got["grid"], ref_out["grid"]))
    emis = rel_rms(torch.cat([e.reshape(-1) for e in got["emissions"]]),
                   torch.cat([e.reshape(-1) for e in ref_out["emissions"]]))
    gap = 0.0
    for em, tags in zip(ref_out["emissions"], got["tags"]):
        best = ref_text.viterbi(em, *crf)[1]
        gap = max(gap, best - ref_text.path_score(em, tags, *crf))
    return {"visual_err": visual, "emis_err": emis, "tag_gap": gap}


def program_outputs(recs) -> dict:
    return {"pooled": torch.stack([r["fc"] for r in recs]),
            "grid": torch.stack([r["att"] for r in recs]),
            "emissions": [r["emissions"] for r in recs],
            "tags": [r["tags"] for r in recs]}
