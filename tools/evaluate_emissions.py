"""Where the fp32 emissions of the kernel path and the plain attention core
part, stage by stage, on the evaluation phase's first batch, on one NVIDIA
GPU.

    python tools/evaluate_emissions.py [--seed 0]

Builds the full-width flagship (`ICKAConfig()`, `use_pallas` on and off on
the same weights from `--seed`) and ResNet-152 with its BatchNorm
statistics calibrated on the request images, exactly as `chip_smoke.py`
phases 3 and 6 do; takes the first batch of 8 rows of the 67-row synthetic
test split; then, for the loader's zero images and for random uint8
images in their place, prints the visual features' sizes and, at each
stage (bare-sentence encoder, txt2img fusion, prompted encoder, gate,
emissions), the largest difference between the two paths and the largest
value, over all positions and over the sentence's own. TF32 off. Imports
the port from the tree this file lies in.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from icka_tpu_torch.core.config import ICKAConfig  # noqa: E402
from icka_tpu_torch.core.device import strict_fp32  # noqa: E402
from icka_tpu_torch.data.clip_store import ClipFeatureStore  # noqa: E402
from icka_tpu_torch.data.conll import read_mm_conll  # noqa: E402
from icka_tpu_torch.data.features import convert_examples  # noqa: E402
from icka_tpu_torch.data.images import preprocess_images  # noqa: E402
from icka_tpu_torch.data.loader import MNERLoader  # noqa: E402
from icka_tpu_torch.data.synthetic import generate_dataset  # noqa: E402
from icka_tpu_torch.kernels import build  # noqa: E402
from icka_tpu_torch.models.icka import ICKAModel  # noqa: E402
from icka_tpu_torch.models.resnet import VisualBackbone  # noqa: E402


def stages(model, inputs, spec):
    """Each stage's output of one forward pass, by name."""
    out = {}
    hooks = [getattr(model, name).register_forward_hook(
        lambda mod, args, res, name=name: out.__setitem__(
            name, res[0] if isinstance(res, tuple) else res))
        for name in ("embedding", "txt2img", "last_encoder")]
    try:
        em, aux = model.emissions(
            **{k: inputs[k] for k in (
                "input_ids", "segment_ids", "input_mask", "ori_input_ids",
                "ori_input_mask", "ori_segment_ids", "img_mask",
                "clip_features", "visual_mean", "visual_grid")},
            mask_positions=spec.mask_positions, offset=spec.offset)
    finally:
        for h in hooks:
            h.remove()
    out.update(gate=aux["gate"], token_embedding=aux["token_embedding"],
               emissions=em)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("evaluate_emissions: needs CUDA", file=sys.stderr)
        return 2
    build.build()
    strict_fp32()
    dev = torch.device("cuda", 0)
    base = ICKAConfig()
    cfgs = {p: dataclasses.replace(
        base, embedding=dataclasses.replace(base.embedding, use_pallas=p),
        last_encoder=dataclasses.replace(base.last_encoder, use_pallas=p))
        for p in (True, False)}
    model = ICKAModel(cfgs[True], device=dev, seed=args.seed).eval()
    plain = ICKAModel(cfgs[False], device=dev, seed=args.seed).eval()
    plain.load_state_dict(model.state_dict(), assign=True)
    backbone = VisualBackbone(device=dev, seed=args.seed + 1).eval()
    tokenizer, _ = cs.prompt_tokenizer()
    _, images, _ = cs.make_requests(base, cs.REQUESTS,
                                    np.random.default_rng(args.seed),
                                    tokenizer)
    cs.calibrate_batch_stats(backbone, preprocess_images(images, 224, dev))

    ds = cs.WORK_DIR / "evaluate_emissions"
    shutil.rmtree(ds, ignore_errors=True)
    generate_dataset(str(ds), n_train=0, n_valid=0, n_test=cs.EVAL_ROWS,
                     clip_dim=base.clip_dim, seed=args.seed,
                     write_images=False)
    feats = convert_examples(read_mm_conll(str(ds / "test.txt")), tokenizer,
                             base.max_seq_length,
                             ClipFeatureStore.from_split(str(ds), "test"),
                             base.clip_dim)
    spec = feats.spec
    batch = next(iter(MNERLoader(feats, str(ds / "images"), cs.EVAL_BATCH,
                                 train=False, prefetch=0)))
    shutil.rmtree(ds)
    rng = np.random.default_rng(args.seed + 7)
    for name, imgs in (("zero images (the loader's)", batch["images"]),
                       ("random uint8 images", rng.integers(
                           0, 256, batch["images"].shape, dtype=np.uint8))):
        with torch.inference_mode():
            _, mean, att = backbone(preprocess_images(imgs, 224, dev))
            inputs = {k: torch.from_numpy(np.asarray(v)).to(dev)
                      for k, v in batch.items()
                      if k not in ("images", "row_valid")}
            inputs = {k: v if v.is_floating_point() else v.long()
                      for k, v in inputs.items()}
            inputs.update(visual_mean=mean.float(), visual_grid=att)
            got, want = stages(model, inputs, spec), stages(plain, inputs,
                                                             spec)
        print(f"# {name}: visual_mean max |x| {mean.abs().max().item():.4e} "
              f"rms {mean.square().mean().sqrt().item():.4e}; visual_grid "
              f"max |x| {att.abs().max().item():.4e}")
        valid = inputs["ori_input_mask"].bool()
        for stage in ("embedding", "txt2img", "last_encoder",
                      "token_embedding", "gate", "emissions"):
            g, w = got[stage].float(), want[stage].float()
            diff = (g - w).abs()
            line = (f"#   {stage:16s} {tuple(g.shape)}: max diff "
                    f"{diff.max().item():.3e}, max |x| "
                    f"{w.abs().max().item():.4e}")
            if g.dim() == 3 and g.shape[1] == valid.shape[1]:
                line += (f"; at the sentence's tokens: max diff "
                         f"{diff[valid].max().item():.3e}")
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
