"""Inference/test CLI (port of `icka_tpu.cli.evaluate`): rehydrate the
config and the best checkpoint that the JAX package's `Checkpointer` wrote
in an output directory, run the test (or valid) split through the
flagship model, print the seqeval-style report and chunk-exact P/R/F1.

    python -m icka_tpu_torch.cli.evaluate --output_dir OUT --data_dir ... \
        --path_image ... --tokenizer_dir ...
    python -m icka_tpu_torch.cli.evaluate --synthetic DIR --tiny \
        --output_dir OUT --device cpu

The flags are the JAX CLI's, with `--device {cuda,cpu}` (default cuda) in
place of `--platform`/`--cpu_devices`. `--tiny` runs fp32 with ResNet
layers (1, 1, 1, 1) and a decode size of 64; otherwise bf16, ResNet-152
and 256.
"""

from __future__ import annotations

import argparse
import os

from icka_tpu_torch.core.checkpoint import Checkpointer
from icka_tpu_torch.core.config import ICKAConfig, TrainConfig, load_config
from icka_tpu_torch.data.clip_store import ClipFeatureStore
from icka_tpu_torch.data.conll import read_mm_conll
from icka_tpu_torch.data.features import convert_examples
from icka_tpu_torch.data.loader import MNERLoader
from icka_tpu_torch.data.synthetic import tiny_tokenizer
from icka_tpu_torch.data.tokenization import ByteLevelBPETokenizer
from icka_tpu_torch.train.trainer import ICKATrainer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", required=True)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--path_image", default=None)
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--split", default="test", choices=["valid", "test"])
    p.add_argument("--eval_batch_size", type=int, default=4)
    p.add_argument("--synthetic", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    if args.synthetic:
        args.data_dir = args.synthetic
        args.path_image = os.path.join(args.synthetic, "images")
        tokenizer = tiny_tokenizer(os.path.join(args.synthetic, "tokenizer"))
    else:
        tokenizer = ByteLevelBPETokenizer(
            os.path.join(args.tokenizer_dir, "vocab.json"),
            os.path.join(args.tokenizer_dir, "merges.txt"))

    model_cfg = load_config(
        ICKAConfig, os.path.join(args.output_dir, "config.json"))
    train_cfg = TrainConfig(eval_batch_size=args.eval_batch_size,
                            compute_dtype="float32" if args.tiny
                            else "bfloat16")

    examples = read_mm_conll(
        os.path.join(args.data_dir, f"{args.split}.txt"))
    clip = ClipFeatureStore.from_split(args.data_dir, args.split)
    feats = convert_examples(examples, tokenizer,
                             model_cfg.max_seq_length, clip,
                             model_cfg.clip_dim)

    resnet_layers = (1, 1, 1, 1) if args.tiny else (3, 8, 36, 3)
    trainer = ICKATrainer(model_cfg, train_cfg, feats.spec,
                          resnet_layers=resnet_layers, device=args.device)
    loader = MNERLoader(feats, args.path_image, args.eval_batch_size,
                        train=False,
                        decode_size=64 if args.tiny else 256)
    trainer.state_from_checkpoint(Checkpointer(args.output_dir)
                                  .restore_best())

    result = trainer.evaluate(loader)
    print(result.report)
    for cls, (f1, p, r) in (result.per_class or {}).items():
        print(f"{cls}: p = {p:.4f}, r = {r:.4f}, f1 = {f1:.4f}")
    print(f"Overall: p = {result.precision:.4f}, r = {result.recall:.4f}, "
          f"f1 = {result.f1:.4f} (acc {result.acc:.4f}, "
          f"loss {result.loss:.4f})")
    return result


if __name__ == "__main__":
    main()
