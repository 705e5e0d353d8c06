"""Training CLI (port of `icka_tpu.cli.train`): the flagship model or the
gate_cl family.

    python -m icka_tpu_torch.cli.train --data_dir ... --path_image ... \
        --tokenizer_dir ... --output_dir out/
    python -m icka_tpu_torch.cli.train --synthetic DIR --tiny --device cpu
    python -m icka_tpu_torch.cli.train --synthetic DIR --tiny --model gate_cl
    torchrun --nproc_per_node 2 -m icka_tpu_torch.cli.train ... --data_axis -1
    torchrun --nproc_per_node 2 -m icka_tpu_torch.cli.train ... --model_axis 2

The flags are the JAX CLI's, with `--device {cuda,cpu}` (default cuda) in
place of `--platform`/`--cpu_devices`/`--multihost`. Under torchrun (its
`RANK` and `WORLD_SIZE` in the environment) the ranks form the data axis
(`core.mesh.init_distributed`: NCCL when each rank has a card of its own,
gloo otherwise): every rank loads the global batch of
`--train_batch_size` rows and trains on its share of it, as the JAX
package's single-host data axis does; rank 0 writes the corpus of
`--synthetic`, the checkpoints and the lines. A caller that started the
process group itself has its ranks used the same way. `--model_axis M`
makes the ranks a (data, model) grid, rank = d * M + m: the M ranks of
one data index split every layer between them (tensor parallelism) and
train on the rows of that index; `--data_axis -1` is then the ranks over
M. `--model
gate_cl|cl|ip` trains that variant of the my_bert family
(`GateCLTrainer`) on BERT-base, or with `--tiny` on
`GateCLConfig.tiny(variant)` with `region_dim` 2048 and the tiny ICKA
configuration's `max_seq_length`, exactly as the JAX CLI builds it; the
output directory's config.json is the ICKA configuration in either case,
as there. `--synthetic DIR` writes the JAX CLI's corpus (32/8/8 rows,
64x64 JPEGs) and trains on it; `--tiny` is its tiny configuration (ResNet
layers (1, 1, 1, 1), decode size 64). It prints one line per epoch and
`done; best dev F1 = ...`, as the JAX CLI does; SIGTERM/SIGINT snapshot the
last completed step, and rerunning the same command resumes it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch.distributed as dist

from icka_tpu_torch.core.checkpoint import Checkpointer, PreemptionGuard
from icka_tpu_torch.core.config import (GateCLConfig, ICKAConfig,
                                        TrainConfig, load_config, to_json)
from icka_tpu_torch.core.mesh import init_distributed
from icka_tpu_torch.data.clip_store import ClipFeatureStore
from icka_tpu_torch.data.conll import read_mm_conll
from icka_tpu_torch.data.features import convert_examples
from icka_tpu_torch.data.loader import MNERLoader
from icka_tpu_torch.data.synthetic import generate_dataset, tiny_tokenizer
from icka_tpu_torch.data.tokenization import ByteLevelBPETokenizer
from icka_tpu_torch.train.gate_cl_trainer import GateCLTrainer
from icka_tpu_torch.train.trainer import ICKATrainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train ICKA on MNER data")
    p.add_argument("--data_dir", default=None,
                   help="dir with train/valid/test.txt + Clip/*.pkl")
    p.add_argument("--path_image", default=None, help="image directory")
    p.add_argument("--output_dir", default="out")
    p.add_argument("--task_name", default="twitter2015",
                   choices=["twitter2015", "twitter2017"])
    p.add_argument("--tokenizer_dir", default=None,
                   help="dir with vocab.json + merges.txt (RoBERTa BPE)")
    p.add_argument("--model", default="icka",
                   choices=["icka", "gate_cl", "cl", "ip"],
                   help="flagship ICKA or the my_bert gate_cl family")
    p.add_argument("--model_config", default=None,
                   help="ICKAConfig JSON; default = roberta-large flagship")
    p.add_argument("--max_seq_length", type=int, default=128)
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--eval_batch_size", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=5)
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--num_train_epochs", type=int, default=25)
    p.add_argument("--seed", type=int, default=19260817)
    p.add_argument("--fine_tune_cnn", action="store_true")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--data_axis", type=int, default=-1,
                   help="mesh size along the data axis (-1: every rank "
                        "torchrun started, one without torchrun)")
    p.add_argument("--model_axis", type=int, default=1,
                   help="mesh size along the model axis: the ranks that "
                        "split each layer (tensor parallelism)")
    p.add_argument("--synthetic", default=None,
                   help="generate a synthetic dataset at this path and "
                        "train on it")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (tests/smoke)")
    p.add_argument("--epochs_override", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    start = "RANK" in os.environ and "WORLD_SIZE" in os.environ \
        and not dist.is_initialized()
    if start:
        init_distributed(args.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        return _main(args, rank)
    finally:
        if start:
            dist.destroy_process_group()


def _main(args, rank: int):
    if args.synthetic:
        root = args.synthetic
        tok_dir = os.path.join(root, "tokenizer")
        if rank == 0:
            generate_dataset(root, n_train=32, n_valid=8, n_test=8,
                             image_size=64, clip_dim=16 if args.tiny else 512)
            tiny_tokenizer(tok_dir)
        if dist.is_initialized():
            dist.barrier()
        args.data_dir = root
        args.path_image = os.path.join(root, "images")
        tokenizer = ByteLevelBPETokenizer(
            os.path.join(tok_dir, "vocab.json"),
            os.path.join(tok_dir, "merges.txt"))
    else:
        if not (args.data_dir and args.path_image and args.tokenizer_dir):
            raise SystemExit(
                "--data_dir, --path_image and --tokenizer_dir are required "
                "(or use --synthetic)")
        tokenizer = ByteLevelBPETokenizer(
            os.path.join(args.tokenizer_dir, "vocab.json"),
            os.path.join(args.tokenizer_dir, "merges.txt"))

    if args.model_config:
        model_cfg = load_config(ICKAConfig, args.model_config)
    elif args.tiny:
        # region_dim stays 2048: the (shrunken-depth) ResNet still ends at
        # 2048 channels; clip_dim must match the dataset's stored features
        model_cfg = dataclasses.replace(
            ICKAConfig.tiny(vocab_size=len(tokenizer.vocab) + 8),
            max_seq_length=min(args.max_seq_length, 48),
            region_dim=2048, clip_dim=16 if args.synthetic else 512)
    else:
        model_cfg = ICKAConfig()

    train_cfg = TrainConfig(
        learning_rate=args.learning_rate,
        warmup_proportion=args.warmup_proportion,
        num_train_epochs=args.num_train_epochs,
        train_batch_size=args.train_batch_size,
        eval_batch_size=args.eval_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        seed=args.seed,
        fine_tune_cnn=args.fine_tune_cnn,
        compute_dtype=args.compute_dtype,
        data_axis=args.data_axis,
        model_axis=args.model_axis,
    )

    msl = model_cfg.max_seq_length
    features = {}
    for split in ("train", "valid"):
        features[split] = convert_examples(
            read_mm_conll(os.path.join(args.data_dir, f"{split}.txt")),
            tokenizer, msl, ClipFeatureStore.from_split(args.data_dir, split),
            model_cfg.clip_dim)

    resnet_layers = (1, 1, 1, 1) if args.tiny else (3, 8, 36, 3)
    decode_size = 64 if args.tiny else 256
    if args.model != "icka":
        if args.tiny:
            gcfg = dataclasses.replace(
                GateCLConfig.tiny(vocab_size=len(tokenizer.vocab) + 8,
                                  variant=args.model),
                region_dim=2048, max_seq_length=model_cfg.max_seq_length)
        else:
            gcfg = GateCLConfig(variant=args.model,
                                max_seq_length=model_cfg.max_seq_length)
        trainer = GateCLTrainer(gcfg, train_cfg, resnet_layers=resnet_layers,
                                device=args.device)
    else:
        trainer = ICKATrainer(model_cfg, train_cfg, features["train"].spec,
                              resnet_layers=resnet_layers,
                              device=args.device)
    train_loader = MNERLoader(
        features["train"], args.path_image, train_cfg.train_batch_size,
        train_cfg.gradient_accumulation_steps, train=True,
        decode_size=decode_size, seed=train_cfg.seed)
    dev_loader = MNERLoader(
        features["valid"], args.path_image, train_cfg.eval_batch_size,
        train=False, decode_size=decode_size)

    ckpt = Checkpointer(args.output_dir)
    if rank == 0:
        ckpt.save_config(to_json(model_cfg))
    epochs = args.epochs_override or train_cfg.num_train_epochs
    # SIGTERM/SIGINT during training snapshots the last completed step
    # (atomic write) and exits cleanly; rerunning the same command resumes
    with PreemptionGuard() as guard:
        trainer.fit(train_loader, dev_loader, epochs=epochs,
                    checkpointer=ckpt, preemption_guard=guard)
    if rank == 0:
        print(f"done; best dev F1 = {ckpt.manifest['best_metric']}")
    return trainer


if __name__ == "__main__":
    main()
