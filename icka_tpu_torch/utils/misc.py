"""Small host-side helpers (port of `icka_tpu.utils.misc`). Ranks come from
`torch.distributed` when a process group is initialised, else this process
is rank 0 of 1; `setup_logger` flushes its file after every record and
writes only on rank 0."""

from __future__ import annotations

import errno
import logging
import os
import random
import sys

import numpy as np
import torch
import torch.distributed as dist


def mkdir(path: str):
    try:
        os.makedirs(path)
    except OSError as e:
        if e.errno != errno.EEXIST:
            raise


def set_seed(seed: int, n_gpu: int = 0):
    """Seed Python's `random`, numpy and torch (every device's default
    generator). The port's modules draw from explicit generators; this
    covers everything else. `n_gpu` is kept for the JAX package's
    signature."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if _initialised() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _initialised() else 1


def is_main_process() -> bool:
    return get_rank() == 0


class _FlushingFileHandler(logging.FileHandler):
    """Flush after every record, so the log survives preemption."""

    def emit(self, record):
        super().emit(record)
        self.flush()


def setup_logger(name: str, save_dir: str = "", distributed_rank: int = 0,
                 filename: str = "log.txt") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if distributed_rank > 0:
        return logger
    if not logger.handlers:
        ch = logging.StreamHandler(stream=sys.stdout)
        fmt = logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s")
        ch.setFormatter(fmt)
        logger.addHandler(ch)
        if save_dir:
            mkdir(save_dir)
            fh = _FlushingFileHandler(os.path.join(save_dir, filename))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
