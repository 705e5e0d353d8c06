"""Device selection and float32 policy for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default and is never
    silently replaced: asking for it without a card raises. The CPU is used
    only when the caller names it (the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def strict_fp32() -> None:
    """fp32 means fp32: turn TF32 off for cuBLAS matmuls and cuDNN convs
    (cuDNN convs default to TF32). The counterpart of the JAX package's
    `matmul_precision` (HIGHEST for fp32). Parity runs call this once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def generator_for(device: torch.device, seed: int | None,
                  generator: torch.Generator | None) -> torch.Generator:
    """The generator a module initialises from: the caller's, else a new one
    on `device` seeded with `seed` (0 when None)."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(
        0 if seed is None else seed)
