"""Mixed-precision policy (port of `icka_tpu.core.dtypes`) on torch dtypes.

fp32 parameters and accumulation, matmuls in the compute dtype (bf16 by
default), and fp32 always for the numerically sensitive paths (CRF
likelihood and Viterbi, LayerNorm statistics, softmax). bf16 needs no loss
scaling.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # CRF / loss / layernorm statistics always run in this dtype.
    reduce_dtype: torch.dtype = torch.float32

    @classmethod
    def full_precision(cls) -> "DTypePolicy":
        return cls(compute_dtype=torch.float32)

    @classmethod
    def from_str(cls, name: str) -> "DTypePolicy":
        if name in ("bfloat16", "bf16"):
            return cls()
        if name in ("float32", "fp32"):
            return cls.full_precision()
        raise ValueError(f"unknown compute dtype {name!r}")
