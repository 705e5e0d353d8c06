"""Optimizer: AdamW + linear-warmup schedule + global-norm clipping (port of
`icka_tpu.train.optimizer`), with optax's arithmetic, over the named fp32
parameters of a module.

The reference recipe:

  - AdamW, lr 3e-5, weight_decay 0.01, decay masked off for biases,
    LayerNorm parameters and CRF transitions (`decay_mask`);
  - `get_linear_schedule_with_warmup` with 10% warmup;
  - global-norm clip 1.0 on every update.

`make_optimizer` is `optax.chain(clip_by_global_norm(max),
adamw(schedule, b1=0.9, b2=0.999, eps=1e-8, mu_dtype, weight_decay, mask))`
op for op: the gradients are scaled by `(g / norm) * max` only when
`norm >= max` (no epsilon in the norm, unlike
`torch.nn.utils.clip_grad_norm_`); the moments are `(1 - b) * g^k + b * m`;
eps is added to the square root of the bias-corrected second moment; the
decoupled decay adds `weight_decay * p` on masked leaves; the learning rate
is read at the count before the increment, so the first update of a warmup
schedule has lr 0; the first moment may be held in bf16 (`mu_dtype`).

ZeRO-1 (`Zero1`, the JAX package's `zero1_moment_specs` layout): each
data-parallel rank keeps and updates only its slice of every moment leaf
that the data axis divides, and of the parameter beside it, then the
updated parameter slices are gathered from the ranks of its data group.
The gradients are the full all-reduced ones on every rank and the global
norm is taken over them, so the update is the replicated one, element for
element. On a model axis (`tp`) every leaf the axis splits is this rank's
model slice, whose data slice ZeRO-1 keeps, and the global norm sums the
split leaves' squares over the model group.

Also the legacy `BertAdam` (no bias correction, per-leaf clipping) and its
warmup schedules. A schedule maps a step to an fp32 0-d tensor.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence

import torch

from icka_tpu_torch.core.config import TrainConfig
from icka_tpu_torch.parallel.collectives import (all_gather_slices_,
                                                 all_reduce_sum_, buckets)
from icka_tpu_torch.parallel.partitioning import moment_slices

Schedule = Callable[[int], torch.Tensor]
MU_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def linear_warmup_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int) -> Schedule:
    """HF get_linear_schedule_with_warmup: 0 -> base over warmup, then
    linear decay to 0 at total_steps."""

    def schedule(step):
        step = _f32(step)
        warm = step / max(1.0, warmup_steps)
        decay = (total_steps - step) / max(1.0, total_steps - warmup_steps)
        return base_lr * torch.clamp(torch.minimum(warm, decay), 0.0, 1.0)

    return schedule


def warmup_cosine(base_lr: float, warmup: float,
                  total_steps: int) -> Schedule:
    """BertAdam 'warmup_cosine'."""

    def schedule(step):
        x = _f32(step) / total_steps
        return base_lr * torch.where(x < warmup, x / warmup,
                                     0.5 * (1.0 + torch.cos(math.pi * x)))

    return schedule


def warmup_constant(base_lr: float, warmup: float,
                    total_steps: int) -> Schedule:
    def schedule(step):
        x = _f32(step) / total_steps
        return base_lr * torch.where(x < warmup, x / warmup, _f32(1.0))

    return schedule


def warmup_linear(base_lr: float, warmup: float,
                  total_steps: int) -> Schedule:
    """BertAdam 'warmup_linear': ramps up then falls linearly."""

    def schedule(step):
        x = _f32(step) / total_steps
        return base_lr * torch.where(x < warmup, x / warmup, 1.0 - x)

    return schedule


def decay_mask(names) -> dict:
    """True where weight decay applies, by parameter name: everything
    except biases, LayerNorm scales and anything under a norm, and CRF
    transitions. The port's names are the flax paths joined with "." (a
    Dense `weight` is the flax `kernel`, which no rule names), so this
    selects exactly the leaves the JAX package's `_decay_mask` selects."""

    def keep(name: str) -> bool:
        parts = name.split(".")
        if parts[-1] in ("bias", "scale"):
            return False
        if any("norm" in p.lower() for p in parts):
            return False
        return not parts[-1].endswith("transitions")

    return {n: keep(n) for n in names}


@dataclass
class AdamState:
    """optax's `ScaleByAdamState` over named leaves: `count` (int32 0-d,
    the updates applied), `mu` (mu_dtype) and `nu` (fp32) by name."""

    count: torch.Tensor
    mu: dict
    nu: dict


def global_norm(grads: Mapping[str, torch.Tensor], tp=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (fp32).
    With `tp` (a `parallel.tensor.TensorParallel`) the leaves it splits
    hold this rank's slices: their squares are summed over the model
    group, and each replicated leaf is counted once."""
    if tp is None:
        return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    dev = next(iter(grads.values())).device
    whole = sum((torch.sum(g * g) for n, g in grads.items()
                 if n in tp.split), torch.zeros((), device=dev)).reshape(1)
    all_reduce_sum_([whole], tp.shard.group)
    return torch.sqrt(sum((torch.sum(g * g) for n, g in grads.items()
                           if n not in tp.split), whole[0]))


class Zero1:
    """ZeRO-1 on `mesh`'s data axis for parameters of the given whole
    shapes (`{name: shape}`): `cuts` holds, for each leaf that
    `zero1_moment_specs` splits, (dimension, this rank's first index,
    slice length); every other leaf is updated whole on every rank.
    `seconds` sums the host-clock time of the gathers."""

    def __init__(self, mesh, shapes: Mapping[str, Sequence[int]]):
        self.mesh = mesh
        self.cuts = moment_slices(shapes, mesh)
        self.seconds = 0.0

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full-shaped leaf (a view), or the leaf."""
        cut = self.cuts.get(name)
        return t if cut is None else t.narrow(*cut)

    def gather_(self, tensors: Mapping[str, torch.Tensor]) -> None:
        """Full-shaped leaves whose slice on this rank is up to date get
        every rank's slice, in place."""
        names = [n for n in tensors if n in self.cuts]
        if not names:
            return
        t0 = time.perf_counter()
        all_gather_slices_([tensors[n] for n in names],
                           [(self.cuts[n][0], self.cuts[n][2])
                            for n in names],
                           self.mesh.rank, self.mesh.group)
        if tensors[names[0]].is_cuda:
            torch.cuda.synchronize(tensors[names[0]].device)
        self.seconds += time.perf_counter() - t0

    def gathered(self, moments: Mapping[str, torch.Tensor],
                 shapes: Mapping[str, Sequence[int]]) -> dict:
        """The full moment leaves, on the CPU, from every rank's slices (a
        collective: every rank calls it), one flat bucket on the device at
        a time."""
        names = list(moments)
        out = {}
        for idx in buckets([math.prod(shapes[n]) for n in names]):
            full = {}
            for i in idx:
                n, m = names[i], moments[names[i]]
                if n in self.cuts:
                    full[n] = torch.empty(tuple(shapes[n]), dtype=m.dtype,
                                          device=m.device)
                    self.local(n, full[n]).copy_(m)
                else:
                    full[n] = m
            self.gather_(full)
            out.update({n: t.cpu() for n, t in full.items()})
        return out


class AdamW:
    """`optax.chain(clip_by_global_norm(max_grad_norm), adamw(...))` over a
    dict of named fp32 parameters, updated in place.

        opt = make_optimizer(cfg, total_steps, names)
        state = opt.init(params)
        opt.update(grads, state, params)     # params and state in place

    With `zero1`, the moments hold this rank's slices of the leaves it
    splits, and `update` ends by gathering the updated parameter slices.
    """

    def __init__(self, schedule: Schedule, max_grad_norm: float,
                 weight_decay: float, mask: Mapping[str, bool],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: str = "float32", zero1: Optional[Zero1] = None,
                 tp=None):
        self.schedule = schedule
        self.tp = tp
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay
        self.mask = dict(mask)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = MU_DTYPES[mu_dtype]
        self.zero1 = zero1

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return t if self.zero1 is None else self.zero1.local(name, t)

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        return AdamState(
            count=torch.zeros((), dtype=torch.int32),
            mu={n: torch.zeros_like(self._local(n, p), dtype=self.mu_dtype)
                for n, p in params.items()},
            nu={n: torch.zeros_like(self._local(n, p))
                for n, p in params.items()})

    def learning_rate(self, count) -> torch.Tensor:
        """The schedule at `count` updates applied (read before the
        increment, as optax's `scale_by_schedule`)."""
        return self.schedule(int(count))

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamState,
               params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step: params, mu, nu and count in place. Returns
        the gradients' global norm before clipping (over the full
        gradients, also under ZeRO-1 and on a model axis)."""
        norm = global_norm(grads, self.tp)
        clip = not bool(norm < self.max_grad_norm)
        count = int(state.count) + 1
        b1, b2 = self.b1, self.b2
        dev = norm.device
        # fp32 scalars, as optax computes them, moved to the device once;
        # b1 in the first moment's dtype, as XLA takes the constant (0.9 is
        # 0.8984375 in bf16)
        bc1, bc2, neg_lr = (t.to(dev) for t in (
            1.0 - _f32(b1) ** count, 1.0 - _f32(b2) ** count,
            -self.learning_rate(state.count)))
        b1_mu = torch.tensor(b1, dtype=self.mu_dtype, device=dev)
        for name, p in params.items():
            g, p = self._local(name, grads[name]), self._local(name, p)
            if clip:
                g = (g / norm) * self.max_grad_norm
            mu = (1 - b1) * g + b1_mu * state.mu[name]
            nu = (1 - b2) * (g * g) + b2 * state.nu[name]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.mask[name]:
                u = u + self.weight_decay * p
            p.add_(neg_lr * u)
            state.mu[name] = mu.to(self.mu_dtype)
            state.nu[name] = nu
        state.count = torch.tensor(count, dtype=torch.int32)
        if self.zero1 is not None:
            self.zero1.gather_(params)
        return norm


def make_optimizer(cfg: TrainConfig, total_steps: int, names,
                   zero1: Optional[Zero1] = None, tp=None) -> AdamW:
    """The JAX package's `make_optimizer`: clip by `cfg.max_grad_norm`,
    AdamW on `linear_warmup_schedule(lr, int(warmup_proportion * total),
    total)` with `cfg.mu_dtype`, decay `cfg.weight_decay` masked by
    `decay_mask(names)`; ZeRO-1 under `zero1`, the model axis's layout
    `tp` (`parallel.tensor.TensorParallel`) for the global norm."""
    schedule = linear_warmup_schedule(
        cfg.learning_rate, int(cfg.warmup_proportion * total_steps),
        total_steps)
    return AdamW(schedule, cfg.max_grad_norm, cfg.weight_decay,
                 decay_mask(names), mu_dtype=cfg.mu_dtype, zero1=zero1,
                 tp=tp)


class BertAdam:
    """The legacy `BertAdam` (`my_bert/optimization.py`): Adam WITHOUT bias
    correction, each leaf's gradient clipped to `max_grad_norm` by its own
    norm (plus 1e-6) before the moment update, decoupled weight decay (on
    masked leaves when `mask` is given). `learning_rate` is a float or a
    schedule, read at the count after the increment. Same interface as
    `AdamW`; `update` returns None."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 max_grad_norm: float = 1.0,
                 mask: Optional[Mapping[str, bool]] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.mask = mask

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        return AdamState(
            count=torch.zeros((), dtype=torch.int32),
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads, state: AdamState, params) -> None:
        count = int(state.count) + 1
        lr = self.learning_rate
        lr = lr(count) if callable(lr) else _f32(lr)
        for name, p in params.items():
            g = grads[name]
            norm = torch.sqrt(torch.sum(g * g))
            g = g * torch.clamp(self.max_grad_norm / (norm + 1e-6), max=1.0)
            mu = self.b1 * state.mu[name] + (1 - self.b1) * g
            nu = self.b2 * state.nu[name] + (1 - self.b2) * g * g
            u = mu / (torch.sqrt(nu) + self.eps)
            if self.mask is None or self.mask[name]:
                u = u + self.weight_decay * p
            p.add_(-lr.to(p.device) * u)
            state.mu[name], state.nu[name] = mu, nu
        state.count = torch.tensor(count, dtype=torch.int32)
