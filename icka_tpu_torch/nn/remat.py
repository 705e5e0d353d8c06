"""Rematerialisation of the self-attention stacks (port of the `remat`
branch of `icka_tpu.nn.attention.Encoder`).

A rematerialised layer keeps only what its policy saves and recomputes the
rest in the backward pass (`torch.utils.checkpoint`, non-reentrant). The
JAX package's policies map onto selective activation checkpointing by the
aten products the port's layers lower to: `Dense` is `F.linear`, which
reaches the dispatcher as `mm` (after a view), and the attention core's
einsums as `bmm`.

  - "dots" (`checkpoint_dots`): every product is saved (`mm`, `bmm`);
    LayerNorm, gelu, softmax, masks and casts are recomputed;
  - "dots_nb" (`checkpoint_dots_with_no_batch_dims`): the products without
    batch dimensions are saved (the projections and the FFN, `mm`); the
    batched (B, N, S, S) score and context products are recomputed;
  - "alternate": even layers are rematerialised whole, odd layers run
    plain;
  - "full", and any other string, as in the JAX package: the whole layer is
    rematerialised, only its inputs saved.

Dropout draws its masks from an explicit `torch.Generator`, which
`checkpoint`'s `preserve_rng_state` does not cover (it saves the global CPU
and CUDA generators only). So each checkpointed layer records the
generator's state before its forward, sets that state for the recompute
and then puts back the state it found: the recompute draws the forward's
masks, and the generator leaves the backward where the forward left it.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_aten = torch.ops.aten
# the products each selective policy saves
SAVED_PRODUCTS = {
    "dots": frozenset({_aten.mm.default, _aten.bmm.default}),
    "dots_nb": frozenset({_aten.mm.default}),
}


def _policy_fn(saved, ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if func in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def rematerialised(policy: str, index: int) -> bool:
    """Whether layer `index` of a stack under `policy` is rematerialised:
    every layer but the odd ones of "alternate"."""
    return not (policy == "alternate" and index % 2 == 1)


def remat_call(layer, policy: str, x, bias=None, dropout_gen=None,
               history=None, history_bias=None):
    """`layer(x, bias, dropout_gen, history, history_bias)` (a
    self-attention layer and its history KV-concat) rematerialised under
    `policy` (see the module docstring): checkpointed when grad is
    enabled, a plain call otherwise."""
    if not torch.is_grad_enabled():
        return layer(x, bias, dropout_gen, history, history_bias)
    saved = SAVED_PRODUCTS.get(policy)
    start = None if dropout_gen is None else dropout_gen.get_state()
    calls = 0

    def run(*inputs):
        nonlocal calls
        calls += 1
        if calls == 1 or dropout_gen is None:
            return layer(*inputs[:2], dropout_gen, *inputs[2:])
        # the recompute: the forward's draws, then the generator as found
        found = dropout_gen.get_state()
        dropout_gen.set_state(start)
        try:
            return layer(*inputs[:2], dropout_gen, *inputs[2:])
        finally:
            dropout_gen.set_state(found)

    kw = {}
    if saved is not None:
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   partial(_policy_fn, saved))
    # the port draws no random number from the global generators, so there
    # is no global state to preserve
    return checkpoint(run, x, bias, history, history_bias,
                      use_reentrant=False,
                      preserve_rng_state=False, **kw)
