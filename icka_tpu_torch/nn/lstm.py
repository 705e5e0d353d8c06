"""Bidirectional LSTM head (port of `icka_tpu.nn.lstm`, `quant="none"`).

torch nn.LSTM numerics (gate order i,f,g,o; separate input and hidden
biases), so reference weights import unchanged. The input projection of
every timestep and both directions is one matmul; the recurrence is a plain
time loop with one batched (2, B, H) x (2, H, 4H) matmul per step for both
directions, the backward direction running over the time-reversed
sequence. Products are summed in fp32 and the recurrent state is fp32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from icka_tpu_torch.core.device import generator_for, resolve_device


def _mm_f32(a, b, dtype):
    """a @ b with inputs rounded to `dtype` and the products summed in fp32
    (exact products: a bf16 x bf16 product fits an fp32)."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


class BiLSTM(nn.Module):
    """batch_first, single layer; output (B, L, 2H) = forward states
    concatenated with backward states.

    `mask` (B, L) {0,1}, optional: padding timesteps hold the recurrent
    state (h, c), so the backward direction enters each row's valid region
    with the zero state whatever the padding (`ICKAConfig.masked_lstm`).
    None = torch nn.LSTM over the padded sequence.

    `reset_fwd` / `reset_bwd` (B, L) {0,1}, optional, for sequence packing:
    the forward carry is zeroed before a token with `reset_fwd` set (a
    segment's first token), the backward carry before a token with
    `reset_bwd` set (a segment's last token), so each packed segment runs
    the recurrence it would run alone. (The JAX module's int8 modes are not
    ported.)
    """

    def __init__(self, in_dim: int, hidden: int, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.hidden = hidden
        self.dtype = dtype
        k = 1.0 / math.sqrt(hidden)
        H4 = 4 * hidden
        for d in ("fwd", "bwd"):
            for name, shape in ((f"w_hh_{d}", (H4, hidden)),
                                (f"b_ih_{d}", (H4,)), (f"b_hh_{d}", (H4,)),
                                (f"w_ih_{d}", (H4, in_dim))):
                p = nn.Parameter(torch.empty(shape, device=dev))
                nn.init.uniform_(p, -k, k, generator=gen)
                self.register_parameter(name, p)

    def forward(self, x, mask=None, reset_fwd=None, reset_bwd=None):
        H, dt = self.hidden, self.dtype
        B, L, _ = x.shape
        w_ih = torch.cat([self.w_ih_fwd.T, self.w_ih_bwd.T], dim=1)
        proj = _mm_f32(x, w_ih, dt)                            # (B, L, 8H)
        fwd_in = proj[..., :4 * H] + self.b_ih_fwd
        bwd_in = proj[..., 4 * H:] + self.b_ih_bwd
        x_proj = torch.stack([fwd_in, bwd_in.flip(1)], dim=0)  # (2,B,L,4H)
        w_hh = torch.stack([self.w_hh_fwd.T, self.w_hh_bwd.T]).to(dt).float()
        b_hh = torch.stack([self.b_hh_fwd, self.b_hh_bwd])[:, None, :]
        hold = None
        if mask is not None:
            m = mask.float()
            hold = torch.stack([m, m.flip(1)], dim=0)[..., None] > 0
        reset = None
        if reset_fwd is not None or reset_bwd is not None:
            rf, rb = (torch.zeros(B, L, device=x.device) if r is None
                      else r.float() for r in (reset_fwd, reset_bwd))
            # the backward direction scans the flipped sequence
            reset = torch.stack([rf, rb.flip(1)], dim=0)[..., None] > 0

        h = torch.zeros(2, B, H, device=x.device)
        c = torch.zeros(2, B, H, device=x.device)
        hs = []
        for t in range(L):
            if reset is not None:
                h = h.masked_fill(reset[:, :, t], 0.0)
                c = c.masked_fill(reset[:, :, t], 0.0)
            gates = x_proj[:, :, t] + torch.bmm(h.to(dt).float(), w_hh) + b_hh
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c_new = f * c + i * torch.tanh(g)
            h_new = o * torch.tanh(c_new)
            if hold is not None:
                c_new = torch.where(hold[:, :, t], c_new, c)
                h_new = torch.where(hold[:, :, t], h_new, h)
            h, c = h_new, c_new
            hs.append(h)
        hs = torch.stack(hs, dim=2)                            # (2,B,L,H)
        return torch.cat([hs[0], hs[1].flip(1)], dim=-1).to(dt)
