"""Bidirectional LSTM head (port of `icka_tpu.nn.lstm`).

torch nn.LSTM numerics (gate order i,f,g,o; separate input and hidden
biases), so reference weights import unchanged. The input projection of
every timestep and both directions is one matmul; the recurrence is a plain
time loop with one batched (2, B, H) x (2, H, 4H) matmul per step for both
directions, the backward direction running over the time-reversed
sequence. Products are summed in fp32 and the recurrent state is fp32.

The int8 modes quantise the input projection only, as the JAX module does
(the small recurrent product stays in the compute dtype): `"int8"`
quantises the concatenated (in, 8H) input weights per column at every call
and the input per row, and records the largest |x| in `calib_amax`;
`"int8_static"` holds no `w_ih_fwd`/`w_ih_bwd` but `w_ih_q` (in, 8H) int8,
`w_ih_scale` (8H,) and a calibrated `act_scale` () as buffers. Both scale
the int32 sums as `acc * (a_scale * w_scale)`, the scales multiplied
first (the `Dense` layer multiplies `(acc * a_scale) * kernel_scale`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from icka_tpu_torch.core.device import generator_for, resolve_device
from icka_tpu_torch.nn.layers import QUANT_MODES
from icka_tpu_torch.nn.quant import (abs_max_scale, column_major,
                                     int8_matmul, quantize_activation,
                                     quantize_weight_cols)


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
    the recurrence it would run alone. `quant` selects the input
    projection's mode (see the module's docstring).
    """

    def __init__(self, in_dim: int, hidden: int, dtype=torch.float32,
                 quant: str = "none", device="cuda", generator=None):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got "
                             f"{quant!r}")
        dev = resolve_device(device)
        gen = generator_for(dev, None, generator)
        self.hidden = hidden
        self.dtype = dtype
        self.quant = quant
        k = 1.0 / math.sqrt(hidden)
        H4 = 4 * hidden
        for d in ("fwd", "bwd"):
            shapes = [(f"w_hh_{d}", (H4, hidden)), (f"b_ih_{d}", (H4,)),
                      (f"b_hh_{d}", (H4,))]
            if quant != "int8_static":
                shapes.append((f"w_ih_{d}", (H4, in_dim)))
            for name, shape in shapes:
                p = nn.Parameter(torch.empty(shape, device=dev))
                nn.init.uniform_(p, -k, k, generator=gen)
                self.register_parameter(name, p)
        if quant == "int8_static":
            self.register_buffer("w_ih_q", column_major(torch.zeros(
                in_dim, 2 * H4, dtype=torch.int8, device=dev)))
            self.register_buffer("w_ih_scale", torch.full(
                (2 * H4,), 1.0 / 127.0, device=dev))
            self.register_buffer("act_scale",
                                 torch.full((), 1.0 / 127.0, device=dev))
        elif quant == "int8":
            self.register_buffer("calib_amax", torch.zeros((), device=dev),
                                 persistent=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        if self.quant == "int8_static":
            self.w_ih_q = column_major(self.w_ih_q)

    def input_projection(self, x):
        """(B, L, 8H) fp32 input contribution of both directions, before
        the input biases: the forward gates' columns, then the backward's."""
        if self.quant == "int8_static":
            a_s = self.act_scale
            acc = int8_matmul(quantize_activation(x, a_s), self.w_ih_q)
            return acc.float() * (a_s * self.w_ih_scale)
        w_ih = torch.cat([self.w_ih_fwd.T, self.w_ih_bwd.T], dim=1)
        if self.quant == "none":
            return _mm_f32(x, w_ih, self.dtype)
        w_q, w_s = quantize_weight_cols(w_ih)
        amax = x.float().abs().amax(dim=-1, keepdim=True)
        self.calib_amax.copy_(torch.maximum(self.calib_amax, amax.max()))
        a_s = abs_max_scale(amax)
        acc = int8_matmul(quantize_activation(x, a_s), w_q)
        return acc.float() * (a_s * w_s)

    def forward(self, x, mask=None, reset_fwd=None, reset_bwd=None):
        H, dt = self.hidden, self.dtype
        B, L, _ = x.shape
        proj = self.input_projection(x)                        # (B, L, 8H)
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
