"""The yardstick's work functions against `FlopCounterMode` over the
reference at a tiny size, and the kernel bounds against the hand-worked
figures of PERF.md's kernel table."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import layout, weights, work
from portbench.reference import text as ref_text
from portbench.reference import visual as ref_visual
from portbench.tests import tiny

CPU = torch.device("cpu")
TOKENS = {"bos": 0, "eos": 2, "pad": 1, "mask": 599, "low": 3}


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("L", [5, 17, 32])
def test_icka_flops(L):
    m = tiny.icka_model()
    sd = weights.text_weights("icka", m, 1, CPU)
    ids = torch.randint(3, 500, (L,)).numpy()
    ids[0], ids[-1] = 0, 2
    head = torch.randint(3, 500, (14,)).numpy()
    R = m["region_dim"]
    batch = layout.reference_batch(
        "icka", [ids], L, TOKENS, head, 49, torch.randn(1, R),
        torch.randn(1, 7, 7, R), torch.randn(1, m["clip_dim"]), CPU)
    got = _counted(lambda: ref_text.icka_emissions(
        sd, m, batch, 14, (3, 11), ref_text.Precision()))
    assert got == work.icka_flops(L, m, 14)


@pytest.mark.parametrize("L", [6, 32])
def test_gate_cl_flops(L):
    m = dict(tiny.gate_cl_model(), max_seq_length=L)
    sd = weights.text_weights("gate_cl", m, 1, CPU)
    ids = torch.randint(103, 500, (L,)).numpy()
    R = m["region_dim"]
    batch = layout.reference_batch(
        "gate_cl", [ids], L, {"pad": 0}, None, 49, torch.randn(1, R),
        torch.randn(1, 7, 7, R), None, CPU)
    got = _counted(lambda: ref_text.gate_cl_emissions(
        sd, m, batch, ref_text.Precision()))
    H = m["encoder"]["hidden_size"]
    # the pooler and the contrastive heads run on the served path, not in
    # the emissions
    heads = 2 * H * H + 2 * (3 * H * H + R * H)
    assert got + heads == work.gate_cl_flops(L, m)


@pytest.mark.parametrize("layers,size", [((1, 1, 1, 1), 64),
                                         ((2, 1, 3, 2), 96)])
def test_resnet_ops(layers, size):
    pixels = torch.randn(2, 3, size, size)
    sd = weights.resnet_weights(layers, 1, pixels, CPU)
    got = _counted(lambda: ref_visual.float_forward(sd, pixels, layers))
    assert got == 2 * work.resnet_ops(layers, size)


def test_resnet152_ops_per_image():
    assert work.resnet_ops((3, 8, 36, 3), 224) == pytest.approx(23.0e9,
                                                                rel=0.01)


def test_kernel_bounds_match_the_kernel_table():
    """PERF.md section 6 at B=128: K4 layer3 0.0282 ms (operations),
    layer1 0.0614 ms (bytes), K5 0.0671 ms (bytes), K1 bf16 S=150
    0.0470 ms (bytes)."""
    ms = 1e3
    assert work.bottleneck_bound_s(128, 14, 256, False) * ms == \
        pytest.approx(0.0282, abs=2e-4)
    assert work.bottleneck_bound_s(128, 56, 64, False) * ms == \
        pytest.approx(0.0614, abs=2e-4)
    assert work.stem_bound_s(128, 224) * ms == pytest.approx(0.0671, abs=2e-4)
    assert work.attention_bound_s(128, 150, 16, 64) * ms == \
        pytest.approx(0.0470, abs=2e-4)


def test_k1_calls_per_batch():
    """48 launches a flagship batch (24 + 24 layers), 12 a BERT-base one,
    at the prompted encoder's spliced length."""
    import json
    from portbench.run import ROOT
    cfg = json.loads((ROOT / "portbench/configs/icka_flagship_bf16.json")
                     .read_text())
    calls = work.k1_calls("icka", cfg["model"], 14, 128, 128)
    assert [(S, k) for _, S, _, _, k in calls] == [(128, 24), (150, 24)]
    g = json.loads((ROOT / "portbench/configs/gate_cl_bf16.json")
                   .read_text())
    assert work.k1_calls("gate_cl", g["model"], 0, 16, 512) == \
        [(512, 16, 12, 64, 12)]
