"""The int8 text half of the PyTorch/CUDA port against the JAX package on the
CPU: `Dense` and `BiLSTM` in `quant="int8"` and `quant="int8_static"`, the
exact int8 product, the calibration record, both text quantisers, the
weight bridge of the quantised trees and the int8-static flagship, bucketed
and packed, at `ICKAConfig.tiny()` size with `use_pallas=True` and every
ablation flag on.

Tolerances:
  - integer paths are bit-equal: a quantised `Dense`'s output and the
    BiLSTM's int8 input projection (`x_proj`), the quantised weights and
    scales, and a module's recorded amax on the same input;
  - the BiLSTM's output is within 1e-5 (the recurrence's sigmoid and tanh
    differ by ulps between XLA and torch), as in test_torch_lstm_crf.py;
  - the calibration record of a whole model is within 1e-6 relative, leaf
    for leaf: each leaf is the largest |x| of a float activation that
    upstream LayerNorm, gelu and softmax compute to within a few ulps of
    the JAX package's, and on the JAX package's own inputs every module
    records its amax bit for bit;
  - the composed int8-static flagship: emissions within 1e-4 and identical
    Viterbi tags (tests/test_full_graph_parity.py's thresholds). An
    activation within an ulp of a rounding boundary could quantise to
    another int8 code in the two packages; at this size and seed none does
    (the emissions agree to about 2e-8), and every quantised `Dense` of the
    model, fed the JAX package's own input, gives its output bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from icka_tpu.models import convert as jconvert  # noqa: E402
from icka_tpu.models.icka import ICKAModel as JaxICKAModel  # noqa: E402
from icka_tpu.nn import layers as jlayers  # noqa: E402
from icka_tpu.nn import lstm as jlstm  # noqa: E402
from icka_tpu.serving.bucketed import BucketedICKAServer as JaxServer  # noqa: E402
from icka_tpu_torch.convert import (calib_from_flax,  # noqa: E402
                                    icka_state_dict,
                                    icka_variables_from_state_dict,
                                    state_dict_from_flax)
from icka_tpu_torch.core.config import ICKAConfig as TICKAConfig  # noqa: E402
from icka_tpu_torch.core.config import from_json, to_json  # noqa: E402
from icka_tpu_torch.models import convert as tconvert  # noqa: E402
from icka_tpu_torch.models.icka import ICKAModel  # noqa: E402
from icka_tpu_torch.nn import layers as tlayers  # noqa: E402
from icka_tpu_torch.nn import quant as tquant  # noqa: E402
from icka_tpu_torch.nn.lstm import BiLSTM  # noqa: E402
from icka_tpu_torch.serving.bucketed import BucketedICKAServer  # noqa: E402
from tests.test_torch_packing import (MASKS, MAXL, OFFSET,  # noqa: E402
                                      _cfg, _examples, _forward_packed_both)

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x))


def _quant(cfg, mode):
    return dataclasses.replace(
        cfg, embedding=dataclasses.replace(cfg.embedding, quant=mode),
        last_encoder=dataclasses.replace(cfg.last_encoder, quant=mode))


def _port(cfg, dtype=torch.float32):
    return ICKAModel(from_json(TICKAConfig, to_json(cfg)), dtype=dtype,
                     device=CPU).eval()


def _zeros_like_init(model, batch):
    """The variables' structure of `model` without running it."""
    shapes = jax.eval_shape(
        lambda key, b: model.init(key, b, MASKS, OFFSET, mode="test"),
        jax.random.PRNGKey(0), batch)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def _batch(cfg, rng, B=3, L=MAXL):
    """Ragged sentences padded to L, prompted layout of OFFSET + L."""
    vocab, pad = cfg.embedding.vocab_size, cfg.embedding.pad_token_id
    lens = np.maximum(L - 5 * np.arange(B), 3)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    pmask = np.concatenate([np.ones((B, OFFSET), np.int32), mask], 1)
    return {
        "input_ids": np.where(pmask > 0, rng.integers(2, vocab, pmask.shape),
                              pad).astype(np.int32),
        "segment_ids": np.concatenate([np.zeros((B, OFFSET), np.int32),
                                       np.ones((B, L), np.int32)], 1),
        "input_mask": pmask,
        "ori_input_ids": np.where(mask > 0, rng.integers(2, vocab, (B, L)),
                                  pad).astype(np.int32),
        "ori_input_mask": mask,
        "ori_segment_ids": np.zeros((B, L), np.int32),
        "img_mask": np.ones((B, cfg.num_regions), np.int32),
        "clip_features": rng.standard_normal((B, 1, cfg.clip_dim))
        .astype(np.float32),
        "visual_mean": rng.standard_normal((B, cfg.region_dim))
        .astype(np.float32),
        "visual_grid": rng.standard_normal((B, 7, 7, cfg.region_dim))
        .astype(np.float32),
        "output_mask": mask,
    }


def _inputs(batch):
    return {k: v for k, v in batch.items() if k != "output_mask"}


class _Recorder:
    """Records the input and output of every quantised JAX `Dense` and
    `BiLSTM` call, by module path ("embedding.encoder.layer_0.attn.query",
    "lstm")."""

    def __init__(self):
        self.calls = {}

    def __call__(self, next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if (context.method_name == "__call__"
                and isinstance(mod, (jlayers.Dense, jlstm.BiLSTM))
                and mod.quant != "none"):
            self.calls.setdefault(".".join(mod.path), []).append(
                (np.asarray(args[0]), np.asarray(out)))
        return out


# -- the exact int8 product ---------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 8, 8), (5, 7, 9), (16, 64, 32),
                                   (17, 64, 32), (3, 11, 147, 64)])
def test_int8_matmul_exact(shape):
    """Against an int64 product, including M <= 16 and K, F not multiples
    of 8; `w` in either layout; then the operands as the card's `_int_mm`
    takes them (zero-padded, the weight column-major), run here: still
    exact once sliced."""
    *lead, K, N = shape
    rng = np.random.default_rng(K)
    a = rng.integers(-127, 128, (*lead, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    want = a.astype(np.int64) @ w.astype(np.int64)
    for wt in (_t(w), tquant.column_major(_t(w))):
        got = tquant.int8_matmul(_t(a), wt)
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    M = int(np.prod(lead))
    a2, wp = tquant._card_operands(_t(a).reshape(M, K), _t(w))
    assert a2.shape[0] >= 24 and a2.shape[0] % 8 == 0
    assert a2.shape[1] % 8 == 0 and wp.shape[1] % 8 == 0
    assert wp.stride(0) == 1                      # column-major
    np.testing.assert_array_equal(
        torch._int_mm(a2, wp)[:M, :N].reshape(want.shape).numpy(), want)


def test_int8_matmul_refuses_other_types():
    with pytest.raises(TypeError):
        tquant.int8_matmul(torch.zeros(4, 8), torch.zeros(8, 8,
                                                          dtype=torch.int8))
    with pytest.raises(ValueError):
        tquant.int8_matmul(torch.zeros(4, 8, dtype=torch.int8),
                           torch.zeros(9, 8, dtype=torch.int8))


# -- Dense ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_dense_int8_bit_equal_to_jax(quant, dtype):
    """Outputs bit for bit in fp32 and bf16 (every float op is one
    correctly rounded op in both packages); "int8" records the JAX
    `calib` leaf and max-merges over calls; some inputs of the static layer
    clip at +-127."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 7, 24)) * 2).astype(np.float32)
    jm = jlayers.Dense(40, quant=quant, dtype=getattr(jnp, dtype))
    params = dict(jax.device_get(jm.init(jax.random.PRNGKey(1), x))["params"])
    params["kernel_scale"] = (rng.uniform(0.5, 1.5, 40) * 0.01) \
        .astype(np.float32)
    params["bias"] = rng.standard_normal(40).astype(np.float32)
    if quant == "int8_static":
        params["act_scale"] = np.float32(0.031)
        assert np.abs(x).max() / 0.031 > 127
    want, state = jm.apply({"params": params}, x, mutable=["calib"])
    tm = tlayers.Dense(24, 40, dtype=getattr(torch, dtype), quant=quant,
                       device=CPU).eval()
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    assert tm.kernel_q.dtype == torch.int8 and tm.kernel_q.stride() == (1, 24)
    with torch.no_grad():
        got = tm(_t(x))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    if quant == "int8":
        assert tm.calib_amax.item() == float(state["calib"]["amax"])
        assert "calib_amax" not in tm.state_dict()
        with torch.no_grad():
            tm(_t(x[:1] * 3))
        assert tm.calib_amax.item() == float(np.abs(x[:1] * 3).max())
    else:
        assert not state.get("calib") and "calib_amax" not in tm._buffers


# -- BiLSTM --------------------------------------------------------------------

@pytest.fixture(scope="module")
def lstm_case():
    """Float, dynamic and static JAX BiLSTMs on one float init; the static
    tree is the JAX package's quantiser of the float one with the dynamic
    module's calibration record."""
    rng = np.random.default_rng(0)
    B, L, D, H = 3, 11, 16, 8
    x = (rng.standard_normal((B, L, D)) * 1.5).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[1, 7:] = 0
    mask[2, 4:] = 0
    seg_start = np.zeros((B, L), np.int32)
    seg_start[:, 0] = 1
    seg_start[0, 5] = seg_start[1, 3] = seg_start[1, 8] = 1
    seg_end = np.roll(seg_start, -1, axis=1)
    seg_end[:, -1] = 1
    fvars = jax.device_get(jlstm.BiLSTM(hidden=H).init(
        jax.random.PRNGKey(0), x))
    _, st = jlstm.BiLSTM(hidden=H, quant="int8").apply(
        fvars, x, mutable=["calib"])
    sinit = jax.device_get(jlstm.BiLSTM(hidden=H, quant="int8_static").init(
        jax.random.PRNGKey(0), x))
    svars = {"params": jconvert.static_quantize_params_like(
        sinit["params"], fvars["params"], jax.device_get(st["calib"]))}
    return dict(x=x, mask=mask, seg_start=seg_start, seg_end=seg_end, H=H,
                D=D, vars={"int8": fvars, "int8_static": svars})


@pytest.mark.parametrize("variant", ["padded", "mask", "resets"])
@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_bilstm_int8_matches_jax(lstm_case, quant, variant, monkeypatch):
    """`x_proj` (the int8 input projection plus the input biases, both
    directions, as the recurrence takes it) bit for bit; the output within
    1e-5; "int8" records the JAX `calib` leaf."""
    c = lstm_case
    kw = {"padded": {}, "mask": {"mask": c["mask"]},
          "resets": {"mask": c["mask"], "reset_fwd": c["seg_start"],
                     "reset_bwd": c["seg_end"]}}[variant]
    seen = []
    scan = jlstm._bilstm_scan

    def recording_scan(x_proj, *args, **kwargs):
        seen.append(np.asarray(x_proj))
        return scan(x_proj, *args, **kwargs)

    monkeypatch.setattr(jlstm, "_bilstm_scan", recording_scan)
    jm = jlstm.BiLSTM(hidden=c["H"], quant=quant)
    want, state = jm.apply(c["vars"][quant], c["x"], mutable=["calib"], **kw)
    tm = BiLSTM(c["D"], c["H"], quant=quant, device=CPU).eval()
    tm.load_state_dict(state_dict_from_flax(c["vars"][quant]["params"]),
                       strict=True)
    H4 = 4 * c["H"]
    with torch.no_grad():
        proj = tm.input_projection(_t(c["x"]))
        x_proj = torch.stack([proj[..., :H4] + tm.b_ih_fwd,
                              (proj[..., H4:] + tm.b_ih_bwd).flip(1)])
        got = tm(_t(c["x"]), **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_array_equal(x_proj.numpy(), seen[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    if quant == "int8":
        assert tm.calib_amax.item() == float(state["calib"]["amax"])
    else:
        assert not hasattr(tm, "w_ih_fwd") and tm.w_ih_q.dtype == torch.int8


def test_unknown_quant_modes_raise():
    for make in (lambda q: tlayers.Dense(8, 8, quant=q, device=CPU),
                 lambda q: BiLSTM(8, 8, quant=q, device=CPU)):
        with pytest.raises(ValueError):
            make("int4")


# -- the flagship -------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    """The JAX flagship in fp32, its `quantize_params_like` int8 tree, the
    calibration record of the dynamic model over one batch (with every
    quantised module's input and output), and the
    `static_quantize_params_like` int8-static tree; beside it the port's
    float model on the same weights."""
    cfg = _cfg(masked_lstm=True)
    rng = np.random.default_rng(0)
    init_batch = _batch(cfg, rng)
    fvars = jax.device_get(JaxICKAModel(cfg).init(
        jax.random.PRNGKey(0), init_batch, MASKS, OFFSET, mode="test"))
    dyn = JaxICKAModel(_quant(cfg, "int8"))
    dvars = {"params": jconvert.quantize_params_like(
        _zeros_like_init(dyn, init_batch)["params"], fvars["params"])}
    calib_batch = _batch(cfg, np.random.default_rng(5))
    rec = _Recorder()
    with fnn.intercept_methods(rec):
        _, st = dyn.apply(dvars, calib_batch, MASKS, OFFSET, mode="test",
                          mutable=["calib"])
    calib = jax.device_get(st["calib"])
    static = JaxICKAModel(_quant(cfg, "int8_static"))
    svars = {"params": jconvert.static_quantize_params_like(
        _zeros_like_init(static, init_batch)["params"], fvars["params"],
        calib)}
    tf = _port(cfg)
    tf.load_state_dict(icka_state_dict(fvars), strict=True)
    return dict(cfg=cfg, fvars=fvars, dvars=dvars, svars=svars, calib=calib,
                calib_batch=calib_batch, calib_calls=rec.calls, static=static,
                port_float=tf)


def _port_static(f, dtype=torch.float32):
    ts = _port(_quant(f["cfg"], "int8_static"), dtype)
    ts.load_state_dict(icka_state_dict(f["svars"]), strict=True)
    return ts


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_quantisers_equal_jax(flagship, mode):
    """The port's quantiser on the port's float state_dict against the JAX
    package's on the JAX tree (the same calibration record): every leaf,
    dtype and shape equal. The result loads with strict=True."""
    f = flagship
    tm = _port(_quant(f["cfg"], mode))
    keys = tm.state_dict().keys()
    if mode == "int8":
        got = tconvert.quantize_params_like(keys, f["port_float"].state_dict())
        want = icka_state_dict(f["dvars"])
    else:
        got = tconvert.static_quantize_params_like(
            keys, f["port_float"].state_dict(), calib_from_flax(f["calib"]))
        want = icka_state_dict(f["svars"])
    assert sorted(got) == sorted(want) == sorted(keys)
    n_q = 0
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k
        n_q += w.dtype == torch.int8
    # every projection of 2 + 2 + 3 x 2 layers, and the static BiLSTM
    assert n_q == 10 * 6 + (mode == "int8_static")
    tm.load_state_dict(got, strict=True)


def test_static_quantiser_needs_every_amax(flagship):
    f = flagship
    keys = _port(_quant(f["cfg"], "int8_static")).state_dict().keys()
    calib = calib_from_flax(f["calib"])
    for drop in ("lstm", "txt2img.layer_1.ffn.wo"):
        with pytest.raises(ValueError, match=drop):
            tconvert.static_quantize_params_like(
                keys, f["port_float"].state_dict(),
                {k: v for k, v in calib.items() if k != drop})


def test_calibration_record_matches_jax(flagship):
    """`calibration_amax` of the port's dynamic model against the JAX
    package's "calib" collection: the same 61 module paths, each leaf
    within 1e-6 relative; and every module fed the JAX package's own input
    records its amax bit for bit (and a `Dense` gives its output)."""
    f = flagship
    td = _port(_quant(f["cfg"], "int8"))
    td.load_state_dict(icka_state_dict(f["dvars"]), strict=True)
    with torch.no_grad():
        td({k: _t(v) for k, v in f["calib_batch"].items()}, MASKS, OFFSET,
           mode="test")
    got, want = tconvert.calibration_amax(td), calib_from_flax(f["calib"])
    assert sorted(got) == sorted(want) == sorted(f["calib_calls"])
    assert len(want) == 61 and "lstm" in want
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for path, calls in f["calib_calls"].items():
        module = td.get_submodule(path)
        module.calib_amax.zero_()
        for x, out in calls:
            with torch.no_grad():
                y = module(_t(x))
            if path != "lstm":
                np.testing.assert_array_equal(y.numpy(), out, err_msg=path)
        assert module.calib_amax.item() == float(want[path]), path


def test_static_flagship_matches_jax(flagship):
    """Emissions within 1e-4 and identical tags; every quantised `Dense`
    fed the JAX package's own input gives its output bit for bit."""
    f = flagship
    ts = _port_static(f)
    batch = _batch(f["cfg"], np.random.default_rng(11))
    rec = _Recorder()
    with fnn.intercept_methods(rec):
        want, _ = f["static"].apply(
            f["svars"], method=lambda m, **kw: m.emissions(**kw),
            mask_positions=MASKS, offset=OFFSET, **_inputs(batch))
    want_tags = np.asarray(f["static"].apply(f["svars"], batch, MASKS,
                                             OFFSET, mode="test"))
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        got, _ = ts.emissions(mask_positions=MASKS, offset=OFFSET,
                              **_inputs(tb))
        got_tags = ts(tb, MASKS, OFFSET, mode="test")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(got_tags.numpy(), want_tags)
    n = 0
    for path, calls in rec.calls.items():
        if path == "lstm":
            continue
        module = ts.get_submodule(path)
        for x, out in calls:
            with torch.no_grad():
                np.testing.assert_array_equal(module(_t(x)).numpy(), out,
                                              err_msg=path)
            n += 1
    assert n == 60


def test_static_server_tags_match_jax_server(flagship):
    f = flagship
    exs = _examples(9, np.random.default_rng(13), f["cfg"])
    kw = dict(buckets=(8, MAXL), max_batch=4, offset=OFFSET,
              mask_positions=MASKS)
    want, want_stats = JaxServer(f["static"], f["svars"], **kw).predict(exs)
    got, stats = BucketedICKAServer(_port_static(f), device=CPU,
                                    **kw).predict(exs)
    assert stats.pairs_per_bucket == want_stats.pairs_per_bucket
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_static_forward_packed_matches_jax(flagship):
    """`forward_packed` of the int8-static model: the tags of the JAX
    package's packed server on the same packed batch."""
    f = flagship
    _forward_packed_both(f["static"], f["svars"], _port_static(f), seed=6)


def test_bridge_round_trip_keeps_int8(flagship):
    """state_dict -> flax tree -> state_dict: int8 stays int8 (also from
    the column-major buffers), scales stay 0-d float32, every leaf equal to
    the JAX tree's."""
    f = flagship
    tree = icka_variables_from_state_dict(_port_static(f).state_dict())
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(f["svars"])[0])
    assert len(flat) == len(want)
    for path, leaf in flat:
        w = np.asarray(want[path])
        assert leaf.dtype == (np.int8 if w.dtype == np.int8 else np.float32)
        assert leaf.shape == w.shape and leaf.flags.c_contiguous
        np.testing.assert_array_equal(leaf, w)
    assert tree["params"]["lstm"]["act_scale"].shape == ()
    _port_static(f).load_state_dict(icka_state_dict(tree), strict=True)


# -- bf16 against the JAX package's bf16 ---------------------------------------

@pytest.mark.parametrize("mode", ["none", "int8_static"])
def test_bf16_port_within_jax_bf16_spread(flagship, mode):
    """Both packages in bf16 on the same weights (the float tree, or the
    int8-static one): the port's emissions lie no further from JAX bf16
    than JAX bf16 lies from JAX fp32, and its tags agree with JAX bf16's
    at least as often as JAX bf16's agree with JAX fp32's."""
    f = flagship
    cfg = f["cfg"] if mode == "none" else _quant(f["cfg"], mode)
    variables = f["fvars"] if mode == "none" else f["svars"]
    batch = _batch(f["cfg"], np.random.default_rng(21), B=6)
    valid = batch["output_mask"] > 0

    def jax_run(dtype):
        m = JaxICKAModel(cfg, dtype=dtype)
        em, _ = m.apply(variables, method=lambda mm, **kw: mm.emissions(**kw),
                        mask_positions=MASKS, offset=OFFSET, **_inputs(batch))
        return (np.asarray(em.astype(jnp.float32), np.float64),
                np.asarray(m.apply(variables, batch, MASKS, OFFSET,
                                   mode="test")))

    port = _port(cfg, torch.bfloat16)
    port.load_state_dict(icka_state_dict(variables), strict=True)
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        em, _ = port.emissions(mask_positions=MASKS, offset=OFFSET,
                               **_inputs(tb))
        tags = port(tb, MASKS, OFFSET, mode="test").numpy()
    em = em.float().double().numpy()
    (em32, tags32), (em16, tags16) = jax_run(jnp.float32), \
        jax_run(jnp.bfloat16)
    d_port = np.abs(em - em16)[valid].max()
    d_jax = np.abs(em16 - em32)[valid].max()
    assert d_jax > 0
    assert d_port <= d_jax, (d_port, d_jax)
    agree_port = (tags == tags16)[valid].mean()
    agree_jax = (tags16 == tags32)[valid].mean()
    assert agree_port >= agree_jax, (agree_port, agree_jax)
