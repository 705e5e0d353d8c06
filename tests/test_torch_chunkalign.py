"""ChunkAlign in the PyTorch/CUDA port against the JAX package on the CPU,
at `ChunkAlignConfig.tiny()` and `GPT2Config.tiny()`: the attention core's
scale, tau, neg_type and prior and `GatedCrossAttention` within 1e-5; the
history KV-concat (a masked zero history is the identity, a visible one
changes the output, JAX parity with remat off and on, gradients 1e-4);
`chunk_mean_queries` against a loop; the staged encoder (1e-4) and stage
A's cross-chunk block; `ChunkAlignCLS` scores and losses in train and eval
mode in all three variants (1e-4, identical predictions) and the
gradients of its cls and align losses (1e-4); the rationale decoder's
train losses, its full-recompute `generate` and `generate_rationale` in
greedy, beam (with a `rationale_bonus_mask`) and constrained mode with
ragged prompts (identical tokens); `rationale_bonus_mask` bit-equal.

Each JAX model is initialised once a file, and only as shapes
(`jax.eval_shape`): the weights are the port's (perturbed from their
init, so no LayerNorm or bias is trivial), carried into the JAX tree by
`icka_tpu_torch.convert.vcr_variables_from_state_dict`, whose tree must
equal the JAX model's leaf for leaf in name and shape."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from icka_tpu.generation.constrained import \
    fsm_from_constraints as jfsm_from_constraints  # noqa: E402
from icka_tpu.models import chunkalign as jca  # noqa: E402
from icka_tpu.models.gpt2 import GPT2Config as JGPT2Config  # noqa: E402
from icka_tpu.nn import attention as jatt  # noqa: E402
from icka_tpu_torch.convert import (chunkalign_state_dict,  # noqa: E402
                                    state_dict_from_flax,
                                    vcr_variables_from_state_dict)
from icka_tpu_torch.generation.constrained import \
    fsm_from_constraints  # noqa: E402
from icka_tpu_torch.models import chunkalign as ca  # noqa: E402
from icka_tpu_torch.models.gpt2 import GPT2Config  # noqa: E402
from icka_tpu_torch.nn import attention as att  # noqa: E402

B, C, LI, NUM_CHUNKS, LG = 2, 4, 4, 6, 12


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.copy()).long() if x.dtype.kind in "iu" \
        else torch.from_numpy(x.copy())


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def perturb(model, seed=0, scale=0.05):
    """Every parameter moved by seeded noise, so no LayerNorm scale, bias
    or zero-initialised leaf is trivial."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * scale)
    return model.eval()


def jax_params(model):
    """The port model's weights as the JAX model's variables."""
    return jax.tree.map(jnp.asarray,
                        vcr_variables_from_state_dict(model.state_dict()))


def same_tree(shapes, params):
    """`jax.eval_shape(init)`'s tree against the carried one: the same
    leaves by path, the same shapes."""
    want = {jax.tree_util.keystr(k): v.shape for k, v in
            jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(k): v.shape for k, v in
           jax.tree_util.tree_leaves_with_path(params)}
    assert got == want


def vl_inputs(rng, cfg, rows, regions=LI):
    """Hypotheses with padding at the end of some rows (gather index of a
    padded token: the dead chunk NUM_CHUNKS - 1), two chunks by row,
    block-diagonal chunk visibility, some regions masked."""
    Lh = cfg.max_hypo
    ids = rng.integers(2, cfg.encoder.vocab_size, (rows, Lh)).astype(np.int32)
    img = rng.standard_normal((rows, regions, cfg.img_feature_dim)) \
        .astype(np.float32)
    mask = np.ones((rows, Lh + regions), np.int32)
    lengths = rng.integers(Lh - 3, Lh + 1, rows)
    gidx = np.zeros((rows, Lh), np.int32)
    cm = np.zeros((rows, Lh, Lh), np.int32)
    for r, n in enumerate(lengths):
        mask[r, n:Lh] = 0
        cut = int(rng.integers(2, n - 1))
        gidx[r, cut:n] = 1
        gidx[r, n:] = NUM_CHUNKS - 1
        cm[r, :cut, :cut] = 1
        cm[r, cut:n, cut:n] = 1
    mask[::3, -1] = 0
    return ids, img, mask, cm, gidx


def port_cfgs():
    tcfg, jcfg = ca.ChunkAlignConfig.tiny(), jca.ChunkAlignConfig.tiny()
    tg, jg = GPT2Config.tiny(), JGPT2Config.tiny()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    return tcfg, jcfg, tg, jg


@pytest.fixture(scope="module")
def rationale():
    """One `ChunkAlignRationale` (its `core` is a `ChunkAlignCLS`, whose
    `global_enc` and `seq_enc` serve the encoder tests) and its inputs:
    two questions of four choices, the first choice gold."""
    tcfg, jcfg, tg, jg = port_cfgs()
    rng = np.random.default_rng(1)
    ids, img, mask, cm, gidx = vl_inputs(rng, tcfg, B * C)
    expl = rng.integers(2, tg.vocab_size, (B * C, LG)).astype(np.int32)
    attn = np.ones((B * C, LG), np.int32)
    attn[C:, -3:] = 0
    gpt_labels = np.where(attn > 0, expl, 0).astype(np.int32)
    label = np.zeros((B * C,), np.int32)
    label[::C] = 1
    align_pos = np.zeros((B * C, tcfg.max_hypo), np.int32)
    align_pos[:, [2, 5]] = 1
    total_label = np.zeros((B * C, tcfg.max_hypo), np.int32)
    total_label[:, 2], total_label[:, 5] = 1, 2      # visible regions
    tm = perturb(ca.ChunkAlignRationale(tcfg, gpt2_cfg=tg, device="cpu",
                                        seed=0))
    jm = jca.ChunkAlignRationale(jcfg, gpt2_cfg=jg, pad_token_id=0)
    args = (ids, img, mask, cm, gidx)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), *args, NUM_CHUNKS, expl, attn,
                        label, gpt_labels))
    return dict(tm=tm, jm=jm, jp=jax_params(tm), shapes=shapes, args=args,
                expl=expl, attn=attn, label=label, gpt_labels=gpt_labels,
                align_pos=align_pos, total_label=total_label, tcfg=tcfg,
                jcfg=jcfg, tg=tg)


def test_rationale_tree_is_the_jax_tree(rationale):
    same_tree(rationale["shapes"], rationale["jp"])
    sd = rationale["tm"].state_dict()
    back = chunkalign_state_dict(jax.device_get(rationale["jp"]))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    assert "lm_head.bias" not in sd and "lm_head.weight" in sd


# ---------------------------------------------------------------------------
# the attention core, GatedCrossAttention, the history KV-concat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale,tau,neg_type,prior", [
    (None, 1.0, False, False), (0.3, 0.5, False, False),
    (None, 2.0, True, False), (0.2, 0.7, True, True)])
def test_core_scale_tau_neg_prior(scale, tau, neg_type, prior):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, s, 4, 8)).astype(np.float32)
               for s in (3, 7, 7))
    bias = np.where(rng.random((2, 1, 1, 7)) < 0.3, -10000.0,
                    0.0).astype(np.float32)
    pr = rng.random((2, 4, 3, 7)).astype(np.float32) * 0.1 if prior \
        else None
    want = jatt.dot_product_attention(q, k, v, bias=bias, scale=scale,
                                      tau=tau, neg_type=neg_type, prior=pr)
    got = att.dot_product_attention(
        _t(q), _t(k), _t(v), bias=_t(bias), scale=scale, tau=tau,
        neg_type=neg_type, prior=None if pr is None else _t(pr))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@pytest.fixture(scope="module")
def gated():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, 32)).astype(np.float32)
    kv = rng.standard_normal((3, 9, 32)).astype(np.float32)
    jm = jatt.GatedCrossAttention(32, 8)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), x, kv))
    tm = att.GatedCrossAttention(32, 8, device="cpu")
    tm.load_state_dict(state_dict_from_flax(params["params"]), strict=True)
    return jm, params, perturb(tm, 5), x, kv, rng


@pytest.mark.parametrize("neg_type", [False, True])
def test_gated_cross_attention(gated, neg_type):
    jm, _, tm, x, kv, rng = gated
    params = jax_params(tm)
    bias = np.where(rng.random((3, 1, 1, 9)) < 0.3, -10000.0,
                    0.0).astype(np.float32)
    prior = rng.random((3, 8, 1, 9)).astype(np.float32) * 0.1
    want = jm.apply(params, x, kv=kv, bias=bias, tau=0.6, neg_type=neg_type,
                    prior=prior)
    with torch.no_grad():
        got = tm(_t(x), kv=_t(kv), bias=_t(bias), tau=0.6, neg_type=neg_type,
                 prior=_t(prior))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    with torch.no_grad():
        self_att = tm(_t(kv))
    np.testing.assert_allclose(_np(self_att), np.asarray(jm.apply(params, kv)),
                               atol=1e-5)


def _history(rng, cfg, rows, Sh=3):
    H = cfg.encoder.hidden_size
    hist = [rng.standard_normal((rows, Sh, H)).astype(np.float32)
            for _ in range(cfg.encoder.num_hidden_layers)]
    hist[1] = None                                 # an entry may be None
    hmask = np.ones((rows, Sh), np.int32)
    hmask[0, -1] = 0
    return hist, hmask


def _global_enc(rationale, remat=False, use_pallas=False):
    """The rationale's global encoder as its own port and JAX modules."""
    tcfg, jcfg = rationale["tcfg"], rationale["jcfg"]
    if remat or use_pallas:
        tcfg = dataclasses.replace(tcfg, encoder=dataclasses.replace(
            tcfg.encoder, remat=remat, use_pallas=use_pallas))
        jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
            jcfg.encoder, remat=remat))
    tm = ca.GlobalVLEncoder(tcfg, device="cpu").eval()
    tm.load_state_dict(rationale["tm"].core.global_enc.state_dict(),
                       strict=True)
    return tm, jca.GlobalVLEncoder(jcfg), \
        {"params": rationale["jp"]["params"]["core"]["global_enc"]}


def test_history_masked_zeros_are_the_identity(rationale):
    tm, _, _ = _global_enc(rationale, use_pallas=True)
    ids, img, mask = rationale["args"][:3]
    H = rationale["tcfg"].encoder.hidden_size
    n = rationale["tcfg"].encoder.num_hidden_layers
    with torch.no_grad():
        seq, cls = tm(_t(ids), _t(img), _t(mask))
        hist = [torch.zeros(B * C, 3, H)] * n
        seq0, cls0 = tm(_t(ids), _t(img), _t(mask), history_states=hist,
                        history_mask=torch.zeros(B * C, 3, dtype=torch.long))
        seen, _ = tm(_t(ids), _t(img), _t(mask),
                     history_states=[torch.randn(B * C, 3, H)] * n,
                     history_mask=torch.ones(B * C, 3, dtype=torch.long))
    np.testing.assert_allclose(_np(seq0), _np(seq), atol=1e-5)
    np.testing.assert_allclose(_np(cls0), _np(cls), atol=1e-5)
    assert not np.allclose(_np(seen), _np(seq), atol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_history_equals_jax(rationale, remat):
    """Forward with a ragged history mask and a None entry, then (remat on)
    the gradients of every parameter and of the history against the plain
    stack's."""
    tm, jm, params = _global_enc(rationale, remat=remat)
    ids, img, mask = rationale["args"][:3]
    hist, hmask = _history(np.random.default_rng(6), rationale["tcfg"],
                           B * C)
    want_seq, want_cls = jax.jit(lambda p, h: jm.apply(
        p, ids, img, mask, history_states=h, history_mask=hmask))(
            params, hist)
    th = [None if h is None else _t(h).requires_grad_() for h in hist]
    seq, cls = tm(_t(ids), _t(img), _t(mask), history_states=th,
                  history_mask=_t(hmask))
    np.testing.assert_allclose(_np(seq), np.asarray(want_seq), atol=1e-4)
    np.testing.assert_allclose(_np(cls), np.asarray(want_cls), atol=1e-4)
    # through K1's CPU path (Sq = 14 < Sk = 17) as through the plain core
    tk, _, _ = _global_enc(rationale, use_pallas=True)
    with torch.no_grad():
        kseq, _ = tk(_t(ids), _t(img), _t(mask), history_states=th,
                     history_mask=_t(hmask))
    np.testing.assert_allclose(_np(kseq), _np(seq), atol=1e-5)
    if not remat:
        return
    # remat carries the history into its recompute: the gradients of every
    # parameter and of each history entry are the plain stack's
    plain, _, _ = _global_enc(rationale)
    ph = [None if h is None else _t(h).requires_grad_() for h in hist]
    pseq, pcls = plain(_t(ids), _t(img), _t(mask), history_states=ph,
                       history_mask=_t(hmask))
    for model, s, c in ((tm, seq, cls), (plain, pseq, pcls)):
        ((s ** 2).sum() * 1e-3 + c.sum()).backward()
    want = dict(plain.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(want[name].grad),
                                   atol=1e-6, err_msg=name)
    for got, w in zip(th, ph):
        if got is not None:
            np.testing.assert_allclose(_np(got.grad), _np(w.grad), atol=1e-6)
            assert got.grad.abs().max() > 0


def test_history_refused_on_fused_qkv():
    cfg = dataclasses.replace(ca.ChunkAlignConfig.tiny().encoder,
                              fuse_qkv=True)
    layer = att.SelfAttentionLayer(cfg, device="cpu")
    x = torch.zeros(1, 3, cfg.hidden_size)
    layer(x)
    with pytest.raises(ValueError, match="fused qkv"):
        layer(x, history=torch.zeros(1, 2, cfg.hidden_size))


# ---------------------------------------------------------------------------
# chunk-mean queries, the staged encoder, binary_to_mp
# ---------------------------------------------------------------------------

def test_chunk_mean_queries_matches_loop_and_jax():
    rng = np.random.default_rng(0)
    Bq, L, D, Cn = 2, 6, 4, 3
    q = rng.standard_normal((Bq, L, D)).astype(np.float32)
    gidx = np.array([[0, 0, 1, 2, 2, 2], [1, 1, 1, 0, 0, 2]], np.int32)
    mask = np.ones((Bq, L), np.int32)
    mask[1, 5] = 0                                   # padding token
    got = _np(ca.chunk_mean_queries(_t(q), _t(gidx), _t(mask), Cn))
    for b in range(Bq):
        for i in range(L):
            members = [j for j in range(L)
                       if gidx[b, j] == gidx[b, i] and mask[b, j]]
            want = q[b, members].mean(0) if mask[b, i] else q[b, i]
            np.testing.assert_allclose(got[b, i], want, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jca.chunk_mean_queries(
        q, gidx, mask, Cn)), atol=1e-6)
    # an id outside [0, num_chunks) selects no chunk, as jax.nn.one_hot
    gidx[0, 0] = Cn
    np.testing.assert_allclose(
        _np(ca.chunk_mean_queries(_t(q), _t(gidx), _t(mask), Cn)),
        np.asarray(jca.chunk_mean_queries(q, gidx, mask, Cn)), atol=1e-6)


@pytest.mark.parametrize("variant", ["default", "local_residual",
                                     "no_cross_modal"])
def test_staged_encoder_equals_jax(rationale, variant):
    tcfg, jcfg = rationale["tcfg"], rationale["jcfg"]
    kw = {"default": {},
          "local_residual": dict(add_local_residual=True,
                                 add_residual=False),
          "no_cross_modal": dict(cross_chunk_layers=(1, 2, 3, 4, 5),
                                 cross_modal_layers=())}[variant]
    tm = ca.StagedVLEncoder(dataclasses.replace(tcfg, **kw),
                            device="cpu").eval()
    tm.load_state_dict(rationale["tm"].core.seq_enc.state_dict(),
                       strict=True)
    jm = jca.StagedVLEncoder(dataclasses.replace(jcfg, **kw))
    args = rationale["args"]
    want = jax.jit(lambda p: jm.apply(p, *args, NUM_CHUNKS))(
        {"params": rationale["jp"]["params"]["core"]["seq_enc"]})
    with torch.no_grad():
        got = tm(*map(_t, args), NUM_CHUNKS)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4)
    if variant == "no_cross_modal":
        assert not got[2].any()


def test_stage_a_blocks_cross_chunk():
    """One chunk-stage layer: chunk 0's tokens do not see chunk 1's."""
    cfg = ca.ChunkAlignConfig.tiny()
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, num_hidden_layers=1),
        chunk_layers=(0,), cross_chunk_layers=(), cross_modal_layers=())
    tm = perturb(ca.StagedVLEncoder(cfg, device="cpu", seed=2))
    Lh, half = cfg.max_hypo, cfg.max_hypo // 2
    ids = np.random.default_rng(0).integers(1, 64, (1, Lh))
    img = torch.randn(1, 5, cfg.img_feature_dim,
                      generator=torch.Generator().manual_seed(0))
    mask = torch.ones(1, Lh + 5, dtype=torch.long)
    cm = torch.zeros(1, Lh, Lh, dtype=torch.long)
    cm[:, :half, :half] = cm[:, half:, half:] = 1
    gidx = (torch.arange(Lh) >= half).long()[None]
    ids2 = ids.copy()
    ids2[0, -1] = ids2[0, -1] % 63 + 1
    with torch.no_grad():
        a = tm(_t(ids), img, mask, cm, gidx, 4)[0]
        b = tm(_t(ids2), img, mask, cm, gidx, 4)[0]
    np.testing.assert_allclose(_np(a[0, :half]), _np(b[0, :half]), atol=1e-6)
    assert not np.allclose(_np(a[0, half:Lh]), _np(b[0, half:Lh]))


def test_binary_to_mp():
    logits = np.random.default_rng(0).standard_normal((8, 2)) \
        .astype(np.float32)
    got = _np(ca.binary_to_mp(_t(logits), 4))
    np.testing.assert_allclose(got, np.asarray(jca.binary_to_mp(logits, 4)),
                               atol=1e-7)
    assert got.shape == (2, 4)


# ---------------------------------------------------------------------------
# ChunkAlignCLS
# ---------------------------------------------------------------------------

# the variants, and a depth of one layer per stage (the gradients: XLA's
# compile of the backward grows with the depth)
CLS_VARIANTS = {"full": {}, "wo_chual": dict(use_chunk_align=False),
                "wo_reasoning": dict(use_reasoning=False),
                "depth3": dict(chunk_layers=(0,), cross_chunk_layers=(1,),
                               cross_modal_layers=(2,))}


def _cls_models(rationale, variant):
    kw = dict(CLS_VARIANTS[variant])
    tcfg, jcfg = rationale["tcfg"], rationale["jcfg"]
    if variant == "depth3":
        tcfg, jcfg = (dataclasses.replace(c, encoder=dataclasses.replace(
            c.encoder, num_hidden_layers=3)) for c in (tcfg, jcfg))
    tm = ca.ChunkAlignCLS(dataclasses.replace(tcfg, **kw),
                          device="cpu").eval()
    full = rationale["tm"].core.state_dict()
    names = tm.state_dict().keys()
    tm.load_state_dict({k: full[k] for k in names}, strict=True)
    return tm, jca.ChunkAlignCLS(dataclasses.replace(jcfg, **kw))


@pytest.mark.parametrize("variant", ["full", "wo_chual", "wo_reasoning"])
def test_chunkalign_cls_equals_jax(rationale, variant):
    r = rationale
    tm, jm = _cls_models(rationale, variant)
    params = jax_params(tm)
    same_tree(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *r["args"], NUM_CHUNKS)), params)
    sup = (r["label"], r["align_pos"], r["total_label"])
    want_train, (want_pred, want_scores) = jax.jit(lambda p: (
        jm.apply(p, *r["args"], NUM_CHUNKS, label=sup[0], align_pos=sup[1],
                 total_label=sup[2]),
        jm.apply(p, *r["args"], NUM_CHUNKS)))(params)
    with torch.no_grad():
        got_train = tm(*map(_t, r["args"]), NUM_CHUNKS,
                       *map(_t, sup))
        pred, scores = tm(*map(_t, r["args"]), NUM_CHUNKS)
    np.testing.assert_allclose(_np(scores), np.asarray(want_scores),
                               atol=1e-4)
    np.testing.assert_array_equal(_np(pred), np.asarray(want_pred))
    for g, w in zip(got_train, want_train):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4)
    if variant != "wo_chual":
        assert float(got_train[4]) == 2 * B * C


def test_chunkalign_cls_gradients(rationale):
    """Gradients of cls_loss + align_loss by every parameter, one layer of
    each stage (the staged encoder's reach the align loss through its
    probabilities), and the losses themselves."""
    r = rationale
    tm, jm = _cls_models(rationale, "depth3")
    sup = dict(label=r["label"], align_pos=r["align_pos"],
               total_label=r["total_label"])

    def loss(p):
        train = jm.apply(p, *r["args"], NUM_CHUNKS, **sup)
        return train[0] + train[2], train
    (_, want_train), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax_params(tm))
    want = state_dict_from_flax(jax.device_get(g)["params"])
    train = tm(*map(_t, r["args"]), NUM_CHUNKS,
               *map(_t, sup.values()))
    (train[0] + train[2]).backward()
    for got, w in zip(train, want_train):
        np.testing.assert_allclose(_np(got), np.asarray(w), atol=1e-4)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), want[name].numpy(),
                                   atol=1e-4, err_msg=name)
    assert tm.seq_enc.layer_2.attn.query.weight.grad.abs().max() > 0


# ---------------------------------------------------------------------------
# the rationale decoder
# ---------------------------------------------------------------------------

def test_rationale_train_losses_equal_jax(rationale):
    r = rationale
    tail = (r["expl"], r["attn"], r["label"], r["gpt_labels"])
    want = jax.jit(lambda p: r["jm"].apply(p, *r["args"], NUM_CHUNKS,
                                           *tail))(r["jp"])
    with torch.no_grad():
        got = r["tm"](*map(_t, r["args"]), NUM_CHUNKS, *map(_t, tail))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4)
    assert float(got[0]) > 0 and float(got[1]) > 0


def _enc_inputs(r, torch_side):
    f = _t if torch_side else (lambda x: x)
    names = ("input_ids", "img_feats", "input_mask", "chunk_mask",
             "gather_index")
    return dict(zip(names, map(f, r["args"])), num_chunks=NUM_CHUNKS)


def _prompt(r, Lp=4, seed=7):
    return np.random.default_rng(seed).integers(
        2, r["tg"].vocab_size, (B, Lp)).astype(np.int32)


def test_rationale_generate_equals_jax(rationale):
    r = rationale
    prompt = _prompt(r)
    want, want_pred = jax.jit(lambda p: r["jm"].apply(
        p, *r["args"], NUM_CHUNKS, prompt, max_gen_len=6, eos_id=1,
        method=jca.ChunkAlignRationale.generate))(r["jp"])
    got, pred = r["tm"].generate(*map(_t, r["args"]), NUM_CHUNKS, prompt,
                                 max_gen_len=6, eos_id=1)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(pred), np.asarray(want_pred))
    # the cached greedy engine emits the full recompute's tokens
    cached, pred_c = ca.generate_rationale(
        r["tm"], _enc_inputs(r, True), prompt, prompt_len=4, max_gen_len=6,
        mode="greedy", eos_id=1)
    np.testing.assert_array_equal(_np(cached), _np(got))
    np.testing.assert_array_equal(_np(pred_c), _np(pred))


@pytest.mark.parametrize("mode", ["greedy", "beam", "constrained"])
def test_generate_rationale_equals_jax(rationale, mode):
    """Ragged prompts (lengths 5 and 3) in every mode; beam with the bonus
    mask of the predicted rows' CLS attention; constrained over a one-token
    and a two-token word."""
    r = rationale
    prompt = _prompt(r, 5, seed=8)
    plen = np.array([5, 3], np.int32)
    kw = dict(prompt_len=plen, max_gen_len=5, mode=mode, eos_id=1)
    tkw, jkw = dict(kw), dict(kw)
    if mode == "beam":
        pred, _, _, cls_attn = r["tm"].encode_for_generation(
            **_enc_inputs(r, True))
        hypo = ca.choose_row(_t(r["args"][0]), pred, C)
        mask = ca.rationale_bonus_mask(
            _np(cls_attn), _np(hypo), r["tg"].vocab_size,
            np.arange(r["tcfg"].encoder.vocab_size), stop_ids=(2, 3))
        assert mask.any()
        tkw.update(num_beams=3, bonus_mask=mask, bonus_factor=0.5,
                   length_penalty=0.8)
        jkw.update(num_beams=3, bonus_mask=jnp.asarray(mask),
                   bonus_factor=0.5, length_penalty=0.8)
    if mode == "constrained":
        words = [[5], [7, 8]]
        tkw.update(fsm=fsm_from_constraints(words, r["tg"].vocab_size))
        jkw.update(fsm=jfsm_from_constraints(words, r["tg"].vocab_size))
    want, want_pred = jca.generate_rationale(
        r["jm"], r["jp"], _enc_inputs(r, False), jnp.asarray(prompt), **jkw)
    got, pred = ca.generate_rationale(r["tm"], _enc_inputs(r, True), prompt,
                                      **tkw)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(pred), np.asarray(want_pred))
    np.testing.assert_array_equal(_np(got)[0, :5], prompt[0])
    np.testing.assert_array_equal(_np(got)[1, :3], prompt[1, :3])


def test_rationale_bonus_mask_bit_equal():
    attn = np.array([[0.1, 0.5, 0.2, 0.05, 0.1, 0.05] * 3])   # k = 3 copies
    ids = np.array([[9, 4, 5, 6, 7, 8, 3]])                    # CLS + 6
    m = ca.rationale_bonus_mask(attn, ids, 120, np.arange(16) + 100,
                                stop_ids=(5,), top_frac=0.4)
    assert m.shape == (1, 120) and m[0, 106] and m.sum() == 1
    rng = np.random.default_rng(9)
    attn = rng.random((3, 2 * 9)).astype(np.float32)
    ids = rng.integers(0, 40, (3, 10))
    mapping = np.where(rng.random(40) < 0.2, -1, rng.integers(0, 30, 40))
    for frac in (0.3, 0.5, 1.0):
        np.testing.assert_array_equal(
            ca.rationale_bonus_mask(attn, ids, 30, mapping, (4, 7), frac),
            jca.rationale_bonus_mask(attn, ids, 30, mapping, (4, 7), frac))
