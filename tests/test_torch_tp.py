"""The compute-sharded layers over the "model" axis (`repro_torch.models.tp`
and the `*_tp` layers) against the port's whole layers, at T = 1, 2 and 4
model shards held in one process (each shard computed in turn and the
shards' partials added in shard order, the arithmetic a process of a
spread model group does).

Inputs are made with numpy from a seed, at f32 and small widths; each
case compares the forward and the gradients of every input and every
parameter leaf (the whole leaf's gradient is the shards' put together).
Tolerances, each with its reason:

- the embedding: bitwise at every T (one shard holds each id, the others
  add zeros), forward and gradient;
- at T = 1, the forward of every operator bitwise to the whole layer (one
  partial, summed in f32, is itself), and the gradients of the linears,
  the MLPs, the embedding and the attention too; the CE's gradient goes
  through exp and log where the whole layer's `logsumexp` has its own
  backward, so it is held to the tolerance below;
- the linears, the MLPs and both CE forms (a padded vocab): rtol 1e-5,
  atol 1e-6 of the output's scale (the shards' partial sums add in
  another order than one matmul's);
- attention (cases a, b and c, with RoPE and M-RoPE), the encoder-
  decoder's cross-attention, hymba's mixer (case c) and the MoE FFN with
  and without the shared expert: the forward to rtol 1e-5 (atol 1e-6 of
  its scale), each gradient within 1e-2 of the leaf's largest entry. The
  attention rounds its probabilities and values (and their cotangents)
  to bf16 as the reference does, so a last-bit f32 difference that
  crosses a rounding boundary moves that element by 2^-8 of itself, as
  tests/test_torch_models.py allows between the frameworks. The worst
  measured error is in the assertion message;
- rwkv6's time mix (no bf16 rounding): forward and gradients to rtol
  1e-5, atol 1e-6 of each one's scale; at T = 1 the forward bitwise.

Then the rules the train step reads: every family computes by shard,
the attention case of each config at T = 2, 4, 8 and 16, that no
family's step takes shards of a whole gradient or puts together any
leaf but those its layers name, and that a layer whose leaf the spec
splits elsewhere raises rather than gathering quietly.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro_torch.configs import get_config, reduced
from repro_torch.core.api import tree_flatten, tree_leaves
from repro_torch.launch import sharding, steps
from repro_torch.launch.distributed import StackedCollective
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers, mixers, moe, tp, transformer
from repro_torch.core.dist import CompressedAggregation

B, S, D = 2, 8, 32
TS = (1, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _t(*shape, scale=1.0, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def _ms(t, tree):
    return tp.ModelShards(t, axes=sharding.split_axes(tree, t))


def _grads(fn, tree, x_names=()):
    """(output, gradients of every leaf of `tree`) of sum(out * probe)."""
    leaves, unflatten = tree_flatten(tree)
    req = [v.detach().clone().requires_grad_(v.is_floating_point())
           for v in leaves]
    out = fn(unflatten(req))
    probe = _t(*out.shape, seed=7)
    grads = torch.autograd.grad(torch.sum(out * probe),
                                [r for r in req if r.requires_grad])
    return out.detach(), grads


def _hold(got, want, *, bitwise=False, rtol=1e-5, grad_tol=None,
          grads_bitwise=None, what=""):
    """got/want: (out, grads). Forward bitwise or to rtol (atol 1e-6 of
    its scale); gradients bitwise (`grads_bitwise`, default `bitwise`),
    to rtol, or within `grad_tol` of each leaf's largest entry."""
    (go, gg), (wo, wg) = got, want
    if bitwise:
        assert torch.equal(go, wo), f"{what} forward"
    else:
        torch.testing.assert_close(go, wo, rtol=rtol,
                                   atol=1e-6 * float(wo.abs().max()),
                                   msg=lambda m: f"{what} forward: {m}")
    grads_bitwise = bitwise if grads_bitwise is None else grads_bitwise
    assert len(gg) == len(wg)
    for i, (a, b) in enumerate(zip(gg, wg)):
        if grads_bitwise:
            assert torch.equal(a, b), f"{what} grad {i}"
        elif grad_tol is not None:
            err = float((a - b).abs().max())
            bound = grad_tol * float(b.abs().max()) + 1e-7
            assert err <= bound, f"{what} grad {i}: {err} > {bound}"
        else:
            torch.testing.assert_close(a, b, rtol=rtol,
                                       atol=1e-6 * float(b.abs().max()),
                                       msg=lambda m: f"{what} grad {i}: {m}")


# -- the linears, the MLPs, the embedding and the CE -----------------------------

@pytest.mark.parametrize("t", TS)
def test_column_and_row_parallel_linear(t):
    """Column-parallel x @ wq + bq (the shards' outputs put together) and
    row-parallel h @ wo (each shard's columns of h times its rows of wo,
    the partials summed)."""
    tree = {"x": _t(B, S, D), "wq": _t(D, 16, scale=0.2), "bq": _t(16),
            "h": _t(B, S, 16), "wo": _t(16, D, scale=0.2)}
    axes = sharding.split_axes({"wq": tree["wq"], "bq": tree["bq"],
                                "wo": tree["wo"]}, t)
    assert axes == (0, 0, 1)  # bq, wo, wq in sorted order

    def col(p):
        ms = _ms(t, {"wq": p["wq"], "bq": p["bq"]})
        sp = ms.split({"wq": p["wq"], "bq": p["bq"]})
        out = layers.linear_col(tp.to_shards(p["x"], ms), sp["wq"], sp["bq"],
                                "wq")
        return (torch.cat(out.unbind(0), dim=-1)  # (T, ...) stacked shards
                + 0 * (p["h"].sum() + p["wo"].sum()))

    def row(p):
        ms = _ms(t, {"wo": p["wo"]})
        sp = ms.split({"wo": p["wo"]})
        hs = torch.chunk(p["h"], t, dim=-1)
        return (layers.linear_row(hs, sp["wo"], ms, "wo")
                + 0 * (p["x"].sum() + p["wq"].sum() + p["bq"].sum()))

    def whole_col(p):
        return (layers.linear(p["x"], p["wq"], p["bq"])
                + 0 * (p["h"].sum() + p["wo"].sum()))

    def whole_row(p):
        return (layers.linear(p["h"], p["wo"])
                + 0 * (p["x"].sum() + p["wq"].sum() + p["bq"].sum()))

    _hold(_grads(col, tree), _grads(whole_col, tree), bitwise=t == 1,
          what="column")
    _hold(_grads(row, tree), _grads(whole_row, tree), bitwise=t == 1,
          what="row")


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(t, act):
    """`mlp` on the d_ff shards (gelu with b_up and b_down) against the
    whole `mlp`."""
    f = 64
    p = {"w_up": _t(D, f, scale=0.2), "w_down": _t(f, D, scale=0.2)}
    if act == "swiglu":
        p["w_gate"] = _t(D, f, scale=0.2, seed=1)
    else:
        p["b_up"], p["b_down"] = _t(f, seed=2), _t(D, seed=3)
    tree = {"p": p, "x": _t(B, S, D)}

    def by_shard(q):
        ms = _ms(t, q["p"])
        return layers.mlp(q["x"], ms.split(q["p"]), act, ms)

    got = _grads(by_shard, tree)
    want = _grads(lambda q: layers.mlp(q["x"], q["p"], act), tree)
    _hold(got, want, bitwise=t == 1, what=f"{act} mlp")


@pytest.mark.parametrize("t", TS)
def test_vocab_parallel_embedding_is_bitwise(t):
    """Each shard's rows looked up, zeros elsewhere, summed: the whole
    lookup's bits, and its gradient's, at every T (ids at every shard's
    edges, repeated ids)."""
    vp = 512
    table = _t(vp, D, scale=0.02)
    ids = torch.tensor([[0, 1, 127, 128, 255, 256, 383, 384],
                        [511, 502, 128, 128, 0, 384, 255, 7]])

    def by_shard(q):
        ms = _ms(t, {"embed": q["embed"]})
        return layers.embed_tokens_tp(ids, ms.split(q)["embed"], ms)

    tree = {"embed": table}
    _hold(_grads(by_shard, tree),
          _grads(lambda q: layers.embed_tokens(ids, q["embed"]), tree),
          bitwise=True, what="embedding")


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("ce", ["gather", "streaming"])
def test_vocab_parallel_ce(t, ce):
    """The vocab-parallel CE (503 true ids of a 512-row table, so the last
    shard holds pad rows) against the whole head and either CE form:
    `token_nll` over `lm_logits` ("gather") and `_streaming_ce` over the
    unmasked logits ("streaming"). Labels at the shards' edges."""
    true_vocab, vp = 503, 512
    tree = {"lm_head": _t(vp, D, scale=0.2), "x": _t(B, S, D)}
    labels = torch.tensor([[0, 127, 128, 255, 256, 383, 384, 502],
                           [501, 1, 2, 300, 129, 450, 64, 502]])

    def by_shard(q):
        ms = _ms(t, {"lm_head": q["lm_head"]})
        table = ms.split({"lm_head": q["lm_head"]})["lm_head"]
        return layers.vocab_parallel_nll(q["x"], table, labels, true_vocab,
                                         ms)

    def whole(q):
        if ce == "streaming":
            return transformer._streaming_ce(q["x"] @ q["lm_head"].t(),
                                             labels, true_vocab)
        return layers.token_nll(layers.lm_logits(q["x"], q["lm_head"],
                                                 true_vocab),
                                labels, true_vocab)

    _hold(_grads(by_shard, tree), _grads(whole, tree), bitwise=False,
          what=f"{ce} CE")
    if t == 1:  # the forward is logsumexp's own arithmetic
        assert torch.equal(_grads(by_shard, tree)[0], _grads(whole, tree)[0])


# -- attention, by case ------------------------------------------------------------

ATTN_CASES = [  # (heads, kv heads, head_dim, T, M-RoPE, qkv bias, case)
    (4, 4, 8, 1, False, True, "a"),
    (4, 4, 8, 2, False, True, "a"),
    (4, 2, 8, 2, True, False, "a"),
    (8, 4, 8, 4, False, True, "a"),
    (4, 2, 8, 4, False, True, "b"),
    (4, 1, 8, 2, False, True, "b"),
    (4, 2, 32, 4, True, True, "b"),
    (3, 1, 8, 2, False, True, "c"),
    (3, 3, 8, 2, True, False, "c"),
    (6, 2, 8, 4, False, True, "c"),
]


def _attn_cfg(h, kh, hd, mrope, bias):
    base = reduced(get_config("qwen2-vl-2b" if mrope else "qwen2.5-32b"),
                   seq=S)
    return dataclasses.replace(
        base, num_heads=h, num_kv_heads=kh, head_dim=hd, d_model=D,
        dtype=torch.float32, qkv_bias=bias,
        mrope_sections=(4, 6, 6) if hd == 32 and mrope else
        ((1, 1, 2) if mrope else None))


@pytest.mark.parametrize("h,kh,hd,t,mrope,bias,case", ATTN_CASES)
def test_attention_cases(h, kh, hd, t, mrope, bias, case):
    """`attention_train_tp` against `attention_train`, causal with RoPE
    (or M-RoPE's three position streams), in each attention case."""
    cfg = _attn_cfg(h, kh, hd, mrope, bias)
    assert tp.attention_case(h, kh, t) == case
    gen = torch.Generator().manual_seed(h * 100 + kh * 10 + t)
    p = mixers.init_attention(gen, cfg, "cpu")
    if bias:
        p = {k: v if not k.startswith("b") else _t(*v.shape, scale=0.1)
             for k, v in p.items()}
    positions = (transformer.mrope_positions(
        dataclasses.replace(cfg, vision_patches=4), S, B)
        if mrope else torch.arange(S).expand(B, S))
    tree = {"p": p, "x": _t(B, S, D)}

    def by_shard(q):
        ms = _ms(t, q["p"])
        return mixers.attention_train_tp(ms.split(q["p"]), q["x"], cfg, ms,
                                         positions=positions)

    def whole(q):
        return mixers.attention_train(q["p"], q["x"], cfg,
                                      positions=positions)

    _hold(_grads(by_shard, tree), _grads(whole, tree), bitwise=t == 1,
          grad_tol=1e-2, what=f"attention case {case} T={t}")


# -- the MoE FFN -----------------------------------------------------------------------

@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("shared", [False, True, "gelu-bias"])
def test_moe_ffn(t, shared):
    """`moe_ffn_tp` (the routing on every shard, each shard its d_ff
    shard of every expert, the shared expert's partial added) against
    `moe_ffn`; "gelu-bias": gelu experts and a shared expert with up and
    down biases (the down bias whole, added once after the shards' sum).
    The routing margins are checked first (a near-tie would flip an
    expert on a last-bit difference)."""
    cfg = dataclasses.replace(
        reduced(get_config("qwen2-moe-a2.7b"), seq=S), d_model=D,
        dtype=torch.float32, shared_expert_ff=64 if shared else 0)
    if shared == "gelu-bias":
        cfg = dataclasses.replace(cfg, act="gelu")
    gen = torch.Generator().manual_seed(11)
    p = moe.init_moe(gen, cfg, "cpu")
    if shared == "gelu-bias":
        del p["w_gate"]  # gelu experts have no gate
        p["shared"] = dict(p["shared"], b_up=_t(64, scale=0.1, seed=1),
                           b_down=_t(D, scale=0.1, seed=2))
    x = _t(B, S, D)
    probs, _, _ = moe._route(p, x, cfg)
    top = torch.sort(probs, dim=-1, descending=True).values
    k = cfg.experts_per_token
    assert float((top[..., k - 1] - top[..., k]).min()) > 1e-4
    tree = {"p": p, "x": x}

    def by_shard(q):
        ms = _ms(t, q["p"])
        return moe.moe_ffn_tp(ms.split(q["p"]), q["x"], cfg, ms)

    _hold(_grads(by_shard, tree),
          _grads(lambda q: moe.moe_ffn(q["p"], q["x"], cfg), tree),
          bitwise=False, grad_tol=1e-2 if t > 1 else None,
          what=f"moe shared={shared} T={t}")


# -- the mixers of the ssm, hybrid and audio families --------------------------------

def _rand(p, seed=0):
    """Every leaf of a mixer's parameters drawn afresh (the constant
    initial `mu`, `w0`, `ln_out`, `ln`, `a_log` and zero biases would hide
    a leaf taken from the wrong shard): mu in (0, 1), the norms' scales
    about 1, w0 about -2, the rest normal at the leaf's spread."""
    out = {}
    for i, (k, v) in enumerate(sorted(p.items())):
        if isinstance(v, dict):
            out[k] = _rand(v, seed + 10 * i)
            continue
        shape = tuple(v.shape)
        x = _t(*shape, seed=seed + i)
        if k == "mu":
            x = torch.sigmoid(x)
        elif k in ("ln_out", "ln", "ln_attn"):
            x = 1 + 0.1 * x
        elif k == "w0":
            x = -2 + 0.3 * x
        elif k == "a_log":
            x = 0.2 * x
        else:
            x = x * (float(v.std()) if v.numel() > 1 and float(v.std()) > 0
                     else 0.1)
        out[k] = x
    return out


def _mixer_cfg(arch, **changes):
    changes = {"d_model": D, "dtype": torch.float32, **changes}
    return dataclasses.replace(reduced(get_config(arch), seq=S), **changes)


@pytest.mark.parametrize("t", TS)
def test_rwkv6_time_mix(t):
    """`rwkv6_train_tp` against `rwkv6_train` (4 heads of 8, two chunks of
    the linear attention): the five mixes on `mu` put together, the
    column-parallel projections, the decay LoRA's f32 partials summed over
    the model axis and cut to each shard's heads with its slice of w0,
    the linear attention shard by shard with its heads' bonus, the group
    norm by heads, wo row-parallel."""
    cfg = _mixer_cfg("rwkv6-7b", num_heads=4, num_kv_heads=4, head_dim=8)
    p = _rand(mixers.init_rwkv6(torch.Generator().manual_seed(3), cfg,
                                "cpu"))
    tree = {"p": p, "x": _t(B, 128, D)}

    def by_shard(q):
        ms = _ms(t, q["p"])
        return mixers.rwkv6_train_tp(ms.split(q["p"]), q["x"], cfg, ms)

    got = _grads(by_shard, tree)
    want = _grads(lambda q: mixers.rwkv6_train(q["p"], q["x"], cfg), tree)
    if t == 1:
        assert torch.equal(got[0], want[0])
    _hold(got, want, bitwise=False, what=f"rwkv6 T={t}")


@pytest.mark.parametrize("t", TS)
def test_rwkv6_decay_reduction(t):
    """The decay alone: `rwkv6_train_tp`'s log-decay (each shard's heads,
    from the summed f32 LoRA partials) against `_rwkv6_streams`', read off
    the linear attention's inputs (one call a shard, their heads put
    together), to rtol 1e-6 (the f32 sum of T partial rank-64 / T products
    in shard order against one rank-64 product), bitwise at T = 1."""
    cfg = _mixer_cfg("rwkv6-7b", num_heads=4, num_kv_heads=4, head_dim=8)
    p = _rand(mixers.init_rwkv6(torch.Generator().manual_seed(4), cfg,
                                "cpu"))
    x = _t(B, S, D, seed=5)
    seen = []
    real = mixers.chunked_linear_attention

    def spy(r, k, v, ld, **kw):
        seen.append(ld)
        return real(r, k, v, ld, **kw)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(mixers, "chunked_linear_attention", spy)
        ms = _ms(t, p)
        mixers.rwkv6_train_tp(ms.split(p), x, cfg, ms)
    x_prev = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
    want = mixers._rwkv6_streams(p, x, x_prev, cfg)[4]
    got = torch.cat(seen, dim=2)
    assert len(seen) == t
    if t == 1:
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("t", TS)
def test_hymba_mixer_case_c(t):
    """`hymba_train_tp` against `hymba_train` at 5 heads of 8 (one kv
    head, 5 SSD heads): at T = 2 and 4 the spec splits wq, wk, wv, wx and
    wbc mid-head and ln, ln_attn on their last axis, and leaves wdt and
    a_log whole; every split leaf is put together once, both head groups
    and the fuse computed once, each shard's rows of the fused output
    through its rows of wo_fused."""
    cfg = _mixer_cfg("hymba-1.5b", num_heads=5, num_kv_heads=1, head_dim=8,
                     ssm_heads=5, d_model=40)
    p = _rand(mixers.init_hymba(torch.Generator().manual_seed(5), cfg,
                                "cpu"))
    if t > 1:
        axes = dict(zip(sharding.leaf_names(p), sharding.split_axes(p, t)))
        assert axes["ln"] == axes["ln_attn"] == 1
        assert axes["wdt"] is None and axes["a_log"] is None
    tree = {"p": p, "x": _t(B, S, 40)}
    positions = torch.arange(S).expand(B, S)

    def by_shard(q):
        ms = _ms(t, q["p"])
        return mixers.hymba_train_tp(ms.split(q["p"]), q["x"], cfg, ms,
                                     positions=positions)

    got = _grads(by_shard, tree)
    want = _grads(lambda q: mixers.hymba_train(q["p"], q["x"], cfg,
                                               positions=positions), tree)
    _hold(got, want, bitwise=t == 1, grad_tol=1e-2, what=f"hymba T={t}")


@pytest.mark.parametrize("t", TS)
def test_cross_attention(t):
    """`cross_attention_train_tp` against `cross_attention_train`
    (whisper's: 4 heads of 8, qkv biases, 24 encoder frames): wq and bq on
    the decoder stream, wk, wv, bk, bv on the encoder output, the
    gradient of `enc` the shards' partials summed."""
    cfg = _mixer_cfg("whisper-medium", num_heads=4, num_kv_heads=4,
                     head_dim=8)
    p = _rand(mixers.init_attention(torch.Generator().manual_seed(6), cfg,
                                    "cpu"))
    tree = {"p": p, "x": _t(B, S, D), "enc": _t(B, 24, D, seed=1)}

    def by_shard(q):
        ms = _ms(t, q["p"])
        return mixers.cross_attention_train_tp(ms.split(q["p"]), q["x"],
                                               q["enc"], cfg, ms)

    got = _grads(by_shard, tree)
    want = _grads(lambda q: mixers.cross_attention_train(
        q["p"], q["x"], q["enc"], cfg), tree)
    # bk's gradient is zero in exact arithmetic (a query's scores all
    # shift by q . bk, which the softmax ignores): both sides' rounding
    # noise is held to 1e-5 of the layer's largest gradient entry
    i = [n for n, _ in sorted(tree["p"].items())].index("bk") + 1
    scale = max(float(g.abs().max()) for g in want[1])
    assert max(float(got[1][i].abs().max()),
               float(want[1][i].abs().max())) <= 1e-5 * scale
    drop = lambda g: (g[0], g[1][:i] + g[1][i + 1:])  # noqa: E731
    _hold(drop(got), drop(want), bitwise=t == 1, grad_tol=1e-2,
          what=f"cross-attention T={t}")


# -- the whole model ---------------------------------------------------------------

WHOLE_MODEL = [  # (arch, T, kv heads, the attention case at T)
    ("qwen2-vl-2b", 2, 2, "a"),
    ("qwen2-vl-2b", 4, 2, "b"),
    ("qwen2-moe-a2.7b", 2, 4, "a"),
    ("qwen2-moe-a2.7b", 4, 4, "a"),
]


@pytest.mark.parametrize("ce", ["gather", "streaming"])
@pytest.mark.parametrize("arch,t,kh,case", WHOLE_MODEL)
def test_whole_loss_by_shard(arch, t, kh, case, ce):
    """`loss_fn(ms=)` (every layer on its shards, remat "full") against
    `loss_fn` on the whole parameters, the loss and the gradient of every
    leaf: the reduced VLM (M-RoPE, 16 patches replacing the embeddings
    after the vocab-parallel lookup's reduction, the loss over the text
    positions only) and the reduced MoE (routing on every shard, the
    shared expert's partial added), in f32. The loss to rtol 1e-5; each
    gradient within 1e-2 of the leaf's largest entry (the attention's
    bf16 roundings, as above)."""
    cfg = dataclasses.replace(reduced(get_config(arch), seq=24),
                              num_kv_heads=kh, dtype=torch.float32)
    assert sharding.attention_case(cfg, t) == case
    params = transformer.init_params(0, cfg, "cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     (B, 25)))}
    if cfg.family == "vlm":
        batch["patches"] = _t(B, cfg.vision_patches, cfg.d_model, seed=3)
    ms = _ms(t, params)

    def run(shards):
        leaves, unflatten = tree_flatten(params)
        req = [v.detach().clone().requires_grad_() for v in leaves]
        loss = transformer.loss_fn(unflatten(req), batch, cfg, ce=ce,
                                   ms=shards)
        return loss.detach(), torch.autograd.grad(loss, req)

    got, want = run(ms), run(None)
    assert torch.isfinite(want[0])
    _hold(got, want, bitwise=False, grad_tol=1e-2,
          what=f"{arch} loss_fn T={t} ce={ce}")


def odd_hymba(seq: int = 24):
    """Reduced hymba with hymba-1.5b's splits at T = 2 and 4: 5 heads of
    16 over 1 kv head, d_model 80, 5 SSD heads (case c, `ln` split on its
    last axis, `wdt` whole)."""
    return dataclasses.replace(reduced(get_config("hymba-1.5b"), seq=seq),
                               num_heads=5, num_kv_heads=1, head_dim=16,
                               d_model=80, ssm_heads=5)


FAMILY_MODEL = {  # the reduced family at seq tokens
    "rwkv6-7b": (lambda: reduced(get_config("rwkv6-7b"), seq=128), 128),
    "hymba-odd": (odd_hymba, 24),
    "whisper-medium": (lambda: reduced(get_config("whisper-medium"),
                                       seq=24), 24),
}


@pytest.mark.parametrize("ce", ["gather", "streaming"])
@pytest.mark.parametrize("t", (2, 4))
@pytest.mark.parametrize("arch", sorted(FAMILY_MODEL))
def test_family_loss_by_shard(arch, t, ce):
    """`loss_fn(ms=)` against `loss_fn` for the ssm, hybrid and audio
    families, the loss and the gradient of every leaf, in f32: reduced
    rwkv6-7b over two chunks of the linear attention, the odd-head hymba
    (case c) and reduced whisper-medium (the encoder's blocks over 24
    frames by shard, the cross-attention in every decoder layer). The
    loss to rtol 1e-5; each gradient within 1e-2 of the leaf's largest
    entry (the attentions' bf16 roundings, as above)."""
    make, seq = FAMILY_MODEL[arch]
    cfg = dataclasses.replace(make(), dtype=torch.float32)
    params = transformer.init_params(0, cfg, "cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     (B, seq + 1)))}
    if cfg.is_encdec:
        batch["frames"] = _t(B, cfg.encoder_seq, cfg.d_model, seed=3)
    ms = _ms(t, params)

    def run(shards):
        leaves, unflatten = tree_flatten(params)
        req = [v.detach().clone().requires_grad_() for v in leaves]
        loss = transformer.loss_fn(unflatten(req), batch, cfg, ce=ce,
                                   ms=shards)
        return loss.detach(), torch.autograd.grad(loss, req)

    got, want = run(ms), run(None)
    assert torch.isfinite(want[0])
    _hold(got, want, bitwise=False, grad_tol=1e-2,
          what=f"{arch} loss_fn T={t} ce={ce}")


# -- the rules the step reads --------------------------------------------------

# the attention case of each config at T = 2, 4, 8 and 16 (rwkv6's
# time-mix heads split as case a; hymba's mixer is case c at every T)
CASE_TABLE = {
    "stablelm-1.6b": "aaaa", "qwen2.5-32b": "aaac", "deepseek-67b": "aaab",
    "starcoder2-15b": "aabb", "dbrx-132b": "aaab", "qwen2-moe-a2.7b": "aaaa",
    "qwen2-vl-2b": "abcc", "rwkv6-7b": "aaaa", "hymba-1.5b": "cccc",
    "whisper-medium": "aaaa"}


def test_families_and_attention_cases():
    """Every config's layers compute by shard (its `model_layout` says
    so) in the attention case of CASE_TABLE at T = 2, 4, 8 and 16; every
    leaf its layers split is split by the reference's spec there (the
    layers raise on any other)."""
    from repro_torch.configs import all_configs

    assert sorted(CASE_TABLE) == sorted(all_configs())
    for name, cases in CASE_TABLE.items():
        cfg = get_config(name)
        meta = transformer.init_params(0, cfg, "meta")
        for t, case in zip((2, 4, 8, 16), cases):
            assert sharding.attention_case(cfg, t) == case, (name, t)
            layout = sharding.model_layout(cfg, t)
            assert "compute by shard" in layout and f"case {case}" in layout
            names = sharding.leaf_names(meta)
            axes = sharding.split_axes(meta, t)
            for n, ax, leaf in zip(names, axes, tree_leaves(meta)):
                want = {"wq": -1, "wk": -1, "wv": -1, "w_up": -1,
                        "w_gate": -1, "wo": -2, "w_down": -2, "embed": -2,
                        "lm_head": -2, "wr": -1, "wg": -1, "wA": -1,
                        "w0": -1, "mu": -1, "wB": -2, "u": -2,
                        "ln_out": -2, "wo_fused": -2, "bq": -1, "bk": -1,
                        "bv": -1}.get(n)
                free = {"a": (), "b": ("wk", "wv", "bk", "bv"),
                        "c": ("wq", "wk", "wv", "bq", "bk", "bv")}[case]
                if want is not None and n not in free:
                    assert ax is not None and ax - leaf.dim() == want, (
                        name, t, n)


def _tiny_step(arch, shape):
    cfg = dataclasses.replace(odd_hymba(8) if arch == "hymba-odd" else
                              reduced(get_config(arch), seq=8),
                              dtype=torch.float32)
    mesh = make_mesh(shape, ("data", "model"))
    agg = CompressedAggregation(method="diana", fraction=0.3,
                                shift_dtype=torch.float32)
    step = steps.make_train_step(cfg, mesh, agg=agg, lr=0.05)
    state = steps.init_train_state(0, cfg, agg, shape[0], mesh=mesh,
                                   device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (shape[0] * 2, 9)))
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["patches"] = _t(shape[0] * 2, 4, cfg.d_model)
    if cfg.is_encdec:
        batch["frames"] = _t(shape[0] * 2, cfg.encoder_seq, cfg.d_model)
    return cfg, step, state, batch


# what each family's layers put together over the model axis at T = 2
# (`tp.gathered`, `tp.whole`): rwkv6 its token-shift `mu`; hymba (case c)
# its split projections and norms; the reduced VLM's attention (one kv
# head: case b) its wk and wv and their biases; the others nothing
PUT_TOGETHER = {
    "stablelm-1.6b": (), "qwen2-moe-a2.7b": (),
    "qwen2-vl-2b": ("wk", "wv", "bk", "bv"),
    "rwkv6-7b": ("mu",), "hymba-odd": ("wq", "wk", "wv", "wx", "wbc", "ln",
                                       "ln_attn"),
    "whisper-medium": ()}


def test_step_by_shard_never_gathers_weights(monkeypatch):
    """No family's step gathers its weights over the model axis: the
    whole-tree gather (`sharding.gather_shards`) is gone, and a (2, 2)
    step of each family (dense, moe, vlm, ssm, hybrid, audio) never takes
    its shards of a whole gradient (`take_shards`) and puts together only
    the leaves its layers name (PUT_TOGETHER), each a layer's shards of
    one leaf."""
    assert not hasattr(sharding, "gather_shards")
    assert not hasattr(sharding, "computes_by_shard")

    def refuse(*a, **k):
        raise AssertionError("take_shards called")

    seen = []
    whole = tp._whole

    def spy(ms, axis, data):
        seen.append(tuple(data.shape[1:]))
        return whole(ms, axis, data)

    # the initial states first: `init_train_state` takes the process's
    # shards of the parameters
    runs = {arch: _tiny_step(arch, (2, 2)) for arch in PUT_TOGETHER}
    monkeypatch.setattr(sharding, "take_shards", refuse)
    monkeypatch.setattr(tp, "_whole", spy)
    for arch, names in PUT_TOGETHER.items():
        cfg, step, state, batch = runs[arch]
        meta = transformer.init_params(0, cfg, "meta")
        allowed = {tuple(leaf.shape[1:-1]) + (leaf.shape[-1] // 2,)
                   if ax == leaf.dim() - 1 else
                   tuple(leaf.shape[1:-2]) + (leaf.shape[-2] // 2,
                                              leaf.shape[-1])
                   for n, ax, leaf in zip(sharding.leaf_names(meta),
                                          sharding.split_axes(meta, 2),
                                          tree_leaves(meta))
                   if n in names and ax is not None}
        seen.clear()
        _, metrics = step(state, batch, torch.Generator().manual_seed(0))
        assert np.isfinite(float(metrics["loss"])), arch
        assert set(seen) == allowed, (arch, set(seen), allowed)


def test_unsplittable_shapes_raise_naming_the_leaf():
    """A layer whose leaf the spec leaves whole (or splits elsewhere)
    raises, naming it: no quiet gather. Here d_ff = 6 at T = 4 leaves
    w_up and w_gate whole and splits w_down on its last axis; and reduced
    rwkv6's 4 heads at T = 8 leave its bonus `u` split on its last axis
    (its time mix splits it by heads)."""
    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b"), seq=8),
                              d_ff=6, dtype=torch.float32)
    params = transformer.init_params(0, cfg, "cpu")
    ms = tp.ModelShards(4, axes=sharding.split_axes(params, 4))
    batch = {"tokens": torch.zeros((1, 9), dtype=torch.int64)}
    with pytest.raises(ValueError, match="w_up: .* leaves it whole"):
        transformer.loss_fn(params, batch, cfg, ms=ms)
    rwkv = reduced(get_config("rwkv6-7b"), seq=8)
    params = transformer.init_params(0, rwkv, "cpu")
    with pytest.raises(ValueError, match="u: .* split on axis -1"):
        transformer.loss_fn(params, batch, rwkv, ms=_ms(8, params))


def test_model_shards_of_a_step():
    """`model_shards`: None at T = 1 (the whole layers); at T > 1, for
    every family, every shard on one process, or the process's share of
    its client's shards over a process group's layout."""
    cfg = reduced(get_config("stablelm-1.6b"), seq=8)
    meta = transformer.init_params(0, cfg, "meta")
    agg = CompressedAggregation(method="diana", collective=StackedCollective())
    one = steps.configure_agg(agg, make_mesh((4, 1)), params=meta)
    assert sharding.model_shards(one, cfg) is None
    two = steps.configure_agg(agg, make_mesh((4, 2)), params=meta)
    ms = sharding.model_shards(two, cfg)
    assert (ms.size, ms.start, ms.count, ms.spread) == (2, 0, 2, False)
    assert ms.axes == sharding.split_axes(meta, 2)
    rwkv = reduced(get_config("rwkv6-7b"), seq=8)
    rmeta = transformer.init_params(0, rwkv, "meta")
    ms = sharding.model_shards(steps.configure_agg(
        agg, make_mesh((4, 2)), params=rmeta), rwkv)
    assert isinstance(ms, tp.ModelShards)
    assert (ms.size, ms.count) == (2, 2)
    assert ms.axes == sharding.split_axes(rmeta, 2)
