"""The port's model families against the JAX reference: `models.moe`
(with its load-balance diagnostic), `models.linear_attention`, the M-RoPE,
sinusoid and relu2 / tanh-gelu layers, each reduced family's loss and
gradients (and the streaming CE's), and the parameter trees and counts of
all ten configurations at full size.

Inputs are made with numpy from a seed and handed to both sides; the models
run at f32, with the reference's parameters carried over by
`convert.params_from_jax`. Tolerances, each with its reason:

- M-RoPE and the MLPs: rtol 1e-5 (one f32 rounding per operation; the
  frameworks' transcendental functions differ in the last bits); the
  sinusoid: atol 2^-13, the f32 ulp of its largest angle (1500 rad);
- `moe_ffn` and `moe_ffn_ref`: rtol 1e-5, atol 1e-5 of the output's scale
  (matmuls summed in different orders); the aux diagnostic and the
  streaming CE: rtol 1e-5 and 1e-6 (f32 sums in different orders). Routing is discrete: a last-bit
  difference in a router logit flips an expert where two routing
  probabilities tie, so every test that routes first checks that the
  k-th and (k+1)-th probabilities of every token are at least 1e-4 apart,
  far above the f32 rounding of a probability (about 1e-7);
- the chunked linear attention against the reference's chunked form:
  rtol 1e-5, atol 1e-5 (f32 einsums summed in different orders); against
  the sequential oracle: 2e-4, the reference's own bound between the two
  forms (its tests/test_linear_attention.py);
- the reduced families' losses: rtol 1e-5; their gradients: each leaf
  within 1e-2 of its largest entry. The reference rounds the softmax
  probabilities and values of every attention to bf16 before their
  product (and their cotangents in the backward pass), and so does the
  port, so a last-bit f32 difference that crosses a bf16 rounding
  boundary moves that element by 2^-8 of itself (tests/test_torch_models.py
  holds the dense family to the same bound). The worst measured error is
  in the assertion messages;
- tree paths, shapes, dtypes and parameter counts: exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as jl
from repro.models import linear_attention as jla
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.core.api import tree_flatten, tree_leaves
from repro_torch.models import layers as tl
from repro_torch.models import linear_attention as tla
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt

RNG = np.random.default_rng(0)
S = 32  # tokens per row in the reduced models
FAMILIES = ["qwen2-moe-a2.7b", "dbrx-132b", "rwkv6-7b", "hymba-1.5b",
            "qwen2-vl-2b", "whisper-medium", "starcoder2-15b"]
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _f32(shape, scale=1.0, rng=RNG):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _pair(name, seq=S):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(name), seq=seq),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(reduced(get_config(name), seq=seq),
                               dtype=torch.float32)
    return jcfg, tcfg


def _margin(probs, k):
    """The smallest gap between the k-th and (k+1)-th routing probability
    of any token."""
    top = torch.sort(probs.detach(), dim=-1, descending=True).values
    return float((top[..., k - 1] - top[..., k]).min())


# -- layers -----------------------------------------------------------------------

def test_mrope_positions_and_sinusoid_match_reference():
    _, tcfg = _pair("qwen2-vl-2b")
    jcfg, _ = _pair("qwen2-vl-2b")
    for s, b in ((40, 2), (16, 1), (9, 3)):
        got = tt.mrope_positions(tcfg, s, b)
        want = np.asarray(jt.mrope_positions(jcfg, s, b))
        assert tuple(got.shape) == want.shape == (3, b, s)
        np.testing.assert_array_equal(got.numpy(), want)
    # angles reach 1500 rad, whose f32 ulp (2^-13) the frameworks' pow may
    # differ by: sin and cos carry it, so atol is that ulp
    for s, d in ((1500, 1024), (24, 128)):
        _close(tt._sinusoid(s, d, torch.float32),
               jt._sinusoid(s, d, jnp.float32), atol=2.0 ** -13)


@pytest.mark.parametrize("sections", [(4, 6, 6), (16, 24, 24)])
def test_apply_mrope_matches_reference(sections):
    hd = 2 * sum(sections)
    x = _f32((2, 40, 3, hd))
    pos = RNG.integers(0, 60, (3, 2, 40)).astype(np.int32)
    _close(tl.apply_mrope(_t(x), _t(pos), 1e6, sections),
           jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections),
           atol=2e-5)


@pytest.mark.parametrize("act,bias", [("relu2", False), ("gelu", False),
                                      ("gelu", True)])
def test_relu2_and_tanh_gelu_mlps_match_reference(act, bias):
    """relu(xW)^2 and jax.nn.gelu's tanh form (not torch's erf default),
    with and without the optional b_up / b_down."""
    x = _f32((2, 5, 16))
    p = {"w_up": _f32((16, 24), 0.5), "w_down": _f32((24, 16), 0.3)}
    if bias:
        p.update(b_up=_f32((24,), 0.5), b_down=_f32((16,), 0.5))
    got = tl.mlp(_t(x), {k: _t(v) for k, v in p.items()}, act)
    _close(got, jl.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                        p.items()}, act), atol=1e-5)
    if act == "gelu":  # the erf form differs by far more than the tolerance
        erf = tl.linear(torch.nn.functional.gelu(tl.linear(
            _t(x), _t(p["w_up"]), _t(p["b_up"]) if bias else None)),
            _t(p["w_down"]), _t(p["b_down"]) if bias else None)
        assert float((erf - got).abs().max()) > 1e-4


@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_init_mlp_tree_matches_reference(act):
    want = jax.eval_shape(lambda: jl.init_mlp(jax.random.key(0), 16, 24, act,
                                              jnp.bfloat16))
    got = tl.init_mlp(None, 16, 24, act, torch.bfloat16, "meta")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.bfloat16


# -- mixture of experts ---------------------------------------------------------------

@pytest.mark.parametrize("name,act", [("qwen2-moe-a2.7b", "swiglu"),
                                      ("dbrx-132b", "swiglu"),
                                      ("dbrx-132b", "gelu")])
def test_moe_ffn_matches_reference(name, act):
    """Swiglu experts with a shared expert (qwen2-moe), without one (the
    dbrx layernorm config), and the gelu experts' branch."""
    jcfg, tcfg = _pair(name)
    jcfg = dataclasses.replace(jcfg, act=act)
    tcfg = dataclasses.replace(tcfg, act=act)
    jp = jmoe.init_moe(jax.random.key(3), jcfg)
    tp = convert.params_from_jax(jax.device_get(jp), "cpu")
    assert sorted(tp) == sorted(jp)
    assert tp["router"].dtype == torch.float32
    x = _f32((3, 16, jcfg.d_model))
    probs, _, _ = tmoe._route(tp, _t(x), tcfg)
    assert _margin(probs, tcfg.experts_per_token) > MARGIN
    got = tmoe.moe_ffn(tp, _t(x), tcfg)
    got_ref = tmoe.moe_ffn_ref(tp, _t(x), tcfg)
    want = np.asarray(jmoe.moe_ffn(jp, jnp.asarray(x), jcfg))
    want_ref = np.asarray(jmoe.moe_ffn_ref(jp, jnp.asarray(x), jcfg))
    atol = 1e-5 * np.abs(want).max()
    _close(got, want, atol=atol)
    _close(got_ref, want_ref, atol=atol)
    _close(got, want_ref, atol=atol)


def test_moe_aux_matches_reference():
    """moe_ffn(return_aux=True): the output unchanged and the Switch-style
    load-balance diagnostic E * sum(frac * mean_p), rtol 1e-5."""
    jcfg, tcfg = _pair("qwen2-moe-a2.7b")
    jp = jmoe.init_moe(jax.random.key(4), jcfg)
    tp = convert.params_from_jax(jax.device_get(jp), "cpu")
    x = _f32((3, 16, jcfg.d_model))
    probs, _, _ = tmoe._route(tp, _t(x), tcfg)
    assert _margin(probs, tcfg.experts_per_token) > MARGIN
    y, aux = tmoe.moe_ffn(tp, _t(x), tcfg, return_aux=True)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, return_aux=True)
    _close(y, jy, atol=1e-5 * np.abs(np.asarray(jy)).max())
    assert aux.shape == () and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert torch.equal(y, tmoe.moe_ffn(tp, _t(x), tcfg))


def test_moe_routes_ties_to_the_lower_expert_and_skips_idle_experts():
    """lax.top_k's tie order (equal router logits pick the lower index) and
    dropless dispatch: an expert no token picked gets a zero gradient."""
    _, tcfg = _pair("qwen2-moe-a2.7b")
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg, "cpu")
    tp["router"] = torch.zeros_like(tp["router"])  # every expert ties
    _, top_w, top_e = tmoe._route(tp, torch.ones(1, 3, tcfg.d_model), tcfg)
    assert top_e.tolist() == [[[0, 1]] * 3]
    assert torch.equal(top_w, torch.full_like(top_w, 0.5))
    w_down = tp["w_down"].requires_grad_(True)
    y = tmoe.moe_ffn(tp, torch.randn(1, 3, tcfg.d_model), tcfg)
    grad, = torch.autograd.grad(y.square().sum(), [w_down])
    per_expert = grad.abs().sum(dim=(1, 2))
    assert per_expert[:2].min() > 0 and per_expert[2:].max() == 0


# -- chunked linear attention ------------------------------------------------------------

def _la_inputs(scalar, s=48, b=2, h=3, dk=8, dv=8):
    rng = np.random.default_rng(7 + scalar)
    r, k, v = (_f32((b, s, h, n), 0.5, rng) for n in (dk, dk, dv))
    shape = (b, s, h) if scalar else (b, s, h, dk)
    # about a third of the steps below -LOG_DECAY_CLAMP: the clamp matters
    ld = -np.exp(_f32(shape, 0.5, rng))
    bonus = None if scalar else _f32((h, dk), 0.3, rng)
    state = _f32((b, h, dk, dv), 0.5, rng)
    return r, k, v, ld.astype(np.float32), bonus, state


@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
@pytest.mark.parametrize("with_state", [False, True])
def test_chunked_linear_attention_matches_reference(mode, with_state):
    """Per-channel decay, exclusive, with the bonus (RWKV6) and scalar
    decay, inclusive (SSD); three chunks of 16; with and without an
    initial state."""
    scalar = mode == "ssd"
    r, k, v, ld, bonus, state = _la_inputs(scalar)
    assert (ld < -tla.LOG_DECAY_CLAMP).mean() > 0.2
    kw = dict(inclusive=scalar)
    tkw = dict(kw, bonus=None if bonus is None else _t(bonus),
               initial_state=_t(state) if with_state else None)
    jkw = dict(kw, bonus=None if bonus is None else jnp.asarray(bonus),
               initial_state=jnp.asarray(state) if with_state else None)
    targs = [_t(a) for a in (r, k, v, ld)]
    jargs = [jnp.asarray(a) for a in (r, k, v, ld)]
    got, gstate = tla.chunked_linear_attention(*targs, chunk=16, **tkw)
    want, wstate = jla.chunked_linear_attention(*jargs, chunk=16, **jkw)
    _close(got, want, atol=1e-5)
    _close(gstate, wstate, atol=1e-5)
    seq, sstate = tla.reference_linear_attention(*targs, **tkw)
    jseq, jsstate = jla.reference_linear_attention(*jargs, **jkw)
    _close(seq, jseq, atol=1e-5)
    _close(sstate, jsstate, atol=1e-5)
    _close(got, seq.numpy(), rtol=2e-4, atol=2e-4)
    _close(gstate, sstate.numpy(), rtol=2e-4, atol=2e-4)


def test_chunked_linear_attention_refuses_a_ragged_sequence():
    r, k, v, ld, _, _ = _la_inputs(True, s=40)
    with pytest.raises(ValueError, match="must divide chunk"):
        tla.chunked_linear_attention(*(_t(a) for a in (r, k, v, ld)),
                                     inclusive=True, chunk=16)


# -- the reduced families end to end ---------------------------------------------------

def _batch(cfg, rng):
    b = {"tokens": rng.integers(0, cfg.vocab, (2, S + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patches"] = _f32((2, cfg.vision_patches, cfg.d_model), 1.0, rng)
    if cfg.encoder_layers:
        b["frames"] = _f32((2, cfg.encoder_seq, cfg.d_model), 1.0, rng)
    return b


@pytest.mark.parametrize("name", FAMILIES)
def test_reduced_family_loss_and_grads_match_reference(name, monkeypatch):
    jcfg, tcfg = _pair(name)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    batch = _batch(jcfg, np.random.default_rng(1))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg, remat=False)))(jparams)
    margins = []
    route = tmoe._route

    def recording_route(p, x, cfg):
        out = route(p, x, cfg)
        margins.append(_margin(out[0], cfg.experts_per_token))
        return out

    monkeypatch.setattr(tmoe, "_route", recording_route)
    params = convert.params_from_jax(jax.device_get(jparams), "cpu")
    leaves, unflatten = tree_flatten(params)
    leaves = [p.requires_grad_(True) for p in leaves]
    loss = tt.loss_fn(unflatten(leaves), {k: _t(v) for k, v in batch.items()},
                      tcfg, remat="full")
    grads = torch.autograd.grad(loss, leaves)
    if tcfg.num_experts:  # each layer routed twice (forward, recompute)
        assert len(margins) == 2 * tcfg.num_layers
        assert min(margins) > MARGIN, margins
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    worst = 0.0
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = np.abs(w).max()
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-2 * scale + 1e-7, (err, scale)
        if scale > 1e-5:  # a key bias's gradient is zero up to rounding
            worst = max(worst, err / scale)
    print(f"{name}: loss {float(loss.detach())} worst leaf error "
          f"{worst:.2e} of max")


def test_streaming_ce_matches_reference():
    """The vocab-parallel CE on padded-vocab logits (pad columns carrying
    large values it must ignore) against the reference's, and against the
    gather CE on the masked logits; rtol 1e-6."""
    rng = np.random.default_rng(5)
    logits = _f32((3, 7, 512), 3.0, rng)
    logits[..., 503:] = 50.0  # the pad ids: excluded by the mask alone
    labels = rng.integers(0, 503, (3, 7)).astype(np.int32)
    got = tt._streaming_ce(_t(logits), _t(labels).long(), 503)
    want = jt._streaming_ce(jnp.asarray(logits), jnp.asarray(labels), 503)
    _close(got, want, rtol=1e-6)
    _close(got, tl.token_nll(_t(logits), _t(labels), 503).numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", ["qwen2-vl-2b", "qwen2-moe-a2.7b"])
def test_streaming_loss_and_grads_match_reference(name, monkeypatch):
    """loss_fn(ce="streaming") through the unmasked head: the loss at rtol
    1e-5 and every gradient leaf within 1e-2 of its largest entry (the
    reference's bf16 attention, as above), against the reference's
    streaming loss; and the port's streaming and gather losses agree."""
    jcfg, tcfg = _pair(name)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    batch = _batch(jcfg, np.random.default_rng(6))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg, remat=False, ce="streaming")))(jparams)
    margins = []
    route = tmoe._route

    def recording_route(p, x, cfg):
        out = route(p, x, cfg)
        margins.append(_margin(out[0], cfg.experts_per_token))
        return out

    monkeypatch.setattr(tmoe, "_route", recording_route)
    params = convert.params_from_jax(jax.device_get(jparams), "cpu")
    leaves, unflatten = tree_flatten(params)
    leaves = [p.requires_grad_(True) for p in leaves]
    tbatch = {k: _t(v) for k, v in batch.items()}
    loss = tt.loss_fn(unflatten(leaves), tbatch, tcfg, remat=False,
                      ce="streaming")
    grads = torch.autograd.grad(loss, leaves)
    assert not margins or min(margins) > MARGIN, margins
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    gather = tt.loss_fn(params, tbatch, tcfg, remat=False)
    np.testing.assert_allclose(float(gather.detach()), float(loss.detach()),
                               rtol=1e-5)
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    worst = 0.0
    for g, w in zip(grads, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-2 * scale + 1e-7, (err, scale)
        if scale > 1e-5:
            worst = max(worst, err / scale)
    print(f"{name} streaming: loss {float(loss.detach())} worst leaf error "
          f"{worst:.2e} of max")
    with pytest.raises(ValueError, match="unknown ce"):
        tt.loss_fn(params, tbatch, tcfg, ce="vocab")


def test_vlm_loss_counts_text_positions_only():
    """With patches, the loss is the mean over the text positions; without
    them, over every position."""
    _, tcfg = _pair("qwen2-vl-2b")
    params = tt.init_params(0, tcfg, "cpu")
    batch = {k: _t(v) for k, v in _batch(tcfg, np.random.default_rng(2))
             .items()}
    from repro_torch.models.layers import token_nll

    nll = token_nll(tt.forward(params, batch, tcfg), batch["tokens"][:, 1:],
                    tcfg.vocab)
    p = tcfg.vision_patches
    torch.testing.assert_close(tt.loss_fn(params, batch, tcfg),
                               nll[:, p:].mean(), rtol=1e-6, atol=0)
    text = {"tokens": batch["tokens"]}
    torch.testing.assert_close(
        tt.loss_fn(params, text, tcfg),
        token_nll(tt.forward(params, text, tcfg), text["tokens"][:, 1:],
                  tcfg.vocab).mean(), rtol=1e-6, atol=0)


# -- the ten configurations at full size -------------------------------------------------

def _paths(tree, prefix=""):
    """Key paths in `tree_flatten`'s order, in jax.tree_util.keystr form."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += (_paths(v, f"{prefix}['{k}']") if isinstance(v, dict)
                else [f"{prefix}['{k}']"])
    return out


def test_registry_has_the_reference_configs():
    assert ARCH_NAMES == JAX_ARCH_NAMES
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("name", JAX_ARCH_NAMES)
def test_full_size_param_tree_and_counts_match_reference(name):
    """Key paths in order, shapes and dtypes of `init_params(device="meta")`
    against jax.eval_shape of the reference's, every config field, and the
    reference's param_count / active_param_count."""
    jcfg, tcfg = jax_get_config(name), get_config(name)
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.is_encdec, tcfg.attention_free, tcfg.supports_long_context()
            ) == (jcfg.is_encdec, jcfg.attention_free,
                  jcfg.supports_long_context())
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    want = jax.eval_shape(lambda: jt.init_params(jax.random.key(0), jcfg))
    got = tt.init_params(0, tcfg, "meta")
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    assert _paths(got) == paths
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    # reduced: the same tree at the reduced widths
    jr, tr = jax_reduced(jcfg), reduced(tcfg)
    assert dataclasses.asdict(dataclasses.replace(tr, dtype=None)) == \
        dataclasses.asdict(dataclasses.replace(jr, dtype=None))
