"""The port's dense transformer, optimizers and LM data against the JAX
reference: `models.layers`, `models.transformer`, `optim.optimizers`,
`data.tokens`, the slot functions of `data.pipeline`, and `convert`.

Inputs are made with numpy and handed to both sides; the models run at f32.
Tolerances, each with its reason:

- norms, RoPE, the MLP, the head and the cross entropy: rtol 1e-5 (the
  frameworks sum in different orders; one f32 rounding per reduction);
- attention: the reference rounds the softmax probabilities and the values
  to bf16 before their product (§Perf change F) and the port does the
  same, so an f32 last-bit difference in a score can flip one bf16
  rounding (2^-8 of that element): atol 4e-3 of the output's scale
  (measured worst 9.4e-8: no rounding flipped at these inputs);
- the reduced stablelm loss: rtol 1e-5 (the jitted reference fuses its
  reductions; measured 2.3e-7 here, 1.6e-6 on other tokens); its
  gradients, whose backward pass rounds the attention's cotangents to bf16
  the same way: each leaf within 1e-2 of its largest entry (measured worst
  7.5e-4);
- optimizers, tokens, slots and conversions: exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import pipeline as jax_pipeline
from repro.data.reshuffle import ReshuffleSampler as JaxSampler
from repro.data.tokens import synthetic_token_batches as jax_tokens
from repro.launch import steps as jax_steps
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.optim import optimizers as jopt
from repro.core.dist import CompressedAggregation as JaxAgg
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.api import tree_flatten, tree_leaves
from repro_torch.core.dist import CompressedAggregation
from repro_torch.data import pipeline
from repro_torch.data.reshuffle import ReshuffleSampler
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.launch.steps import init_train_state
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.optim import optimizers as topt

RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _f32(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_norms_rope_mlp_head_match_reference():
    x, scale, bias = _f32((2, 5, 16)), _f32((16,)), _f32((16,))
    _close(tl.layernorm(_t(x), _t(scale), _t(bias)),
           jl.layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    _close(tl.rmsnorm(_t(x), _t(scale)),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    xh = _f32((2, 6, 3, 8))
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    _close(tl.apply_rope(_t(xh), _t(pos), 1e4),
           jl.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 1e4))
    p = {"w_gate": _f32((16, 24), 0.3), "w_up": _f32((16, 24), 0.3),
         "w_down": _f32((24, 16), 0.3)}
    _close(tl.mlp(_t(x), {k: _t(v) for k, v in p.items()}, "swiglu"),
           jl.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                  "swiglu"))
    table, labels = _f32((32, 16), 0.2), RNG.integers(0, 29, (2, 5))
    logits = tl.lm_logits(_t(x), _t(table), 29)
    jlogits = jl.lm_logits(jnp.asarray(x), jnp.asarray(table), 29)
    _close(logits, jlogits)
    _close(tl.cross_entropy(logits, _t(labels), 29),
           jl.cross_entropy(jlogits, jnp.asarray(labels), 29))


@pytest.mark.parametrize("sq,h,kh,block,window", [
    (9, 4, 4, 1024, None), (9, 4, 2, 1024, None), (10, 4, 2, 4, None),
    (12, 2, 1, 4, 5)])
def test_chunked_attention_matches_reference(sq, h, kh, block, window):
    """One block, GQA, several (padded) q and kv blocks, a sliding window."""
    q, k, v = _f32((2, sq, h, 8)), _f32((2, sq, kh, 8)), _f32((2, sq, kh, 8))
    got = tl.chunked_attention(_t(q), _t(k), _t(v), window=window,
                               block=block)
    want = np.asarray(jl.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        block=block))
    err = np.abs(got.numpy() - want).max()
    assert err <= 4e-3 * np.abs(want).max(), err


def _reduced_pair(seq=8):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("stablelm-1.6b"),
                                           seq=seq), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduced(get_config("stablelm-1.6b"), seq=seq),
                               dtype=torch.float32)
    return jcfg, tcfg


def test_reduced_stablelm_loss_and_grads_match_reference():
    jcfg, tcfg = _reduced_pair()
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 9)).astype(
        np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg,
                             remat=False)))(jparams)
    params = convert.params_from_jax(jax.device_get(jparams), "cpu")
    leaves, unflatten = tree_flatten(params)
    leaves = [p.requires_grad_(True) for p in leaves]
    loss = tt.loss_fn(unflatten(leaves), {"tokens": _t(tokens)}, tcfg,
                      remat="full")
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-2 * np.abs(w).max() + 1e-7


@pytest.mark.parametrize("full", [False, True])
def test_init_params_tree_matches_reference(full):
    """Paths, shapes, dtypes and the flattening order of the parameter
    tree, at the reduced width and at stablelm-1.6b's full width (shapes
    only: 'meta' tensors and jax.eval_shape)."""
    jcfg = jax_get_config("stablelm-1.6b")
    tcfg = get_config("stablelm-1.6b")
    if not full:
        jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
    want = jax.eval_shape(lambda: jt.init_params(jax.random.key(0), jcfg))
    got = tt.init_params(0, tcfg, "meta" if full else "cpu")
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    port_paths = []

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}['{k}']")
            else:
                port_paths.append(f"{prefix}['{k}']")

    walk(got, "")
    assert sorted(port_paths) == paths
    assert list(got) == ["embed", "blocks", "final_norm", "lm_head"]
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_optimizers_match_reference():
    params = {"a": _f32((5, 3)), "b": _f32((4,))}
    grads = [{k: _f32(v.shape) for k, v in params.items()} for _ in range(2)]
    for name in ("sgd", "momentum", "adamw"):
        jo = {"sgd": jopt.sgd(0.1), "momentum": jopt.momentum(0.1),
              "adamw": jopt.adamw(0.1, weight_decay=0.1)}[name]
        to = {"sgd": topt.sgd(0.1), "momentum": topt.momentum(0.1),
              "adamw": topt.adamw(0.1, weight_decay=0.1)}[name]
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = {k: _t(v) for k, v in params.items()}
        js, ts = jo.init(jp), to.init(tp)
        for g in grads:
            ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
            tu, ts = to.update({k: _t(v) for k, v in g.items()}, ts, tp)
            jp = jopt.apply_updates(jp, ju)
            tp = topt.apply_updates(tp, tu)
        for k in params:
            _close(tp[k], jp[k], rtol=1e-6, atol=1e-7)
    clipped, norm = topt.clip_by_global_norm({k: _t(v) for k, v in
                                              grads[0].items()}, 1.5)
    jclip, jnorm = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in grads[0].items()}, 1.5)
    _close(norm, jnorm, rtol=1e-6)
    for k in clipped:
        _close(clipped[k], jclip[k], rtol=1e-6)


def test_synthetic_tokens_are_byte_equal():
    kw = dict(vocab=503, seq_len=17, batch=3, num_batches=4, num_clients=5,
              seed=11)
    got, want = synthetic_token_batches(**kw), jax_tokens(**kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_slot_functions_match_reference():
    for step in range(7):
        for mode in ("rr", "rr_shared", "rr_once"):
            np.testing.assert_array_equal(
                pipeline.slots_for_step(ReshuffleSampler(3, 4, mode=mode,
                                                         seed=2), step, 3),
                jax_pipeline.slots_for_step(JaxSampler(3, 4, mode=mode,
                                                       seed=2), step, 3))
        np.testing.assert_array_equal(
            pipeline.shared_slots_for_step(
                ReshuffleSampler(3, 4, mode="rr_shared", seed=2), step,
                n_slots=4),
            jax_pipeline.shared_slots_for_step(
                JaxSampler(3, 4, mode="rr_shared", seed=2), step, n_slots=4))
    with pytest.raises(ValueError, match="shared order"):
        pipeline.shared_slots_at(ReshuffleSampler(3, 4, mode="rr"), 0)
    with pytest.raises(ValueError, match="n_slots"):
        pipeline.shared_slots_at(ReshuffleSampler(3, 4, mode="rr_shared"), 0,
                                 n_slots=2)


def test_train_state_converts_bit_for_bit():
    """A reference TrainState (bf16 parameters and shift tables, AdamW
    state) becomes the port's with every bit and every field kept, and has
    the layout of the port's own init_train_state."""
    cfg = jax_reduced(jax_get_config("stablelm-1.6b"))
    agg = JaxAgg(method="diana_rr", n_slots=2)
    state = jax.device_get(jax_steps.init_train_state(
        jax.random.key(1), cfg, agg, 4, optimizer="adamw"))
    state = state._replace(params=jax.tree.map(
        lambda x: x + jnp.asarray(0.375, x.dtype), state.params))
    got = convert.train_state_from_jax(state, "cpu")
    for g, w in zip(tree_leaves(got), jax.tree.leaves(state)):
        w = np.asarray(w)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.to(torch.float32).numpy(),
                                      w.astype(np.float32))
    mine = init_train_state(0, reduced(get_config("stablelm-1.6b")),
                            CompressedAggregation(method="diana_rr", n_slots=2),
                            4, optimizer="adamw", device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(mine)] == [
        tuple(x.shape) for x in tree_leaves(got)]
