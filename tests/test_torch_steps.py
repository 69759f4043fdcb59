"""The port's LM train step (`repro_torch.launch.steps`) against the JAX
reference's `make_train_step`.

Both sides run the reduced stablelm-1.6b (2 layers, d_model 128) at f32 on
the same initial state, tokens and wire draws for three steps: flat (4, 1)
meshes for q, diana, diana_rr and ef, a two-pod (2, 2, 1) mesh for diana,
and with 2-way tensor parallelism DIANA-RR on the reference's (4, 2) mesh
on the f32 wire and on its (2, 2, 2) mesh on the packed8 wire: there the
reference's
wire compresses each model shard's block on its own and the port's
compresses each split leaf shard by shard, the draws made from a shard's
geometry, and the port's layers compute on their model shards
(`models.tp`, each shard in turn on this one process) where the
reference's GSPMD partitions them. Two tiny GQA variants of the dense
model take the attention's other splits: 4 heads over 2 kv heads on a
(2, 4) mesh (case b: each shard puts wk and wv together for the kv head
its q heads read) and 3 heads of 8 on (4, 2) (case c: every head on
every shard, wo's rows split mid-head), DIANA on the f32 wire.
XLA:CPU aborts when several multi-device
transformer programs run in one test process, so the reference's
trajectories are computed in one subprocess (this file run as a script),
which writes them to an npz file; the port replays them with the draws of
the reference's key schedule.

Tolerance: the loss, the gradient norm, the parameters and the shift tables
agree closely, not bitwise. The two frameworks sum in different orders
(matmuls, layer norms, the fused DIANA update that XLA contracts into one
multiply-add), and the reference's attention rounds its probabilities and
values, and so their cotangents in the backward pass, to bf16 (§Perf change
F, kept by the port): a last-bit f32 difference that crosses a bf16
rounding boundary moves that element by 2^-8 of itself, and the wire's
nb/kb scaling carries it into every direction. So each leaf is held to
|got - want| <= 1e-2 * max|want| + 1e-6 (measured worst after three steps:
3.4e-3 of the leaf's max, in an attention weight; with the layers by
shard 3.0e-3 on (4, 2), 2.2e-3 in case b and 2.4e-3 in case c), the loss
to rtol 1e-5 (worst 2.9e-6) and the gradient norm to rtol 1e-4 (worst
2.6e-5; by shard 7.3e-5, case c's second step). The
packed8 cases are held as tests/test_torch_nastya.py holds its packed8
case: 2e-2 of each leaf's largest value (a last-bit payload difference
can flip a stochastic rounding by one lattice step) and the gradient norm
to rtol 1e-3.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread, shard_shapes

ROOT = Path(__file__).resolve().parents[1]
S, B, STEPS, LR, FRACTION = 8, 8, 3, 0.05, 0.25
# (method, mesh, wire dtype, (heads, kv heads, head_dim) or None for the
# reduced model's); the model axis's cases ((4, 2), (2, 2, 2), (2, 4))
# compress each split leaf shard by shard, as the reference's wire does,
# and compute the layers by shard
CASES = [("q", (4, 1), "f32", None), ("diana", (4, 1), "f32", None),
         ("diana_rr", (4, 1), "f32", None), ("ef", (4, 1), "f32", None),
         ("diana", (2, 2, 1), "f32", None),
         ("diana_rr", (4, 2), "f32", None),
         ("diana_rr", (2, 2, 2), "packed8", None),
         ("diana", (2, 4), "f32", (4, 2, 32)),  # attention case (b)
         ("diana", (4, 2), "f32", (3, 3, 8))]  # attention case (c)
N_SLOTS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def _heads_tag(heads):
    return "" if heads is None else "-h{}kv{}d{}".format(*heads)


def _tag(method, shape, wire, heads=None):
    return f"{method}-{'x'.join(map(str, shape))}-{wire}{_heads_tag(heads)}"


def _case_id(case):
    method, shape, wire, heads = case
    return (f"{method}-{'x'.join(map(str, shape))}"
            + ("" if wire == "f32" else f"-{wire}") + _heads_tag(heads))


def _with_heads(cfg, heads):
    """The reduced model with (heads, kv heads, head_dim) of its
    attention (d_model stays 128)."""
    if heads is None:
        return cfg
    return dataclasses.replace(cfg, num_heads=heads[0],
                               num_kv_heads=heads[1], head_dim=heads[2])


def _clients(shape):
    return int(np.prod(shape[:-1]))


def _tokens():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 503, (B, S + 1)).astype(np.int32)
            for _ in range(STEPS)]


def _oracle(out_path: str) -> None:
    """The reference's trajectories for every case (run in a subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced
    from repro.core.dist import CompressedAggregation
    from repro.launch import compat, steps
    from repro.launch.mesh import make_test_mesh

    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b"), seq=S),
                              dtype=jnp.float32)
    toks = _tokens()
    out = {}
    for method, shape, wire, heads in CASES:
        tag = _tag(method, shape, wire, heads)
        mesh = make_test_mesh(shape, _axes(shape))
        # the model meshes' wire on the reference's plain backend (its
        # tests hold it equal to the Pallas kernels; it compiles faster)
        agg = CompressedAggregation(
            method=method, wire="shared", fraction=FRACTION,
            n_slots=N_SLOTS, shift_dtype=jnp.float32, wire_dtype=wire,
            backend="reference" if shape[-1] > 1 else None)
        jitted, _, shardings, _ = steps.make_train_step(
            _with_heads(cfg, heads), mesh, agg=agg, lr=LR, remat=False,
            seq_shard=False)
        with compat.set_mesh(mesh):
            state = steps.init_train_state(jax.random.key(0),
                                           _with_heads(cfg, heads), agg,
                                           _clients(shape), mesh=mesh)
            for i, x in enumerate(jax.tree.leaves(state)):
                out[f"{tag}/init/{i}"] = np.asarray(x)
            state = jax.device_put(state, shardings)
            for t in range(STEPS):
                args = (state, {"tokens": jnp.asarray(toks[t])},
                        jax.random.key(2))
                if method == "diana_rr":
                    args += (jnp.asarray([t % N_SLOTS], jnp.int32),)
                state, metrics = jitted(*args)
                out[f"{tag}/{t}/loss"] = np.asarray(metrics["loss"])
                out[f"{tag}/{t}/grad_norm"] = np.asarray(metrics["grad_norm"])
                for i, x in enumerate(jax.tree.leaves(state)):
                    out[f"{tag}/{t}/{i}"] = np.asarray(x)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_steps") / "trajectories.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    r = subprocess.run([sys.executable, __file__, str(path)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(path))


def _draws(key_seed: int, step: int, shapes, pods: int, packed=False):
    """The reference's shared-wire draws for one step (from each leaf's
    shard shape): round key fold_in(key, step), leaf i's key
    fold_in(round key, i), the pod level's fold_in(round key,
    POD_KEY_SALT); on a packed wire also each leaf's rounding uniforms
    from fold_in(leaf key, WIRE_QUANT_SALT)."""
    import jax

    from repro.core.salts import POD_KEY_SALT, WIRE_QUANT_SALT

    rkey = jax.random.fold_in(jax.random.key(key_seed), step)

    def level(key):
        out = []
        for i, shp in enumerate(shapes):
            rows = int(np.prod(shp[:-1])) if len(shp) >= 2 else int(np.prod(shp))
            cols = shp[-1] if len(shp) >= 2 else 1
            nb = (rows + (-rows) % 8) // 8
            leaf_key = jax.random.fold_in(key, i)
            draw = {"start": int(jax.random.randint(leaf_key, (), 0, nb))}
            if packed:
                kb = max(1, int(FRACTION * nb))
                draw["quant_u"] = np.array(jax.random.uniform(
                    jax.random.fold_in(leaf_key, WIRE_QUANT_SALT),
                    (kb * 8, cols)))
            out.append(draw)
        return out

    return {"inner": level(rkey),
            "outer": level(jax.random.fold_in(rkey, POD_KEY_SALT))
            if pods > 1 else []}


def _replay(oracle, method, shape, wire, port_shape=None, heads=None):
    """The port's three steps from the reference's initial state of case
    (method, shape, wire), on `port_shape` (default: the same mesh), with
    the draws of the reference's key schedule at the port mesh's
    geometry; on the case's own mesh asserts the loss and the gradient
    norm; returns each state leaf's (what, max abs err, bound)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.api import tree_flatten, tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step

    tag = _tag(method, shape, wire, heads)
    port_shape = shape if port_shape is None else port_shape
    cfg = _with_heads(dataclasses.replace(
        reduced(get_config("stablelm-1.6b"), seq=S), dtype=torch.float32),
        heads)
    mesh = make_mesh(port_shape, _axes(port_shape))
    agg = CompressedAggregation(method=method, fraction=FRACTION,
                                n_slots=N_SLOTS, shift_dtype=torch.float32,
                                wire_dtype=wire)
    step = make_train_step(cfg, mesh, agg=agg, lr=LR, remat=False)
    state = init_train_state(0, cfg, agg, _clients(port_shape), mesh=mesh,
                             device="cpu")
    leaves, unflatten = tree_flatten(state)
    n = len(leaves)
    assert f"{tag}/init/{n - 1}" in oracle and f"{tag}/init/{n}" not in oracle
    state = unflatten([torch.from_numpy(oracle[f"{tag}/init/{i}"].copy())
                       for i in range(n)])
    shapes = shard_shapes(state.params, port_shape[-1])
    pods = port_shape[0] if len(port_shape) == 3 else 1
    packed = wire == "packed8"
    errs = []
    for t, tokens in enumerate(_tokens()):
        slots = [t % N_SLOTS] if method == "diana_rr" else None
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)},
                              None, slots,
                              draws=_draws(2, t, shapes, pods, packed))
        for i, leaf in enumerate(tree_leaves(state)):
            g = leaf.detach().to(torch.float32).numpy()
            w = np.asarray(oracle[f"{tag}/{t}/{i}"], np.float32)
            bound = (2e-2 if packed else 1e-2) * float(np.abs(w).max()) + 1e-6
            errs.append((f"step {t} leaf {i}",
                         float(np.abs(g - w).max()) if w.size else 0.0,
                         bound))
        if port_shape == shape:
            np.testing.assert_allclose(float(metrics["loss"]),
                                       oracle[f"{tag}/{t}/loss"], rtol=1e-5)
            np.testing.assert_allclose(float(metrics["grad_norm"]),
                                       oracle[f"{tag}/{t}/grad_norm"],
                                       rtol=1e-3 if packed else 1e-4)
    return errs


@pytest.mark.parametrize("method,shape,wire,heads", CASES,
                         ids=[_case_id(c) for c in CASES])
def test_train_step_matches_reference(oracle, method, shape, wire, heads):
    if shape[-1] > 1:  # the layers compute by shard, in the attention case
        from repro_torch.launch.sharding import attention_case

        cfg = _with_heads(reduced_cfg(), heads)
        assert attention_case(cfg, shape[-1]) == {
            None: "a", (4, 2, 32): "b", (3, 3, 8): "c"}[heads]
    for what, err, bound in _replay(oracle, method, shape, wire,
                                    heads=heads):
        assert err <= bound, f"{what}: max abs err {err} > {bound}"


def reduced_cfg():
    from repro_torch.configs import get_config, reduced

    return reduced(get_config("stablelm-1.6b"), seq=S)


def test_trainer_default_mesh_replays_the_reference_trainer(oracle):
    """The reference's trainer trains on a (4, 2) mesh
    (src/repro/launch/train.py:380); the port's trainer now builds that
    mesh (`train.train_mesh`), whose steps replay the reference's (4, 2)
    trajectory within the tolerance of this file (DIANA-RR's, the f32
    case above). The port's old default, (4, 1), compresses whole leaves:
    from the same state, tokens and key schedule (at its own geometry) it
    leaves the reference's trajectory, a state leaf off by more than ten
    times the tolerance (the shift tables take other rows)."""
    from repro_torch.launch import train

    mesh = train.train_mesh(train.build_parser().parse_args([]))
    assert mesh.sizes == (4, 2)
    for what, err, bound in _replay(oracle, "diana_rr", (4, 2), "f32",
                                    mesh.sizes):
        assert err <= bound, f"{what}: max abs err {err} > {bound}"
    old = _replay(oracle, "diana_rr", (4, 2), "f32", (4, 1))
    assert max(err / bound for _, err, bound in old) > 10


def test_dense_step_is_sgd_on_the_mean_gradient():
    """The uncompressed wire (its reference program aborts on XLA:CPU, see
    tests/test_launch.py) against the plain computation: every client's
    gradient by autograd, their mean, one SGD step. Tolerance: rtol 1e-6,
    the mean's and the step's roundings."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.api import tree_flatten, tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import transformer

    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b"), seq=S),
                              dtype=torch.float32)
    agg = CompressedAggregation(method="dense")
    state = init_train_state(0, cfg, agg, 4, mesh=make_mesh((4, 1)),
                             device="cpu")
    tokens = torch.from_numpy(_tokens()[0])
    leaves, unflatten = tree_flatten(state.params)
    grads = []
    for c in range(4):
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss = transformer.loss_fn(unflatten(req),
                                   {"tokens": tokens[2 * c:2 * c + 2]}, cfg,
                                   remat=False)
        grads.append(torch.autograd.grad(loss, req))
    want = [p - LR * torch.stack(g).mean(0) for p, g in zip(leaves, zip(*grads))]
    step = make_train_step(cfg, make_mesh((4, 1)), agg=agg, lr=LR,
                           remat=False)
    new, metrics = step(state, {"tokens": tokens}, None)
    assert torch.isfinite(metrics["loss"]) and int(new.step) == 1
    for got, w in zip(tree_leaves(new.params), want):
        torch.testing.assert_close(got, w, rtol=1e-6, atol=1e-7)


def test_step_refuses_what_is_not_ported():
    """NASTYA, the elastic weights, the debug metrics, every model family,
    the streaming CE and the prefill and serve steps are ported; what the
    step still refuses is what the reference refuses (elastic NASTYA, eta
    without local steps, weights that do not match the step, batches not
    divisible into the clients' micro-batches, a slot-less per-slot step),
    and a wire at T = 2 model shards that was not told which axis of each
    leaf the shards split."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (
        configure_agg,
        make_prefill_step,
        make_serve_step,
        make_train_step,
    )
    from repro_torch.models import transformer

    cfg = reduced(get_config("stablelm-1.6b"))
    mesh = make_mesh((4, 1))
    agg = CompressedAggregation(method="diana")
    with pytest.raises(ValueError, match="local_steps == 1"):
        make_train_step(cfg, mesh, agg=agg, local_steps=2, elastic=True)
    with pytest.raises(ValueError, match="eta"):
        make_train_step(cfg, mesh, agg=agg, eta=0.1)
    step = make_train_step(cfg, mesh, agg=dataclasses.replace(
        agg, method="diana_rr"))
    with pytest.raises(ValueError, match="slot"):
        step(None, {"tokens": torch.zeros(8, 5, dtype=torch.int64)}, None)
    with pytest.raises(ValueError, match="divisible"):
        step(None, {"tokens": torch.zeros(6, 5, dtype=torch.int64)}, None)
    nastya = make_train_step(cfg, mesh, agg=agg, local_steps=2, eta=0.1)
    with pytest.raises(ValueError, match="m\\*local_steps"):
        nastya(None, {"tokens": torch.zeros(4, 5, dtype=torch.int64)}, None)
    with pytest.raises(ValueError, match="elastic=True"):
        make_train_step(cfg, mesh, agg=agg)(
            None, {"tokens": torch.zeros(8, 5, dtype=torch.int64)}, None,
            None, torch.ones(4))
    elastic = make_train_step(cfg, mesh, agg=agg, elastic=True)
    with pytest.raises(ValueError, match="weights"):
        elastic(None, {"tokens": torch.zeros(8, 5, dtype=torch.int64)}, None)
    tp = configure_agg(agg, make_mesh((2, 2)))  # T = 2, no split axes
    with pytest.raises(ValueError, match="split axis"):
        tp.aggregate({"w": torch.zeros(2, 8, 4)},
                     tp.init({"w": torch.zeros(8, 4)}, 2), None)
    assert callable(make_train_step(cfg, mesh, agg=agg, ce="streaming"))
    with pytest.raises(ValueError, match="unknown ce"):
        make_train_step(cfg, mesh, agg=agg, ce="vocab")
    loss = transformer.loss_fn(
        transformer.init_params(0, cfg, "cpu"),
        {"tokens": torch.zeros(2, 5, dtype=torch.int64)}, cfg,
        ce="streaming")
    assert loss.shape == () and torch.isfinite(loss)
    assert callable(make_prefill_step(cfg, cache_len=16))
    assert callable(make_serve_step(cfg))


def test_full_width_state_layout_on_meta():
    """The full-width stablelm-1.6b state, shapes only: the reference's
    parameter count, and the DIANA-RR tables the train path allocates."""
    from repro_torch.configs import get_config
    from repro_torch.core.api import tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state

    cfg = get_config("stablelm-1.6b")
    agg = CompressedAggregation(method="diana_rr", n_slots=2)
    state = init_train_state(0, cfg, agg, 4, mesh=make_mesh((4, 1)),
                             device="meta")
    n = sum(p.numel() for p in tree_leaves(state.params))
    assert n == 1_644_367_872  # 24 layers of 2048/5632, untied 100352 vocab
    assert cfg.param_count() == n - 2 * 2048 * 24 - 2 * 2048
    assert all(s.shape[:2] == (4, 2) and s.dtype == torch.bfloat16
               for s in tree_leaves(state.shifts))
    assert all(s.shape[0] == 2 for s in tree_leaves(state.mean_shift))


if __name__ == "__main__":
    _oracle(sys.argv[1])
