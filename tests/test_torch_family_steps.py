"""The port's train step on the ssm, hybrid and audio families against the
JAX reference's `make_train_step`: reduced rwkv6-7b (f32 leaves of its
own, `w0`, `u` and `ln_out`, on the wire) and reduced whisper-medium (the
`frames` leaf of the batch through the per-client split), each on the DIANA
f32 wire and on the packed8 wire, two steps on a flat (4, 1) mesh; then
with 2-way tensor parallelism, DIANA-RR on the f32 wire on a (2, 2) mesh
for reduced rwkv6-7b, reduced whisper-medium and an odd-head hymba (5
heads of 16 over 1 kv head, d_model 80, 5 SSD heads: at T = 2 it takes
attention case c, `ln` split on its last axis and a whole `wdt`, as
hymba-1.5b's 25 heads do; the plain reduced hymba's 4 heads would take
case b), where the reference's GSPMD partitions the layers and its wire
compresses each model shard's block, and the port's layers compute on
their model shards and its wire compresses each split leaf shard by
shard, the draws from a shard's geometry (tests/_torch_harness.py).

Both sides run at f32 from the same initial state, tokens, frames and wire
draws (window starts and, on packed8, the rounding uniforms, from the
reference's key schedule). As in tests/test_torch_steps.py the reference's
trajectories are computed in one subprocess (this file run as a script),
because XLA:CPU aborts when several multi-device transformer programs run
in one test process.

Tolerances: on the f32 wire (flat and (2, 2)) those of
tests/test_torch_steps.py, for the same reasons: each leaf within 1e-2 of
its largest entry (the attentions round their probabilities and values to
bf16, as the reference does), the loss to rtol 1e-5 and the gradient norm
to rtol 1e-4.
On packed8 a last-bit difference in a payload also flips a stochastic
rounding that lies near a lattice midpoint, which moves that rank's decoded
value by one lattice step, 1/127 of its row's largest slab value: each leaf
is held to 2e-2 of its largest entry, the f32 bound plus one such step
(measured worst: rwkv6 3.6e-5 on f32 and 8.7e-3 on packed8, whisper 3.5e-3
and 1.32e-2; on (2, 2) by shard rwkv6 8.8e-5, hymba 8.0e-4 and whisper
3.5e-3 of the leaf's largest entry).

The MoE family is held at the loss and gradient level
(tests/test_torch_families.py): the reference's train step takes the
clients' gradients under `jax.vmap`, and `lax.ragged_dot_general` has no
batching rule on jax 0.9.0.
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
S, B, STEPS, LR, FRACTION = 16, 8, 2, 0.05, 0.25
CASES = [("rwkv6-7b", "f32"), ("rwkv6-7b", "packed8"),
         ("whisper-medium", "f32"), ("whisper-medium", "packed8")]
# DIANA-RR on the f32 wire over 2 clients of 2 model shards
TP_CASES = ["rwkv6-7b", "hymba-odd", "whisper-medium"]
TP_SHAPE, N_SLOTS = (2, 2), 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _config(get_config, reduced, name, dtype):
    """The reduced config of `name` at f32 ("hymba-odd": 5 heads of 16 over
    1 kv head, d_model 80, 5 SSD heads), from either package."""
    if name == "hymba-odd":
        return dataclasses.replace(reduced(get_config("hymba-1.5b"), seq=S),
                                   num_heads=5, num_kv_heads=1, head_dim=16,
                                   d_model=80, ssm_heads=5, dtype=dtype)
    return dataclasses.replace(reduced(get_config(name), seq=S), dtype=dtype)


def _batches(name):
    """Per step: tokens (B, S + 1), and whisper's frames (B, 24, 128)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, 503, (B, S + 1)).astype(np.int32)}
        if name == "whisper-medium":
            b["frames"] = rng.standard_normal((B, 24, 128)).astype(np.float32)
        out.append(b)
    return out


def _oracle(out_path: str) -> None:
    """The reference's trajectories for every case (run in a subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced
    from repro.core.dist import CompressedAggregation
    from repro.launch import compat, steps
    from repro.launch.mesh import make_test_mesh

    out = {}
    for name, wire in CASES:
        tag = f"{name}-{wire}"
        cfg = dataclasses.replace(reduced(get_config(name), seq=S),
                                  dtype=jnp.float32)
        mesh = make_test_mesh((4, 1), ("data", "model"))
        agg = CompressedAggregation(method="diana", wire="shared",
                                    fraction=FRACTION, wire_dtype=wire,
                                    shift_dtype=jnp.float32)
        jitted, _, shardings, _ = steps.make_train_step(
            cfg, mesh, agg=agg, lr=LR, remat=False, seq_shard=False)
        with compat.set_mesh(mesh):
            state = steps.init_train_state(jax.random.key(0), cfg, agg, 4,
                                           mesh=mesh)
            for i, x in enumerate(jax.tree.leaves(state)):
                out[f"{tag}/init/{i}"] = np.asarray(x)
            state = jax.device_put(state, shardings)
            for t, batch in enumerate(_batches(name)):
                state, metrics = jitted(
                    state, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.key(2))
                out[f"{tag}/{t}/loss"] = np.asarray(metrics["loss"])
                out[f"{tag}/{t}/grad_norm"] = np.asarray(metrics["grad_norm"])
                for i, x in enumerate(jax.tree.leaves(state)):
                    out[f"{tag}/{t}/{i}"] = np.asarray(x)
    for name in TP_CASES:
        tag = f"{name}-tp"
        cfg = _config(get_config, reduced, name, jnp.float32)
        mesh = make_test_mesh(TP_SHAPE, ("data", "model"))
        # the wire on the reference's plain backend (its tests hold it
        # equal to the Pallas kernels; it compiles faster)
        agg = CompressedAggregation(method="diana_rr", wire="shared",
                                    fraction=FRACTION, n_slots=N_SLOTS,
                                    shift_dtype=jnp.float32,
                                    backend="reference")
        jitted, _, shardings, _ = steps.make_train_step(
            cfg, mesh, agg=agg, lr=LR, remat=False, seq_shard=False)
        with compat.set_mesh(mesh):
            state = steps.init_train_state(jax.random.key(0), cfg, agg,
                                           TP_SHAPE[0], mesh=mesh)
            for i, x in enumerate(jax.tree.leaves(state)):
                out[f"{tag}/init/{i}"] = np.asarray(x)
            state = jax.device_put(state, shardings)
            for t, batch in enumerate(_batches(name)):
                state, metrics = jitted(
                    state, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.key(2), jnp.asarray([t % N_SLOTS], jnp.int32))
                out[f"{tag}/{t}/loss"] = np.asarray(metrics["loss"])
                out[f"{tag}/{t}/grad_norm"] = np.asarray(metrics["grad_norm"])
                for i, x in enumerate(jax.tree.leaves(state)):
                    out[f"{tag}/{t}/{i}"] = np.asarray(x)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_family_steps") / "trajectories.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    r = subprocess.run([sys.executable, __file__, str(path)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(path))


def _draws(step: int, shapes, packed: bool):
    """The reference's draws for one flat step: round key fold_in(key,
    step), leaf i's key fold_in(round key, i): the window start, and on a
    quantized slab the uniforms from fold_in(leaf key, WIRE_QUANT_SALT)."""
    import jax

    from repro.core.salts import WIRE_QUANT_SALT

    rkey = jax.random.fold_in(jax.random.key(2), step)
    out = []
    for i, shp in enumerate(shapes):
        rows = int(np.prod(shp[:-1])) if len(shp) >= 2 else int(np.prod(shp))
        cols = shp[-1] if len(shp) >= 2 else 1
        nb = (rows + (-rows) % 8) // 8
        kb = max(1, int(FRACTION * nb))
        key = jax.random.fold_in(rkey, i)
        draw = {"start": int(jax.random.randint(key, (), 0, nb))}
        if packed:
            draw["quant_u"] = np.array(jax.random.uniform(
                jax.random.fold_in(key, WIRE_QUANT_SALT), (kb * 8, cols)))
        out.append(draw)
    return {"inner": out, "outer": []}


def _close(got: torch.Tensor, want: np.ndarray, what: str, rel: float):
    g = got.detach().to(torch.float32).numpy()
    w = np.asarray(want, np.float32)
    bound = rel * float(np.abs(w).max()) + 1e-6
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


@pytest.mark.parametrize("name", TP_CASES)
def test_family_step_by_shard_matches_reference(oracle, name):
    """Two DIANA-RR steps on the (2, 2) mesh from the reference's initial
    state, tokens and frames, the draws of its key schedule at a shard's
    geometry: the loss to rtol 1e-5, the gradient norm to rtol 1e-4 and
    every state leaf within 1e-2 of its largest entry, as on the flat
    mesh. The layers compute by shard (attention case a for rwkv6's time
    mix and whisper, c for the odd-head hymba)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.api import tree_flatten, tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import attention_case, model_layout
    from repro_torch.launch.steps import init_train_state, make_train_step

    tag = f"{name}-tp"
    cfg = _config(get_config, reduced, name, torch.float32)
    assert attention_case(cfg, 2) == ("c" if name == "hymba-odd" else "a")
    assert "compute by shard" in model_layout(cfg, 2)
    mesh = make_mesh(TP_SHAPE, ("data", "model"))
    agg = CompressedAggregation(method="diana_rr", fraction=FRACTION,
                                n_slots=N_SLOTS, shift_dtype=torch.float32)
    step = make_train_step(cfg, mesh, agg=agg, lr=LR, remat=False)
    state = init_train_state(0, cfg, agg, TP_SHAPE[0], mesh=mesh,
                             device="cpu")
    leaves, unflatten = tree_flatten(state)
    n = len(leaves)
    assert f"{tag}/init/{n - 1}" in oracle and f"{tag}/init/{n}" not in oracle
    state = unflatten([torch.from_numpy(oracle[f"{tag}/init/{i}"].copy())
                       for i in range(n)])
    shapes = shard_shapes(state.params, TP_SHAPE[-1])
    for t, batch in enumerate(_batches(name)):
        state, metrics = step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
            [t % N_SLOTS], draws=_draws(t, shapes, False))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   oracle[f"{tag}/{t}/loss"], rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   oracle[f"{tag}/{t}/grad_norm"], rtol=1e-4)
        for i, leaf in enumerate(tree_leaves(state)):
            _close(leaf, oracle[f"{tag}/{t}/{i}"], f"step {t} leaf {i}", 1e-2)


@pytest.mark.parametrize("name,wire", CASES,
                         ids=[f"{n}-{w}" for n, w in CASES])
def test_family_train_step_matches_reference(oracle, name, wire):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.api import tree_flatten, tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step

    tag = f"{name}-{wire}"
    cfg = dataclasses.replace(reduced(get_config(name), seq=S),
                              dtype=torch.float32)
    mesh = make_mesh((4, 1), ("data", "model"))
    agg = CompressedAggregation(method="diana", fraction=FRACTION,
                                wire_dtype=wire, shift_dtype=torch.float32)
    step = make_train_step(cfg, mesh, agg=agg, lr=LR, remat=False)
    state = init_train_state(0, cfg, agg, 4, mesh=mesh, device="cpu")
    leaves, unflatten = tree_flatten(state)
    n = len(leaves)
    assert f"{tag}/init/{n - 1}" in oracle and f"{tag}/init/{n}" not in oracle
    state = unflatten([torch.from_numpy(oracle[f"{tag}/init/{i}"].copy())
                       for i in range(n)])
    shapes = [tuple(p.shape) for p in tree_leaves(state.params)]
    for t, batch in enumerate(_batches(name)):
        state, metrics = step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
            draws=_draws(t, shapes, wire == "packed8"))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   oracle[f"{tag}/{t}/loss"], rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   oracle[f"{tag}/{t}/grad_norm"], rtol=1e-4)
        for i, leaf in enumerate(tree_leaves(state)):
            _close(leaf, oracle[f"{tag}/{t}/{i}"], f"step {t} leaf {i}",
                   2e-2 if wire == "packed8" else 1e-2)


FAMILY_LEAVES = {"qwen2-moe-a2.7b": ("router",), "rwkv6-7b": ("w0", "u",
                                                                "ln_out"),
                 "hymba-1.5b": ("a_log", "ln", "ln_attn"),
                 "whisper-medium": ("pos_embed",)}


@pytest.mark.parametrize("name", sorted(FAMILY_LEAVES))
def test_mixed_dtype_leaves_keep_their_dtypes(name):
    """bf16 models with f32 leaves (the router, w0, u, ln_out, a_log, ln,
    ln_attn): a reference TrainState converts bit for bit with every dtype
    kept and has the layout of the port's own; a step on each of the four
    transports keeps each parameter's dtype and the tables' shift dtype,
    with a finite loss."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.core.dist import CompressedAggregation as JaxAgg
    from repro.launch import steps as jax_steps
    from repro_torch import convert
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.api import tree_flatten, tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step

    cfg = reduced(get_config(name), seq=S)
    jstate = jax.device_get(jax_steps.init_train_state(
        jax.random.key(1), jax_reduced(jax_get_config(name), seq=S),
        JaxAgg(method="diana_rr", n_slots=2), 4))
    got = convert.train_state_from_jax(jstate, "cpu")
    mine = init_train_state(0, cfg, CompressedAggregation(
        method="diana_rr", n_slots=2), 4, device="cpu")
    for g, w, m in zip(tree_leaves(got), jax.tree.leaves(jstate),
                       tree_leaves(mine)):
        w = np.asarray(w)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert g.dtype == m.dtype and g.shape == m.shape
        np.testing.assert_array_equal(g.to(torch.float32).numpy(),
                                      w.astype(np.float32))
    dtypes = {p: str(x.dtype) for p, x in
              zip(_names(got.params), tree_leaves(got.params))}
    for leaf in FAMILY_LEAVES[name]:
        if leaf != "pos_embed":
            assert {v for k, v in dtypes.items() if k.endswith(f"/{leaf}")} \
                == {"torch.float32"}, leaf
    batch = _batches("whisper-medium")[0]
    batch = {k: torch.from_numpy(v) for k, v in batch.items()
             if k == "tokens" or cfg.is_encdec}
    if cfg.is_encdec:
        batch["frames"] = batch["frames"].to(torch.bfloat16)
    for wire in ("f32", "bf16", "packed8", "packed4"):
        agg = CompressedAggregation(method="diana", fraction=FRACTION,
                                    wire_dtype=wire, backend="reference")
        state = init_train_state(0, cfg, agg, 4, mesh=make_mesh((4, 1)),
                                 device="cpu")
        before = [x.dtype for x in tree_leaves(state)]
        state, metrics = make_train_step(cfg, make_mesh((4, 1)), agg=agg,
                                         lr=LR, remat=False)(
            state, batch, torch.Generator().manual_seed(0))
        assert torch.isfinite(metrics["loss"]), wire
        assert [x.dtype for x in tree_leaves(state)] == before, wire
        assert all(s.dtype == torch.bfloat16
                   for s in tree_leaves(state.shifts))


def _names(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += (_names(v, f"{prefix}/{k}") if isinstance(v, dict)
                else [f"{prefix}/{k}"])
    return out


if __name__ == "__main__":
    _oracle(sys.argv[1])
