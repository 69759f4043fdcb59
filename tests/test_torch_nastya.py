"""The port's NASTYA, elastic and debug-metrics train steps
(`repro_torch.launch.steps`) against the JAX reference's `make_train_step`.

Both sides run the reduced stablelm-1.6b (2 layers, d_model 128) at f32 on
the same initial state, tokens, micro-batch permutations and wire draws for
three steps:

- Q-NASTYA and DIANA-NASTYA (`local_steps=2`, eta set) on the flat (4, 1)
  mesh, where every client is its own pod (Algorithms 4-5 exactly), the
  DIANA case with `debug_metrics`;
- DIANA-RR NASTYA on two pods of two clients, whose local steps use each
  pod's own slot after its own permutation;
- the elastic DIANA step (`local_steps=1`) with weights (1, 0, 0.5, 1) and
  `debug_metrics`;
- DIANA-RR on the packed8 wire on two pods of two clients (`local_steps=1`),
  both levels packed, with the rounding uniforms of each level's key;
- with 2-way tensor parallelism (each split leaf compressed shard by
  shard, the draws made from a shard's geometry): flat Q-NASTYA with
  `debug_metrics` on the reference's (4, 2) mesh (f32 wire), and two-pod
  Q-NASTYA on its (2, 2, 2) mesh on the packed8 wire.

As in tests/test_torch_steps.py, the reference's trajectories come from one
subprocess (this file run as a script), and the port replays the
reference's key schedule: round key fold_in(key, step); pod p's permutation
from fold_in(fold_in(round key, NASTYA_PERM_SALT), p); local step t's wire
from fold_in(round key, NASTYA_LOCAL_SALT + t); the outer level from
fold_in(round key, POD_KEY_SALT).

Tolerance: as tests/test_torch_steps.py (the frameworks sum in different
orders, XLA contracts multiply-adds, and the attention rounds to bf16):
each leaf within 1e-2 of its largest entry (measured worst after three
steps: 6.7e-3, DIANA-NASTYA), the loss to rtol 1e-5 (worst 9.2e-6), the
gradient norm and the debug metrics to rtol 1e-4 on the elastic step
(worst 9.0e-5). On the packed8 case a last-bit payload difference can flip
a stochastic rounding near a lattice midpoint, one lattice step of its
row: each leaf is held to 2e-2 of its largest entry, the bound of
tests/test_torch_family_steps.py (measured worst 1.75e-2 at step 3; the
step-1 leaves differ by at most 8.6e-3, about one lattice step, 1/127, in
a few dozen of each leaf's elements), and the gradient norm, which the
flipped parameters of steps 1-2 feed, to rtol 1e-3 (measured 1.8e-4 at
step 3; the loss agrees to 5.2e-6). The packed8 Q-NASTYA case's loss is
the mean of its local steps' losses, the second taken at an iterate that
the first step's packed exchange moved, so a flipped rounding reaches it:
it is held to rtol 1e-4 (measured 1.27e-5 at its worst step). On
the NASTYA steps the gradient norm and the debug metrics are those of the
epoch gradient (x_t - x_t^n) / (gamma * n), whose cancellation multiplies
a last-bit difference of the iterate by |x| / (gamma * n * |g|), about 1e3
for the layer-norm scales (1.0) here; and XLA computes x - gamma * d as one
fused multiply-add and the division by gamma * n as a multiply by its
reciprocal, where the port rounds twice and divides exactly (ROADMAP Queue
C). They are held to rtol 1e-3 (measured worst 3.0e-4; with the port
patched to round once and multiply by the reciprocal, the two-pod case
agreed to 2e-6).

The rest holds claims on the port alone: the elastic step with all-ones
weights is the non-elastic step bit for bit, and the NASTYA step equals the
simulator's q_nastya / diana_nastya (the port's copy of
tests/test_pod_wire.py::test_pod_nastya_matches_simulator).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread
from _torch_harness import shard_shapes

ROOT = Path(__file__).resolve().parents[1]
S, STEPS, LR, ETA, FRACTION, N_SLOTS = 8, 3, 0.05, 0.1, 0.25, 2
WEIGHTS = (1.0, 0.0, 0.5, 1.0)
# (tag, method, mesh shape, local_steps, elastic, debug_metrics, wire dtype)
CASES = [("q-flat", "q", (4, 1), 2, False, False, "f32"),
         ("diana-flat", "diana", (4, 1), 2, False, True, "f32"),
         ("diana_rr-2pod", "diana_rr", (2, 2, 1), 2, False, False, "f32"),
         ("diana-elastic", "diana", (4, 1), 1, True, True, "f32"),
         ("diana_rr-packed8-2pod", "diana_rr", (2, 2, 1), 1, False, False,
          "packed8"),
         # 2-way tensor parallelism: each split leaf compressed per shard
         ("q-flat-4x2", "q", (4, 2), 2, False, True, "f32"),
         ("q-packed8-2pod-2x2x2", "q", (2, 2, 2), 2, False, False,
          "packed8")]
DEBUG_KEYS = ("compression_err_sq", "direction_norm_sq", "shift_norm_sq",
              "mean_shift_norm_sq")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def _tokens(local_steps):
    """Client-major rows: 4 clients x local_steps micro-batches x 1."""
    rng = np.random.default_rng(local_steps)
    return [rng.integers(0, 503, (4 * local_steps, S + 1)).astype(np.int32)
            for _ in range(STEPS)]


def _slots(method, t, local_steps):
    if method != "diana_rr":
        return None
    return np.array([(t + j) % N_SLOTS for j in range(local_steps)], np.int32)


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
    out = {}
    for tag, method, shape, ls, elastic, debug, wire in CASES:
        mesh = make_test_mesh(shape, _axes(shape))
        # the model meshes' wire on the reference's plain backend (its
        # tests hold it equal to the Pallas kernels; it compiles faster)
        agg = CompressedAggregation(
            method=method, wire="shared", fraction=FRACTION,
            n_slots=N_SLOTS, shift_dtype=jnp.float32, wire_dtype=wire,
            backend="reference" if shape[-1] > 1 else None)
        jitted, _, shardings, _ = steps.make_train_step(
            cfg, mesh, agg=agg, lr=LR, eta=ETA if ls > 1 else None,
            local_steps=ls, remat=False, seq_shard=False, elastic=elastic,
            debug_metrics=debug)
        with compat.set_mesh(mesh):
            state = steps.init_train_state(jax.random.key(0), cfg, agg, 4,
                                           mesh=mesh, local_steps=ls)
            for i, x in enumerate(jax.tree.leaves(state)):
                out[f"{tag}/init/{i}"] = np.asarray(x)
            state = jax.device_put(state, shardings)
            for t, toks in enumerate(_tokens(ls)):
                args = (state, {"tokens": jnp.asarray(toks)},
                        jax.random.key(2))
                if method == "diana_rr":
                    args += (jnp.asarray(_slots(method, t, ls)),)
                if elastic:
                    args += (jnp.asarray(WEIGHTS, jnp.float32),)
                state, metrics = jitted(*args)
                for k, v in metrics.items():
                    out[f"{tag}/{t}/{k}"] = np.asarray(v)
                for i, x in enumerate(jax.tree.leaves(state)):
                    out[f"{tag}/{t}/{i}"] = np.asarray(x)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_nastya") / "trajectories.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    r = subprocess.run([sys.executable, __file__, str(path)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(path))


def _draws(step: int, shapes, shape, local_steps: int, packed=False):
    """The reference's draws for one step: the per-pod permutations and the
    shared-wire window starts of each level; on a packed wire also each
    leaf's rounding uniforms, from fold_in(leaf key, WIRE_QUANT_SALT)."""
    import jax

    from repro.core.salts import (
        NASTYA_LOCAL_SALT,
        NASTYA_PERM_SALT,
        POD_KEY_SALT,
        WIRE_QUANT_SALT,
    )

    rkey = jax.random.fold_in(jax.random.key(2), step)

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

    two_pod = len(shape) == 3
    outer = level(jax.random.fold_in(rkey, POD_KEY_SALT))
    if local_steps == 1:
        return {"inner": level(rkey), "outer": outer if two_pod else []}
    pods = shape[0] if two_pod else int(np.prod(shape[:-1]))
    base = jax.random.fold_in(rkey, NASTYA_PERM_SALT)
    perm = np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(base, p), local_steps)) for p in range(pods)])
    inner = [level(jax.random.fold_in(rkey, NASTYA_LOCAL_SALT + t))
             if two_pod else [] for t in range(local_steps)]
    return {"perm": perm, "inner": inner, "outer": outer}


def _close(got: torch.Tensor, want: np.ndarray, what: str, rel=1e-2):
    g = got.detach().to(torch.float32).numpy()
    w = np.asarray(want, np.float32)
    bound = rel * float(np.abs(w).max()) + 1e-6
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


def _cfg():
    from repro_torch.configs import get_config, reduced

    return dataclasses.replace(reduced(get_config("stablelm-1.6b"), seq=S),
                               dtype=torch.float32)


@pytest.mark.parametrize("tag,method,shape,ls,elastic,debug,wire", CASES,
                         ids=[c[0] for c in CASES])
def test_step_matches_reference(oracle, tag, method, shape, ls, elastic,
                                debug, wire):
    from repro_torch.core.api import tree_flatten, tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step

    cfg = _cfg()
    mesh = make_mesh(shape, _axes(shape))
    agg = CompressedAggregation(method=method, fraction=FRACTION,
                                n_slots=N_SLOTS, shift_dtype=torch.float32,
                                wire_dtype=wire)
    step = make_train_step(cfg, mesh, agg=agg, lr=LR,
                           eta=ETA if ls > 1 else None, local_steps=ls,
                           remat=False, elastic=elastic, debug_metrics=debug)
    state = init_train_state(0, cfg, agg, 4, mesh=mesh, local_steps=ls,
                             device="cpu")
    leaves, unflatten = tree_flatten(state)
    n = len(leaves)
    assert f"{tag}/init/{n - 1}" in oracle and f"{tag}/init/{n}" not in oracle
    state = unflatten([torch.from_numpy(oracle[f"{tag}/init/{i}"].copy())
                       for i in range(n)])
    shapes = shard_shapes(state.params, shape[-1])
    weights = torch.tensor(WEIGHTS) if elastic else None
    for t, tokens in enumerate(_tokens(ls)):
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)},
                              None, _slots(method, t, ls), weights,
                              draws=_draws(t, shapes, shape, ls,
                                           packed=wire == "packed8"))
        # a packed8 NASTYA epoch's second local step runs on an iterate
        # that the first one's stochastic rounding moved
        np.testing.assert_allclose(
            float(metrics["loss"]), oracle[f"{tag}/{t}/loss"],
            rtol=1e-4 if ls > 1 and wire == "packed8" else 1e-5)
        rtol = 1e-3 if ls > 1 or wire == "packed8" else 1e-4
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   oracle[f"{tag}/{t}/grad_norm"], rtol=rtol)
        assert set(metrics) == {"loss", "grad_norm",
                                *(DEBUG_KEYS if debug else ())}
        for k in DEBUG_KEYS if debug else ():
            np.testing.assert_allclose(float(metrics[k]),
                                       oracle[f"{tag}/{t}/{k}"], rtol=rtol,
                                       atol=1e-6, err_msg=k)
        for i, leaf in enumerate(tree_leaves(state)):
            _close(leaf, oracle[f"{tag}/{t}/{i}"], f"step {t} leaf {i}",
                   2e-2 if wire == "packed8" else 1e-2)


def test_elastic_unit_weights_are_the_plain_step():
    """All-ones weights give the non-elastic step bit for bit, two steps of
    DIANA-RR on two pods with the step's own draws (x * 1.0 is exact)."""
    from repro_torch.core.api import tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step

    cfg = _cfg()
    mesh = make_mesh((2, 2, 1), _axes((2, 2, 1)))
    agg = CompressedAggregation(method="diana_rr", fraction=FRACTION,
                                n_slots=N_SLOTS, wire_dtype="packed8")
    runs = []
    for elastic in (False, True):
        step = make_train_step(cfg, mesh, agg=agg, lr=LR, remat=False,
                               elastic=elastic)
        state = init_train_state(0, cfg, agg, 4, mesh=mesh, device="cpu")
        gen = torch.Generator().manual_seed(5)
        for t, tokens in enumerate(_tokens(1)[:2]):
            args = (state, {"tokens": torch.from_numpy(tokens)}, gen, [t % 2])
            state, metrics = step(*args, torch.ones(4) if elastic else None)
        runs.append((tree_leaves(state), metrics))
    (a, ma), (b, mb) = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(ma["loss"], mb["loss"])


@pytest.mark.parametrize("name", ["q_nastya", "diana_nastya"])
def test_pod_nastya_matches_simulator(name):
    """The port's copy of tests/test_pod_wire.py::
    test_pod_nastya_matches_simulator: the simulator's q_nastya /
    diana_nastya epoch and the production NASTYA step give the same
    trajectory on a tiny problem: 4 clients, each its own pod on the flat
    mesh; every local micro-batch identical, so the two implementations'
    RR orders cannot diverge; fraction 1.0, where both compressors are
    exact; the same gamma, eta and alpha. Tolerance as the reference's:
    atol 2e-4, rtol 2e-3 (different reduction orders: the simulator's
    vmapped gradients against the step's per-client loop)."""
    from repro_torch.compression.ops import RandK
    from repro_torch.core.algorithms import (
        ALGORITHMS,
        init_algorithm,
        make_epoch_fn,
    )
    from repro_torch.core.api import tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import transformer

    cfg, m, local_steps = _cfg(), 4, 3
    gamma, eta, alpha = 0.02, 0.05, 0.5
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(m, 1, S + 1)).astype(np.int64))
    sim_data = {"tokens": tokens[:, None].expand(
        m, local_steps, 1, S + 1).contiguous()}

    def loss_fn(p, b):
        return transformer.loss_fn(p, b, cfg, remat=False)

    params0 = transformer.init_params(0, cfg, "cpu")
    _, epoch = make_epoch_fn(name, loss_fn, RandK(fraction=1.0), gamma=gamma,
                             eta=eta, alpha=alpha, backend="cuda")
    sim = init_algorithm(ALGORITHMS[name], params0, m, local_steps)
    for e in range(2):
        sim = epoch(sim, sim_data, torch.Generator().manual_seed(10 + e))

    mesh = make_mesh((m, 1))
    agg = CompressedAggregation(method="diana" if name == "diana_nastya"
                                else "q", fraction=1.0, alpha=alpha,
                                pod_alpha=alpha, shift_dtype=torch.float32)
    step = make_train_step(cfg, mesh, agg=agg, lr=gamma, eta=eta,
                           local_steps=local_steps, remat=False)
    state = init_train_state(0, cfg, agg, m, mesh=mesh,
                             local_steps=local_steps, device="cpu")
    batch = {"tokens": tokens[:, 0].repeat_interleave(local_steps, dim=0)}
    for e in range(2):
        state, _ = step(state, batch, torch.Generator().manual_seed(10 + e))
    for a, b in zip(tree_leaves(sim.params), tree_leaves(state.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=2e-3)


if __name__ == "__main__":
    _oracle(sys.argv[1])
