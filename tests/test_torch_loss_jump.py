"""The loss jump of DIANA-RR on two pods (ROADMAP C5), held to the reference.

On the H100, stablelm-1.6b's packed8 DIANA-RR on two pods of two clients
(`chip_smoke.py` phase 7's sweep: 2 layers, k/d = 0.02, lr 0.05, 4 clients
of 2 x 128 tokens, 2 shift slots, the config's bf16 parameters) ended its
third step at 19.17 from 11.97, where the same step on one level, or on the
f32 wire, fell. `chip_smoke.py --loss-jump` cut the width: with d_model
256 and a vocabulary of 1,568 the packed8 and f32@127 wires still jump on
two pods (7.41 to 14.38), narrower ones do not, and no width jumps on one
level. The jump comes and goes with the random draws: on the host the port
and the reference each jump for some seeds and not for others.

Here, at that width, the reference's own `make_train_step` runs from its
key 8, where its loss rises from 7.41 to 8.81 on the packed8 wire (and to
8.82 on the f32 wire), and the port replays it from the reference's
initial state with the same tokens, slots, window starts and rounding
uniforms (the reference's key schedule, as tests/test_torch_nastya.py
draws it). The port must follow the reference's trajectory, jump included:
the jump is the method's at this stepsize (two levels of Rand-k at k/d =
0.02, each scaling its window by nb / kb = 50), not a fault of the port.

Tolerance: as tests/test_torch_nastya.py's packed8 case, the loss to rtol
1e-3 (bf16 parameters here, where that file's are f32; measured worst
6.3e-4 on packed8 at step 3, 8.1e-5 on f32), and the rise itself to within
5% of the reference's (measured 0.4%).
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

ROOT = Path(__file__).resolve().parents[1]
D_MODEL, VOCAB, SEQ, BATCH, STEPS = 256, 1568, 128, 2, 3
LR, FRACTION, N_SLOTS, KEY = 0.05, 0.02, 2, 8
WIRES = ("packed8", "f32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _cfg(get_config, dtype):
    full = get_config("stablelm-1.6b")
    heads = D_MODEL // full.head_dim
    return dataclasses.replace(full, num_layers=2, d_model=D_MODEL,
                               num_heads=heads, num_kv_heads=heads,
                               d_ff=D_MODEL * 11 // 4, vocab=VOCAB,
                               dtype=dtype)


def _batches():
    """`chip_smoke.py`'s train batches: each step's client-major rows and
    its rr_shared slot."""
    from repro_torch.data.pipeline import shared_slots_for_step
    from repro_torch.data.reshuffle import ReshuffleSampler
    from repro_torch.data.tokens import synthetic_token_batches

    toks = synthetic_token_batches(vocab=VOCAB, seq_len=SEQ, batch=BATCH,
                                   num_batches=N_SLOTS, num_clients=4, seed=0)
    sampler = ReshuffleSampler(4, N_SLOTS, mode="rr_shared", seed=0)
    out = []
    for t in range(STEPS):
        slots = np.asarray(shared_slots_for_step(sampler, t, 1,
                                                 n_slots=N_SLOTS), np.int32)
        out.append((np.ascontiguousarray(toks[:, slots].reshape(-1, SEQ + 1)),
                    slots))
    return out


def _oracle(out_path: str) -> None:
    """The reference's trajectory on each wire (run in a subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core.dist import CompressedAggregation
    from repro.launch import compat, steps
    from repro.launch.mesh import make_test_mesh

    cfg = _cfg(get_config, jnp.bfloat16)
    mesh = make_test_mesh((2, 2, 1), ("pod", "data", "model"))
    out = {}
    for wire in WIRES:
        agg = CompressedAggregation(method="diana_rr", wire="shared",
                                    fraction=FRACTION, n_slots=N_SLOTS,
                                    wire_dtype=wire)
        jitted, _, shardings, _ = steps.make_train_step(
            cfg, mesh, agg=agg, lr=LR, remat=False, seq_shard=False)
        with compat.set_mesh(mesh):
            state = steps.init_train_state(jax.random.key(KEY), cfg, agg, 4,
                                           mesh=mesh)
            for i, x in enumerate(jax.tree.leaves(state)):
                out[f"{wire}/init/{i}"] = np.asarray(x.astype(jnp.float32))
            state = jax.device_put(state, shardings)
            for t, (rows, slots) in enumerate(_batches()):
                state, metrics = jitted(state, {"tokens": jnp.asarray(rows)},
                                        jax.random.key(KEY), jnp.asarray(slots))
                out[f"{wire}/{t}/loss"] = np.asarray(metrics["loss"])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_loss_jump") / "trajectories.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    r = subprocess.run([sys.executable, __file__, str(path)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(path))


def _draws(step: int, shapes, packed: bool):
    """The reference's draws for one step on two pods: each level's window
    start per leaf and, on the packed wire, its rounding uniforms."""
    import jax

    from repro.core.salts import POD_KEY_SALT, WIRE_QUANT_SALT

    rkey = jax.random.fold_in(jax.random.key(KEY), step)

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
            "outer": level(jax.random.fold_in(rkey, POD_KEY_SALT))}


@pytest.mark.parametrize("wire", WIRES)
def test_two_pod_diana_rr_jump_follows_the_reference(oracle, wire):
    from repro_torch.configs import get_config
    from repro_torch.core.api import tree_flatten, tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step

    cfg = _cfg(get_config, torch.bfloat16)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
    agg = CompressedAggregation(method="diana_rr", fraction=FRACTION,
                                n_slots=N_SLOTS, wire_dtype=wire)
    step = make_train_step(cfg, mesh, agg=agg, lr=LR)
    state = init_train_state(0, cfg, agg, 4, mesh=mesh, device="cpu")
    leaves, unflatten = tree_flatten(state)
    assert f"{wire}/init/{len(leaves) - 1}" in oracle
    state = unflatten([
        torch.from_numpy(oracle[f"{wire}/init/{i}"].copy()).to(leaf.dtype)
        for i, leaf in enumerate(leaves)])
    shapes = [tuple(p.shape) for p in tree_leaves(state.params)]
    losses = []
    for t, (rows, slots) in enumerate(_batches()):
        state, metrics = step(state, {"tokens": torch.from_numpy(rows)}, None,
                              slots, None, draws=_draws(t, shapes,
                                                        wire == "packed8"))
        losses.append(float(metrics["loss"]))
    want = [float(oracle[f"{wire}/{t}/loss"]) for t in range(STEPS)]
    np.testing.assert_allclose(losses, want, rtol=1e-3)
    # the reference's jump, and the port's with it
    assert want[-1] > want[0] + 1.0
    assert abs((losses[-1] - losses[0]) - (want[-1] - want[0])) <= 0.05 * (
        want[-1] - want[0])


if __name__ == "__main__":
    _oracle(sys.argv[1])
