"""The sequence-split remat stash (`seq_shard`, `models.tp.seq_part` and
`seq_whole`, `models.transformer._stashed`) against the JAX reference's
`make_train_step(seq_shard=True)` and against the port's own runs.

- The reference's train step with `seq_shard` and remat "full" (its
  trainer's default: each decoder block's input constrained to
  `P(None, "model", None)`) and the port's, DIANA-RR on the f32 wire for
  two steps from the same state, tokens and draws, for the dense family
  on (4, 2) and (2, 2, 2) (S = 15 on T = 2: 8 rows on shard 0, 7 on
  shard 1, as GSPMD pads), rwkv6, an odd-head hymba (case c) and whisper
  on (4, 2): each leaf within 1e-2 of its largest entry, the loss to rtol
  1e-5 and the gradient norm to rtol 1e-4 (tests/test_torch_steps.py's
  bounds, for its reasons). The port's step without it is bitwise its
  step with it; the reference's, on the dense cases, is held to its step
  with it at the same bounds (GSPMD sums in another order around the
  constraint: the loss moves in its last bit on (2, 2, 2)).
- MoE at the loss and gradient level (the reference's MoE step has no
  `vmap` of `ragged_dot` on jax 0.9.0, tests/test_torch_families.py): the
  reference's `loss_fn(seq_shard=True, remat="full")` under the (4, 2)
  mesh against the port's on T = 2 shards, the loss to rtol 1e-5 and each
  gradient leaf within 1e-2 of its largest entry.
- The operators: `seq_part` keeps ceil(S / T) rows a shard (the last
  fewer), `seq_whole` puts them back in shard order, and their gradients
  are each other's conjugate.
- The stash: over one block, autograd's saved-tensor hooks see exactly
  one tensor, the process's rows of the block's input; over the whole
  loss, L + 1 of them (the blocks' and the final norm's), their bytes
  `launch.train.stash_bytes` (the `activation_bytes` term) to the byte.
- Spread over W = 2 and 4 gloo processes (spawned once, one intra-op
  thread each, joined through a file): the model axis's shards one a
  process, uneven rows (S = 15 over T = 2 and T = 4): every metric and
  state leaf bitwise the stacked run's, the bytes each process sent its
  model group `launch.sharding.model_bytes` (with the stash's re-gather
  a block), and its stash `stash_bytes` of its own rows.

The reference's runs are computed in one subprocess (this file run as a
script), as XLA:CPU aborts when several multi-device transformer
programs run in one test process.
"""
import dataclasses
import os
import queue
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread, shard_shapes

ROOT = Path(__file__).resolve().parents[1]
B, STEPS, LR, FRACTION, N_SLOTS = 8, 2, 0.05, 0.25, 2
# tag -> (config, mesh, S): the reference's seq_shard step against the
# port's (S = 15: the sequence does not divide by T = 2)
CASES = {"dense-4x2": ("stablelm-1.6b", (4, 2), 15),
         "dense-2x2x2": ("stablelm-1.6b", (2, 2, 2), 16),
         "rwkv6-4x2": ("rwkv6-7b", (4, 2), 16),
         "hymba-odd-4x2": ("hymba-odd", (4, 2), 16),
         "whisper-4x2": ("whisper-medium", (4, 2), 16)}
# the cases the reference also runs without seq_shard
WHOLE_CASES = ("dense-2x2x2",)
# the model axis over processes: (config, mesh, S, world)
SPREAD = {"dense-1x2-S15": ("stablelm-1.6b", (1, 2), 15, 2),
          "rwkv6-1x2-S15": ("rwkv6-7b", (1, 2), 15, 2),
          "dense-1x4-S15": ("stablelm-1.6b", (1, 4), 15, 4),
          "hymba-odd-2x2": ("hymba-odd", (2, 2), 16, 4)}
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def _clients(shape):
    return int(np.prod(shape[:-1]))


def _config(get_config, reduced, name, s, dtype):
    """The reduced config of `name` at f32 ("hymba-odd": 5 heads of 16 over
    1 kv head, d_model 80, 5 SSD heads), from either package."""
    if name == "hymba-odd":
        return dataclasses.replace(reduced(get_config("hymba-1.5b"), seq=s),
                                   num_heads=5, num_kv_heads=1, head_dim=16,
                                   d_model=80, ssm_heads=5, dtype=dtype)
    return dataclasses.replace(reduced(get_config(name), seq=s), dtype=dtype)


def _batches(name, s, rows=B):
    """Per step: tokens (rows, s + 1), and whisper's frames."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, 503, (rows, s + 1)).astype(np.int32)}
        if name == "whisper-medium":
            b["frames"] = rng.standard_normal(
                (rows, 24, 128)).astype(np.float32)
        out.append(b)
    return out


def _oracle(out_path: str, tags) -> None:
    """The reference's runs (in a subprocess): the two steps of the cases
    `tags` with seq_shard (and without, for WHOLE_CASES), and with "moe"
    among them MoE's loss and gradients with it."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced
    from repro.core.dist import CompressedAggregation
    from repro.launch import compat, steps
    from repro.launch.mesh import make_test_mesh
    from repro.models import transformer as jt

    out = {}
    for tag in tags:
        if tag == "moe":
            continue
        name, shape, s = CASES[tag]
        cfg = _config(get_config, reduced, name, s, jnp.float32)
        mesh = make_test_mesh(shape, _axes(shape))
        agg = CompressedAggregation(method="diana_rr", wire="shared",
                                    fraction=FRACTION, n_slots=N_SLOTS,
                                    shift_dtype=jnp.float32,
                                    backend="reference")
        for seq in (True, False)[:2 if tag in WHOLE_CASES else 1]:
            key = f"{tag}/{'seq' if seq else 'whole'}"
            jitted, _, shardings, _ = steps.make_train_step(
                cfg, mesh, agg=agg, lr=LR, remat="full", seq_shard=seq)
            with compat.set_mesh(mesh):
                state = steps.init_train_state(jax.random.key(0), cfg, agg,
                                               _clients(shape), mesh=mesh)
                if seq:
                    for i, x in enumerate(jax.tree.leaves(state)):
                        out[f"{tag}/init/{i}"] = np.asarray(x)
                state = jax.device_put(state, shardings)
                for t, batch in enumerate(_batches(name, s)):
                    state, metrics = jitted(
                        state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.key(2),
                        jnp.asarray([t % N_SLOTS], jnp.int32))
                    out[f"{key}/{t}/loss"] = np.asarray(metrics["loss"])
                    out[f"{key}/{t}/grad_norm"] = np.asarray(
                        metrics["grad_norm"])
                    for i, x in enumerate(jax.tree.leaves(state)):
                        out[f"{key}/{t}/{i}"] = np.asarray(x)
    if "moe" not in tags:
        np.savez(out_path, **out)
        return
    cfg = _config(get_config, reduced, "qwen2-moe-a2.7b", 16, jnp.float32)
    mesh = make_test_mesh((4, 2), ("data", "model"))
    params = jt.init_params(jax.random.key(0), cfg)
    batch = {k: jnp.asarray(v[:2])
             for k, v in _batches("qwen2-moe-a2.7b", 16)[0].items()}
    with compat.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jt.loss_fn(p, batch, cfg, remat="full",
                                 seq_shard=True)))(params)
    out["moe/loss"] = np.asarray(loss)
    for i, x in enumerate(jax.tree.leaves(jax.device_get(params))):
        out[f"moe/param/{i}"] = np.asarray(x)
    for i, x in enumerate(jax.tree.leaves(jax.device_get(grads))):
        out[f"moe/grad/{i}"] = np.asarray(x)
    np.savez(out_path, **out)


@pytest.fixture(autouse=True, scope="module")
def _reference_runs(tmp_path_factory):
    """The reference's subprocesses, two halves of the cases at once,
    started with the module so that their compiles run beside the port's
    tests (those that read them come last)."""
    tmp = tmp_path_factory.mktemp("jax_seq_shard")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    tags = sorted(CASES) + ["moe"]
    runs = []
    for k, half in enumerate((tags[0::2], tags[1::2])):
        path = tmp / f"trajectories{k}.npz"
        runs.append((subprocess.Popen(
            [sys.executable, __file__, str(path), *half], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            path))
    yield runs
    for proc, _ in runs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def oracle(_reference_runs):
    got = {}
    for proc, path in _reference_runs:
        out, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, out[-2000:] + err[-3000:]
        got.update(np.load(path))
    return got


def _draws(step: int, shapes, pods: int):
    """The reference's f32 shared-wire draws of one step at a shard's
    geometry (tests/test_torch_steps.py's key schedule)."""
    import jax

    from repro.core.salts import POD_KEY_SALT

    rkey = jax.random.fold_in(jax.random.key(2), step)

    def level(key):
        out = []
        for i, shp in enumerate(shapes):
            rows = int(np.prod(shp[:-1])) if len(shp) >= 2 else int(
                np.prod(shp))
            nb = (rows + (-rows) % 8) // 8
            leaf_key = jax.random.fold_in(key, i)
            out.append({"start": int(jax.random.randint(leaf_key, (), 0,
                                                        nb))})
        return out

    return {"inner": level(rkey),
            "outer": level(jax.random.fold_in(rkey, POD_KEY_SALT))
            if pods > 1 else []}


class _Group:
    """A model group of T shards in one process: `gather` hands back every
    shard's rows from `every`, counting the bytes handed over."""

    def __init__(self):
        self.every, self.bytes_sent = None, {}

    def gather(self, x, level, pods, *, key=None, to_first=False):
        self.bytes_sent[key] = self.bytes_sent.get(key, 0) + (
            x.numel() * x.element_size())
        return self.every


@pytest.mark.parametrize("s,t", [(15, 2), (15, 4), (16, 2), (3, 4)])
def test_seq_operators(s, t):
    """`seq_part` keeps shard j's ceil(S / T) rows (the last shards fewer,
    or none), `seq_whole` puts every shard's rows back in shard order,
    padded on the wire; each one's gradient is the other's."""
    from repro_torch.models import tp

    x = torch.randn(2, s, 3, dtype=torch.float64)
    n = -(-s // t)
    pad = torch.cat([x, x.new_zeros(2, n * t - s, 3)], 1)
    stack = pad.unflatten(1, (t, n)).movedim(1, 0).contiguous()
    for j in range(t):
        comm = _Group()
        comm.every = stack
        ms = tp.ModelShards(t, start=j, count=1, comm=comm)
        lo, hi = ms.seq_rows(s)
        assert (lo, hi) == (min(j * n, s), min((j + 1) * n, s))
        xr = x.clone().requires_grad_(True)
        part = tp.seq_part(xr, ms)
        assert torch.equal(part, x[:, lo:hi])
        back = tp.seq_whole(part, ms, s)
        assert torch.equal(back, x)
        assert comm.bytes_sent == {"model": 2 * n * 3 * 8}
        # the gradient of seq_whole keeps the rows; seq_part's gathers
        g = torch.randn(2, s, 3, dtype=torch.float64)
        comm.every = torch.cat([g, g.new_zeros(2, n * t - s, 3)], 1
                               ).unflatten(1, (t, n)).movedim(1, 0)
        gx, = torch.autograd.grad(back, xr, g)
        assert torch.equal(gx, g)


def _stash_nodes(loss):
    """The `_Keep` nodes of a loss's graph: the tensors each block (and the
    final norm) keeps for its recompute."""
    seen, todo, out = set(), [loss.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "_KeepBackward":
            out.append(node)
        todo += [f for f, _ in node.next_functions]
    return out


def stash_bytes_seen(cfg, params, batch, ms):
    """(bytes autograd's hooks see saved over one block, the saved bytes
    of every `_Keep` of the loss and how many): a block's stash as the
    saved-tensor hooks count it, and the whole loss's."""
    from repro_torch.core.api import tree_flatten
    from repro_torch.models import transformer as tt

    split = ms.split(params) if ms is not None else params
    bp = tt._layer(tt._unbind(split["blocks"]), 0)
    b, s = batch["tokens"].shape[0], batch["tokens"].shape[1] - 1
    x = torch.randn(b, s, cfg.d_model, dtype=cfg.dtype, requires_grad=True)
    positions = tt._positions(cfg, b, s, x.device)
    enc = (torch.randn(b, cfg.encoder_seq, cfg.d_model, dtype=cfg.dtype)
           if cfg.is_encdec else None)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel() * t.element_size()) or t,
            lambda t: t):
        tt._stashed(lambda bp, x: tt._block_train(bp, x, cfg, positions, enc,
                                                  ms), bp, x, ms)
    leaves, unflatten = tree_flatten(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    loss = tt.loss_fn(unflatten(req), batch, cfg, remat="full", ms=ms,
                      seq_shard=True)
    nodes = _stash_nodes(loss)
    kept = sum(t.numel() * t.element_size() for n in nodes
               for t in n.saved_tensors)
    return saved, kept, len(nodes)


@pytest.mark.parametrize("name,s,t", [("stablelm-1.6b", 15, 2),
                                      ("whisper-medium", 16, 1),
                                      ("rwkv6-7b", 16, 4)])
def test_stash_is_every_block_input_whole_on_one_process(name, s, t):
    """A process holding all T shards keeps every block's input whole
    (and the final norm's): one tensor a block under the hooks, L + 1 in
    the loss, `stash_bytes` at n = T."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.sharding import split_axes
    from repro_torch.launch.train import stash_bytes
    from repro_torch.models import tp
    from repro_torch.models import transformer as tt

    cfg = _config(get_config, reduced, name, s, torch.float32)
    params = tt.init_params(0, cfg, "cpu")
    ms = (tp.ModelShards(t, tuple(split_axes(tt.init_params(0, cfg, "meta"),
                                             t))) if t > 1 else None)
    batch = {k: torch.from_numpy(v[:2]).long() if k == "tokens"
             else torch.from_numpy(v[:2]) for k, v in _batches(name, s)[0]
             .items()}
    saved, kept, count = stash_bytes_seen(cfg, params, batch, ms)
    assert saved == [2 * s * cfg.d_model * 4]
    assert count == cfg.num_layers + 1
    assert kept == stash_bytes(cfg, 2, s, t, t) == count * saved[0]


# -- the model axis over processes ------------------------------------------

def run_spread_case(comm, name):
    """STEPS DIANA-RR steps of spread case `name` on the process's cells
    (stacked: all of them), remat "full" with seq_shard: each step's
    metrics and the process's state leaves, the bytes it sent by level,
    and its stash (hooks over one block; every `_Keep` of the loss)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.api import tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tt

    arch, shape, s, _ = SPREAD[name]
    cfg = _config(get_config, reduced, arch, s, torch.float32)
    mesh = make_mesh(shape, _axes(shape))
    m = _clients(shape)
    agg = CompressedAggregation(method="diana_rr", fraction=FRACTION,
                                n_slots=N_SLOTS, shift_dtype=torch.float32,
                                collective=comm)
    step = steps.make_train_step(cfg, mesh, agg=agg, lr=LR, remat="full")
    state = steps.init_train_state(0, cfg, agg, m, mesh=mesh, device="cpu")
    wired = steps.configure_agg(agg, mesh, params=tt.init_params(0, cfg,
                                                                 "meta"))
    own = comm.local("rank", wired.num_pods())
    lo, hi, _ = own.indices(m)
    per = B // m
    comm.bytes_sent.clear()
    metrics = []
    for t, batch in enumerate(_batches(arch, s)):
        feed = {k: torch.from_numpy(v[lo * per:hi * per])
                for k, v in batch.items()}
        state, mets = step(state, feed, torch.Generator().manual_seed(t),
                           [t % N_SLOTS])
        metrics.append({k: v.numpy().copy() for k, v in mets.items()})
    sent = dict(comm.bytes_sent)
    ms = sharding.model_shards(wired, cfg)
    params = tt.init_params(0, cfg, "cpu")
    if ms is not None and ms.spread:
        params = sharding.take_shards(params, wired)
    batch = {k: torch.from_numpy(v[:per]) for k, v in
             _batches(arch, s)[0].items()}
    stash = stash_bytes_seen(cfg, params, batch, ms)
    return {"metrics": metrics, "bytes": sent, "stash": stash,
            "state": [x.numpy().copy() for x in tree_leaves(state)]}


def _worker(rank, world, init_file, out):
    torch.set_num_threads(1)
    try:
        from repro_torch.launch import distributed

        distributed.init_process_group("gloo", rank=rank, world_size=world,
                                       init_method=f"file://{init_file}")
        res = {}
        for name, (_, shape, _, w) in SPREAD.items():
            if w != world:
                continue
            comm = distributed.ProcessGroupCollective(_clients(shape),
                                                      shape[-1])
            res[name] = run_spread_case(comm, name)
        distributed.destroy_process_group()
        out.put((world, rank, res))
    except BaseException as exc:
        import traceback

        out.put((world, rank, traceback.format_exc()))
        raise exc


@pytest.fixture(scope="module")
def spread(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("seq_shard"))
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = []
    for world in WORLDS:
        for rank in range(world):
            p = ctx.Process(target=_worker,
                            args=(rank, world, f"{tmp}/pg{world}", out))
            p.start()
            procs.append(p)
    results = {w: [None] * w for w in WORLDS}
    try:
        for _ in procs:
            world, rank, res = out.get(timeout=240)
            if isinstance(res, str):
                raise RuntimeError(f"W={world} process {rank} failed:\n{res}")
            results[world][rank] = res
    except queue.Empty:
        raise RuntimeError("a spawned process gave no result in 240 s")
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(10)
    assert not [p.exitcode for p in procs if p.exitcode], "spawn failed"
    return results


def _state_layout(cfg, shape):
    """Each state leaf's unit ("rank", "pod", None) and split axis."""
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import leaf_model_axes, leaf_units

    mesh = make_mesh(shape, _axes(shape))
    agg = CompressedAggregation(method="diana_rr", fraction=FRACTION,
                                n_slots=N_SLOTS, shift_dtype=torch.float32)
    like = steps.init_train_state(0, cfg, agg, _clients(shape), mesh=mesh,
                                  device="meta")
    agg = steps.configure_agg(agg, mesh, params=like.params)
    return leaf_units(like, agg), leaf_model_axes(like, agg)


@pytest.mark.parametrize("name", sorted(SPREAD))
def test_spread_seq_shard_equals_stacked(spread, name):
    """One model shard a process: every metric and the process's shards of
    every state leaf bitwise the stacked run's; its bytes to the model
    group `model_bytes` a step (the stash's re-gathers included); its
    stash its own rows of each block's input and the final norm's, as
    the hooks see them, `stash_bytes` in all."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import distributed
    from repro_torch.launch.sharding import model_bytes
    from repro_torch.launch.train import stash_bytes
    from repro_torch.models import tp

    arch, shape, s, world = SPREAD[name]
    cfg = _config(get_config, reduced, arch, s, torch.float32)
    t, m = shape[-1], _clients(shape)
    want = run_spread_case(distributed.StackedCollective(), name)
    units, axes = _state_layout(cfg, shape)
    assert "model" not in want["bytes"]
    per_shard = [len(range(*tp.seq_rows(s, t, range(j, j + 1))))
                 for j in range(t)]
    assert sum(per_shard) == s and len(set(per_shard)) > 1 or s % t == 0
    for rank, res in enumerate(spread[world]):
        got = res[name]
        for k, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            for key in w:
                assert g[key].tobytes() == w[key].tobytes(), (rank, k, key)
        j = rank % t
        lay = distributed.RankLayout(world, rank, m, 1, t)
        assert lay.local_shards == slice(j, j + 1)
        assert got["bytes"]["model"] == STEPS * model_bytes(
            cfg, rows=B // m, seq=s, t=t, shards=1)
        saved, kept, count = got["stash"]
        rows = per_shard[j]
        assert saved == [(B // m) * rows * cfg.d_model * 4]
        assert count == cfg.num_layers + 1
        assert kept == stash_bytes(cfg, B // m, s, t, 1, start=j)
        assert len(got["state"]) == len(want["state"]) == len(units)
        for i, (g, w, u, ax) in enumerate(zip(got["state"], want["state"],
                                              units, axes)):
            if u is not None:
                w = w[lay.local_ranks if u == "rank" else lay.local_pods]
            if ax is not None:
                n = w.shape[ax] // t
                w = np.take(w, range(j * n, (j + 1) * n), axis=ax)
            assert g.tobytes() == w.tobytes(), (rank, i)


# -- against the reference (its subprocess's runs) --------------------------

def _port_run(oracle, tag, seq_shard):
    """The port's two steps of case `tag` from the reference's initial
    state with the reference's draws: each step's (loss, grad_norm,
    leaves)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.api import tree_flatten, tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step

    name, shape, s = CASES[tag]
    cfg = _config(get_config, reduced, name, s, torch.float32)
    mesh = make_mesh(shape, _axes(shape))
    agg = CompressedAggregation(method="diana_rr", fraction=FRACTION,
                                n_slots=N_SLOTS, shift_dtype=torch.float32)
    step = make_train_step(cfg, mesh, agg=agg, lr=LR, remat="full",
                           seq_shard=seq_shard)
    state = init_train_state(0, cfg, agg, _clients(shape), mesh=mesh,
                             device="cpu")
    leaves, unflatten = tree_flatten(state)
    state = unflatten([torch.from_numpy(oracle[f"{tag}/init/{i}"].copy())
                       for i in range(len(leaves))])
    shapes = shard_shapes(state.params, shape[-1])
    pods = shape[0] if len(shape) == 3 else 1
    out = []
    for t, batch in enumerate(_batches(name, s)):
        state, metrics = step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
            [t % N_SLOTS], draws=_draws(t, shapes, pods))
        out.append((metrics["loss"], metrics["grad_norm"],
                    [x.clone() for x in tree_leaves(state)]))
    return out


@pytest.mark.parametrize("tag", sorted(CASES))
def test_seq_shard_step_matches_reference(oracle, tag):
    """The port's step with seq_shard against the reference's with it,
    at tests/test_torch_steps.py's bounds; the port's step without it is
    bitwise the same run."""
    with_seq = _port_run(oracle, tag, True)
    key = f"{tag}/seq"
    for t, (loss, gnorm, leaves) in enumerate(with_seq):
        np.testing.assert_allclose(float(loss), oracle[f"{key}/{t}/loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(gnorm),
                                   oracle[f"{key}/{t}/grad_norm"], rtol=1e-4)
        for i, leaf in enumerate(leaves):
            w = np.asarray(oracle[f"{key}/{t}/{i}"], np.float32)
            err = float(np.abs(leaf.numpy() - w).max()) if w.size else 0.0
            bound = 1e-2 * float(np.abs(w).max()) + 1e-6
            assert err <= bound, f"step {t} leaf {i}: {err} > {bound}"
    for t, (a, b) in enumerate(zip(with_seq, _port_run(oracle, tag, False))):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), t
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2])), t


@pytest.mark.parametrize("tag", WHOLE_CASES)
def test_reference_seq_shard_within_its_own_bounds(oracle, tag):
    """The reference's step with seq_shard against its step without it:
    GSPMD partitions the block around the constraint and sums in another
    order (the loss differs in its last bit on (2, 2, 2)), so the two are
    held to each other at the bounds above, where the port's are bitwise
    (`test_seq_shard_step_matches_reference`)."""
    n = len([k for k in oracle if k.startswith(f"{tag}/init/")])
    for t in range(STEPS):
        a, b = (oracle[f"{tag}/{k}/{t}/loss"] for k in ("seq", "whole"))
        np.testing.assert_allclose(a, b, rtol=1e-5)
        a, b = (oracle[f"{tag}/{k}/{t}/grad_norm"] for k in ("seq", "whole"))
        np.testing.assert_allclose(a, b, rtol=1e-4)
        for i in range(n):
            a, b = (oracle[f"{tag}/{k}/{t}/{i}"] for k in ("seq", "whole"))
            err = float(np.abs(a - b).max()) if a.size else 0.0
            assert err <= 1e-2 * float(np.abs(b).max()) + 1e-6, (t, i, err)


def test_moe_loss_and_gradients_with_seq_shard(oracle):
    """MoE's loss and gradients with seq_shard on T = 2 shards against the
    reference's on the (4, 2) mesh (its train step has no MoE on this
    jax), and bitwise the port's own without it."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.api import tree_flatten
    from repro_torch.launch.sharding import split_axes
    from repro_torch.models import tp
    from repro_torch.models import transformer as tt

    cfg = _config(get_config, reduced, "qwen2-moe-a2.7b", 16, torch.float32)
    meta = tt.init_params(0, cfg, "meta")
    leaves, unflatten = tree_flatten(meta)
    ms = tp.ModelShards(2, tuple(split_axes(meta, 2)))
    batch = {k: torch.from_numpy(v[:2]).long() for k, v in
             _batches("qwen2-moe-a2.7b", 16)[0].items()}
    runs = []
    for seq in (True, False):
        req = [torch.from_numpy(oracle[f"moe/param/{i}"].copy())
               .requires_grad_(True) for i in range(len(leaves))]
        loss = tt.loss_fn(unflatten(req), batch, cfg, remat="full", ms=ms,
                          seq_shard=seq)
        runs.append((loss.detach(), torch.autograd.grad(loss, req)))
    loss, grads = runs[0]
    np.testing.assert_allclose(float(loss), oracle["moe/loss"], rtol=1e-5)
    for i, g in enumerate(grads):
        w = oracle[f"moe/grad/{i}"]
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-2 * float(np.abs(w).max()) + 1e-7, (i, err)
    assert torch.equal(runs[1][0], loss)
    assert all(torch.equal(a, b) for a, b in zip(runs[1][1], grads))


if __name__ == "__main__":
    _oracle(sys.argv[1], sys.argv[2:])
