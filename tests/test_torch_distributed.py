"""Client ranks spread over processes (`repro_torch.launch.distributed`)
against the stacked single-process run, on the host over gloo.

Each world size W = 2 and W = 4 is spawned once for the module (the two at
once, one intra-op thread a process): the children join a gloo group
through a file (no TCP port, so parallel test workers never collide), run
every case below on their own ranks and send back their rows; the test
process runs the same cases stacked (`StackedCollective`) and asks for the
same bits, with `tobytes` equality:

- the wire, three rounds from one generator (every process draws every
  rank's draws): dense, q, diana, diana_rr and ef on the f32, f32 at 127
  levels, bf16, packed8 and packed4 transports, and q, diana and ef on the
  independent wire, on (4, 1) and (2, 2, 1) meshes, unweighted and with
  the elastic weights (1, 0, 0.5, 1): the directions, every process's
  table rows, and the bytes each process sent per level, which must equal
  `wire_bytes_per_round` times the ranks (pods) the process speaks for;
- at W = 2, the reference's shard_map aggregate (the harness of
  tests/test_torch_wire.py, its draws injected): at that file's bounds;
- three reduced train steps with `debug_metrics` (flat packed8 DIANA-RR,
  two-pod packed8 DIANA-RR NASTYA with 2 local steps, elastic DIANA):
  every state leaf and every metric;
- the trainer under torchrun's environment (`--dist-backend gloo`): its
  6-step checkpoint byte-equal to the stacked one, `--resume` of the
  stacked 3-step checkpoint at W, and the stacked `--resume` of W's.

Then the refusals: a world size without a process-group environment, a
layout that straddles pods, an unnamed backend under torchrun.
"""
import importlib.util
import os
import queue
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.core.api import tree_flatten, tree_leaves
from repro_torch.core.dist import CompressedAggregation
from repro_torch.launch import distributed, steps, train
from repro_torch.checkpoint import restore_train_state, save_pytree
from repro_torch.launch.mesh import make_mesh, num_clients
from repro_torch.launch.sharding import (
    StateShards,
    leaf_model_axes,
    leaf_units,
    model_bytes,
)

_spec = importlib.util.spec_from_file_location(
    "torch_wire_harness", Path(__file__).with_name("test_torch_wire.py"))
wire_harness = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(wire_harness)

RANKS, ROUNDS, SLOTS = 4, 3, 2
GRADS = wire_harness.GRADS
WEIGHTS = np.array([1.0, 0.0, 0.5, 1.0], np.float32)
MESHES = ((4, 1), (2, 2, 1))
WORLDS = (2, 4)
TRANSPORTS = (("f32", None), ("f32", 127), ("bf16", None),
              ("packed8", None), ("packed4", None))
WIRE_CASES = (
    [(shape, "dense", "shared", "f32", None, w)
     for shape in MESHES for w in (False, True)]
    + [(shape, m, "shared", dt, lv, w) for shape in MESHES
       for m in ("q", "diana", "diana_rr", "ef") for dt, lv in TRANSPORTS
       for w in (False, True)]
    + [(shape, m, "independent", "f32", None, w) for shape in MESHES
       for m in ("q", "diana", "ef") for w in (False, True)])
# the reference's shard_map aggregate at W = 2: (mesh, transport)
REFERENCE_CASES = (((4, 1), "f32"), ((2, 2, 1), "packed8"))
STEP_CASES = {
    "flat-packed8-diana_rr": dict(shape=(4, 1), method="diana_rr",
                                  wire_dtype="packed8", local_steps=1,
                                  elastic=False),
    "2pod-packed8-diana_rr-nastya": dict(shape=(2, 2, 1), method="diana_rr",
                                         wire_dtype="packed8", local_steps=2,
                                         elastic=False),
    "flat-elastic-diana": dict(shape=(4, 1), method="diana", wire_dtype="f32",
                               local_steps=1, elastic=True),
}
# the model axis spread over processes: make_train_step on a mesh whose
# model shards outnumber what a process holds, at the one world size that
# puts one (client, shard) cell in each process
MODEL_STEP_CASES = {
    "1x2-packed8-diana_rr": dict(shape=(1, 2), method="diana_rr",
                                 wire_dtype="packed8", local_steps=1,
                                 elastic=False, world=2),
    "2x2-f32-diana_rr-nastya": dict(shape=(2, 2), method="diana_rr",
                                    wire_dtype="f32", local_steps=2,
                                    elastic=False, world=4),
    "2x2-packed8-diana-elastic": dict(shape=(2, 2), method="diana",
                                      wire_dtype="packed8", local_steps=1,
                                      elastic=True, world=4),
    "1x2-f32-diana-moe": dict(shape=(1, 2), method="diana", wire_dtype="f32",
                              local_steps=1, elastic=False, world=2,
                              arch="qwen2-moe-a2.7b"),
    "2x2-packed8-diana_rr-rwkv6": dict(shape=(2, 2), method="diana_rr",
                                       wire_dtype="packed8", local_steps=1,
                                       elastic=False, world=4,
                                       arch="rwkv6-7b"),
    "1x2-f32-diana-hymba": dict(shape=(1, 2), method="diana",
                                wire_dtype="f32", local_steps=1,
                                elastic=False, world=2, arch="hymba-odd"),
    "1x2-packed8-diana_rr-whisper": dict(shape=(1, 2), method="diana_rr",
                                         wire_dtype="packed8", local_steps=1,
                                         elastic=False, world=2,
                                         arch="whisper-medium"),
}
CKPT_CASE = "2x2-packed8-diana-elastic"  # its W = 4 state is checkpointed
STEPS = 3
TRAIN_ARGV = ["--device", "cpu", "--reduced", "--seq", "8", "--log-every",
              "100", "--agg", "diana", "--wire-dtype", "packed8"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def _wire_id(case):
    shape, m, wire, dt, lv, w = case
    return (f"{'x'.join(map(str, shape))}-{m}-{wire}-{dt}"
            + (f"{lv}" if lv else "") + ("-weighted" if w else ""))


def _agg(comm, shape, method, wire="shared", wire_dtype="f32", levels=None,
         local_steps=1, **kw):
    agg = CompressedAggregation(method=method, wire=wire, fraction=0.3,
                                n_slots=SLOTS, wire_levels=levels,
                                wire_dtype=wire_dtype,
                                shift_dtype=torch.float32, collective=comm,
                                **kw)
    return steps.configure_agg(agg, make_mesh(shape, _axes(shape)),
                               local_steps)


def _host(x):
    """A tensor's bits on the host (bf16 as its int16 bits)."""
    if x is None:
        return None
    x = x.detach().cpu()
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy(
        ).copy()


# -- one process's share of each case (the stacked run is the same code) --

def run_wire(comm, case, draws=None):
    """Three rounds of `case` on the process's ranks: directions, the
    process's table rows, the bytes it sent per level."""
    shape, method, wire, dt, levels, weighted = case
    agg = _agg(comm, shape, method, wire, dt, levels)
    own = comm.local("rank", agg.num_pods())
    grads = {k: torch.from_numpy(v[own].copy()) for k, v in GRADS.items()}
    weight = torch.from_numpy(WEIGHTS[own]) if weighted else None
    state = agg.init({k: v[0] for k, v in grads.items()}, RANKS)
    gen = torch.Generator().manual_seed(7)
    comm.bytes_sent.clear()
    dirs = []
    for t in range(ROUNDS):
        d, state = agg.aggregate(grads, state, gen, slot=t % SLOTS,
                                 draws=None if draws is None else draws[t],
                                 weight=weight)
        dirs.append({k: _host(v) for k, v in d.items()})
    return {"dirs": dirs, "tables": [_host(x) for x in tree_leaves(state)],
            "bytes": dict(comm.bytes_sent)}


def _cfg(arch="stablelm-1.6b"):
    """The reduced config; "hymba-odd" is reduced hymba with hymba-1.5b's
    splits at T = 2 (5 heads of 16 over 1 kv head, d_model 80, 5 SSD
    heads: case c, `ln` split on its last axis, `wdt` whole)."""
    if arch == "hymba-odd":
        import dataclasses

        return dataclasses.replace(reduced(get_config("hymba-1.5b"), seq=8),
                                   num_heads=5, num_kv_heads=1, head_dim=16,
                                   d_model=80, ssm_heads=5)
    return reduced(get_config(arch), seq=8)


def _step_case(name):
    return {**STEP_CASES, **MODEL_STEP_CASES}[name]


def _step_setup(comm, name):
    """(cfg, mesh, agg, step, fresh state) of a step case on `comm`."""
    c = _step_case(name)
    cfg = _cfg(c.get("arch", "stablelm-1.6b"))
    mesh = make_mesh(c["shape"], _axes(c["shape"]))
    ls = c["local_steps"]
    agg = CompressedAggregation(method=c["method"], fraction=0.3,
                                n_slots=SLOTS, wire_dtype=c["wire_dtype"],
                                shift_dtype=torch.float32, collective=comm)
    step = steps.make_train_step(cfg, mesh, agg=agg, lr=0.05, local_steps=ls,
                                 elastic=c["elastic"], debug_metrics=True)
    state = steps.init_train_state(0, cfg, agg, num_clients(mesh), mesh=mesh,
                                   local_steps=ls, device="cpu")
    return cfg, mesh, agg, step, state


def run_steps(comm, name, checkpoint=None):
    """STEPS reduced train steps of the step case `name` on the process's
    clients (and model shards): every metric and the process's state
    leaves; with `checkpoint` the final state is saved there (process 0
    writes the stacked run's file)."""
    c = _step_case(name)
    cfg, mesh, agg, step, state = _step_setup(comm, name)
    ls = c["local_steps"]
    m = num_clients(mesh)
    wired = steps.configure_agg(agg, mesh, ls)
    own = comm.local("rank", wired.num_pods())
    rows = np.random.default_rng(3).integers(
        0, cfg.vocab, (m * ls, 9)).astype(np.int64)
    frames = (np.random.default_rng(4).standard_normal(
        (STEPS, m * ls, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.is_encdec else None)
    start, stop, _ = own.indices(m)
    weights = torch.from_numpy(WEIGHTS[:m]) if c["elastic"] else None
    comm.bytes_sent.clear()
    metrics = []
    for t in range(STEPS):
        batch = {"tokens": torch.from_numpy(
            np.roll(rows, t, axis=1)[start * ls:stop * ls])}
        if frames is not None:
            batch["frames"] = torch.from_numpy(
                frames[t, start * ls:stop * ls]).to(cfg.dtype)
        state, mets = step(state, batch,
                           torch.Generator().manual_seed(100 + t),
                           np.arange(ls) % SLOTS, weights)
        metrics.append({k: _host(v) for k, v in sorted(mets.items())})
    if checkpoint is not None:
        like = steps.init_train_state(0, cfg, agg, m, mesh=mesh,
                                      local_steps=ls, device="meta")
        wired = steps.configure_agg(agg, mesh, ls, params=like.params)
        save_pytree(checkpoint, state, step=STEPS,
                    shards=StateShards(wired, like) if comm.world > 1
                    else None)
    return {"metrics": metrics, "state": [_host(x) for x in
                                          tree_leaves(state)],
            "bytes": dict(comm.bytes_sent)}


def load_steps_state(comm, name, path):
    """The state of the step case `name` restored from `path` onto the
    process's rows and shards."""
    c = _step_case(name)
    cfg, mesh, agg, _, _ = _step_setup(comm, name)
    like = steps.init_train_state(0, cfg, agg, num_clients(mesh), mesh=mesh,
                                  local_steps=c["local_steps"], device="meta")
    wired = steps.configure_agg(agg, mesh, c["local_steps"],
                                params=like.params)
    state = restore_train_state(path, like, "cpu",
                                shards=StateShards(wired, like)
                                if comm.world > 1 else None)
    return [_host(x) for x in tree_leaves(state)]


def run_trainer(rank, world, port, argv):
    """`train.main` as torchrun starts it: its environment, a store that
    the caller hosts (torchrun's agent store)."""
    env = {"RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(rank), "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port), "TORCHELASTIC_USE_AGENT_STORE": "True"}
    os.environ.update(env)
    try:
        train.main(TRAIN_ARGV + ["--dist-backend", "gloo"] + argv)
    finally:
        for k in env:
            os.environ.pop(k, None)


def _worker(rank, world, init_file, ports, tmp, jobs, out):
    """One spawned process: every wire and step case over a file-joined
    gloo group, then the trainer runs under torchrun's environment."""
    torch.set_num_threads(1)
    try:
        distributed.init_process_group(
            "gloo", rank=rank, world_size=world,
            init_method=f"file://{init_file}")
        comm = distributed.ProcessGroupCollective(RANKS)
        res = {"wire": {i: run_wire(comm, c) for i, c in
                        enumerate(WIRE_CASES)},
               "reference": {i: run_wire(comm, c, d) for i, (c, d) in
                             enumerate(jobs["reference"])},
               "steps": {n: run_steps(comm, n) for n in STEP_CASES}}
        for name, c in MODEL_STEP_CASES.items():
            if c["world"] != world:
                continue
            mcomm = distributed.ProcessGroupCollective(
                num_clients(make_mesh(c["shape"])), model=c["shape"][-1])
            res["steps"][name] = run_steps(
                mcomm, name, f"{tmp}/{name}_w{world}.ckpt"
                if name == CKPT_CASE else None)
            if name == CKPT_CASE:
                res["resumed"] = load_steps_state(
                    mcomm, name, f"{tmp}/{name}_stacked.ckpt")
        distributed.destroy_process_group()
        for port, (argv) in zip(ports, (
                ["--steps", "6", "--checkpoint", f"{tmp}/w{world}_6.ckpt"],
                ["--steps", "6", "--resume", f"{tmp}/stacked_3.ckpt",
                 "--checkpoint", f"{tmp}/w{world}_resumed.ckpt"],
                ["--steps", "3", "--checkpoint", f"{tmp}/w{world}_3.ckpt"])):
            run_trainer(rank, world, port, argv)
        out.put((world, rank, res))
    except BaseException as exc:
        import traceback

        out.put((world, rank, traceback.format_exc()))
        raise exc


def _stacked_trainer(argv):
    return train.main(TRAIN_ARGV + argv)


@pytest.fixture(scope="module")
def spread(tmp_path_factory):
    """{world: [each process's results]}, the W = 2 and W = 4 runs spawned
    at once; the stacked trainer's checkpoints under `tmp`."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    _stacked_trainer(["--steps", "3", "--checkpoint", f"{tmp}/stacked_3.ckpt"])
    stacked_steps = run_steps(distributed.StackedCollective(), CKPT_CASE,
                              f"{tmp}/{CKPT_CASE}_stacked.ckpt")
    jobs = {"reference": [(case, draws) for case, draws in _reference_jobs()]}
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    stores, procs = [], []
    for world in WORLDS:
        ports = []
        for _ in range(3):
            store = dist.TCPStore("localhost", 0, world, is_master=True,
                                  wait_for_workers=False)
            stores.append(store)
            ports.append(store.port)
        for rank in range(world):
            p = ctx.Process(target=_worker, args=(
                rank, world, f"{tmp}/pg{world}", ports, tmp, jobs, out))
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
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    assert not bad, f"spawned processes exited {bad}"
    return results, tmp, stacked_steps


def _layout(world, rank, agg):
    return distributed.RankLayout(world, rank, RANKS, agg.num_pods())


def _own_rows(x, unit, lay):
    if unit is None:
        return x
    return x[lay.local_ranks if unit == "rank" else lay.local_pods]


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), (
        f"{what}: max |diff| {np.abs(a.astype(np.float64) - b).max()}")


def _expected_bytes(agg, wire, lay, rounds):
    """The bytes a process of layout `lay` puts on each level in `rounds`
    exchanges: one message of each rank (intra-pod, dense) or pod
    (inter-pod) it speaks for."""
    if agg.method == "dense":
        return {"dense": rounds * lay.local * wire["dense"]}
    pods_own = len(range(agg.num_pods())[lay.local_pods])
    out = {}
    if agg.client_axes:
        out["intra_pod"] = rounds * lay.local * wire["intra_pod"]
    if agg.pod_axes and agg.pod_size > 1:
        out["inter_pod"] = rounds * pods_own * wire["inter_pod"]
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", WIRE_CASES, ids=map(_wire_id, WIRE_CASES))
def test_wire_spread_equals_stacked(spread, world, case):
    comm = distributed.StackedCollective()
    want = run_wire(comm, case)
    agg = _agg(comm, *case[:5])
    params = {k: torch.from_numpy(v[0]) for k, v in GRADS.items()}
    state = agg.init(params, RANKS)
    units = [] if state is None else [
        u for u, t in zip(agg.table_units(), state) for _ in tree_leaves(t)]
    wire = agg.wire_bytes_per_round(params)
    assert want["bytes"] == _expected_bytes(agg, wire,
                                            _layout(1, 0, agg), ROUNDS)
    for rank, res in enumerate(spread[0][world]):
        got = res["wire"][WIRE_CASES.index(case)]
        lay = _layout(world, rank, agg)
        for t in range(ROUNDS):
            for k in GRADS:
                _same(got["dirs"][t][k], want["dirs"][t][k],
                      f"process {rank} round {t} direction {k}")
        assert len(got["tables"]) == len(want["tables"]) == len(units)
        for i, (g, w, u) in enumerate(zip(got["tables"], want["tables"],
                                          units)):
            _same(g, _own_rows(w, u, lay), f"process {rank} table {i}")
        assert got["bytes"] == _expected_bytes(agg, wire, lay, ROUNDS)


def _reference_jobs():
    """The W = 2 reference cases with the reference's draws injected."""
    import jax

    jobs = []
    for shape, dt in REFERENCE_CASES:
        for method in wire_harness.METHODS:
            case = (shape, method, "shared", dt, None, False)
            agg = _agg(distributed.StackedCollective(), shape, method,
                       "shared", dt)
            pods = shape[0] if len(shape) == 3 else 1
            draws = [wire_harness._reference_draws(
                agg, jax.random.fold_in(jax.random.key(0), t), pods)
                for t in range(ROUNDS)]
            jobs.append((case, draws))
    return jobs


@pytest.mark.parametrize("method", wire_harness.METHODS)
@pytest.mark.parametrize("shape,wire_dtype", REFERENCE_CASES,
                         ids=["4x1-f32", "2x2x1-packed8"])
def test_spread_wire_matches_reference_aggregate(spread, shape, wire_dtype,
                                                 method):
    """W = 2 against the reference's shard_map aggregate, the draws of its
    key schedule injected: bitwise for q and ef on the f32 wire, else
    within tests/test_torch_wire.py's 8 ulps of each leaf's largest
    value."""
    want = wire_harness._jax_directions(shape, "shared", None,
                                        wire_dtype)[method]
    i = [c[:4] for c, _ in _reference_jobs()].index(
        (shape, method, "shared", wire_dtype))
    for res in spread[0][2]:
        dirs = res["reference"][i]["dirs"]
        got = {k: np.stack([d[k] for d in dirs]) for k in GRADS}
        wire_harness._hold_to_reference(
            got, want, exact=method in ("q", "ef") and wire_dtype == "f32")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_train_steps_spread_equal_stacked(spread, world, name):
    """Every state leaf (the process's rows of the tables) and every
    metric (loss, gradient norm, the debug metrics) bitwise; the bytes
    sent per step as the wire's accounting says."""
    comm = distributed.StackedCollective()
    want = run_steps(comm, name)
    c = STEP_CASES[name]
    mesh = make_mesh(c["shape"], _axes(c["shape"]))
    agg = _agg(comm, c["shape"], c["method"], wire_dtype=c["wire_dtype"],
               local_steps=c["local_steps"])
    like = steps.init_train_state(0, _cfg(), agg, RANKS, mesh=mesh,
                                  local_steps=c["local_steps"], device="meta")
    units = leaf_units(like, agg)
    wire = agg.wire_bytes_per_round(like.params)
    for rank, res in enumerate(spread[0][world]):
        got = res["steps"][name]
        lay = _layout(world, rank, agg)
        for t, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            assert sorted(g) == sorted(w)
            for k in w:
                _same(g[k], w[k], f"process {rank} step {t} {k}")
        for i, (g, w, u) in enumerate(zip(got["state"], want["state"],
                                          units)):
            _same(g, _own_rows(w, u, lay), f"process {rank} leaf {i}")
        expect = _expected_bytes(agg, wire, lay,
                                 STEPS * c["local_steps"])
        if "inter_pod" in expect:  # one outer exchange a step
            expect["inter_pod"] //= c["local_steps"]
        assert got["bytes"] == expect


@pytest.mark.parametrize("world", WORLDS)
def test_trainer_checkpoint_is_the_stacked_file(spread, world):
    """The 6-step checkpoint process 0 writes at W is the stacked run's
    file, byte for byte; so is the file of W's --resume of the stacked
    3-step checkpoint; and the stacked --resume of W's 3-step checkpoint
    writes it too."""
    tmp = spread[1]
    stacked = f"{tmp}/stacked_6.ckpt"
    if not os.path.exists(stacked):
        _stacked_trainer(["--steps", "6", "--checkpoint", stacked])
    want = Path(stacked).read_bytes()
    assert Path(f"{tmp}/w{world}_6.ckpt").read_bytes() == want
    assert Path(f"{tmp}/w{world}_resumed.ckpt").read_bytes() == want
    back = f"{tmp}/stacked_from_w{world}.ckpt"
    _stacked_trainer(["--steps", "6", "--resume", f"{tmp}/w{world}_3.ckpt",
                      "--checkpoint", back])
    assert Path(back).read_bytes() == want


def _own_cell(x, unit, axis, lay):
    """A stacked state leaf's rows and model shards that process `lay`
    holds."""
    x = _own_rows(x, unit, lay)
    if axis is None or lay.local_shards == slice(0, lay.model):
        return x
    n = x.shape[axis] // lay.model
    return np.take(x, range(lay.local_shards.start * n,
                            lay.local_shards.stop * n), axis=axis)


def _model_case(name):
    """(mesh, the case's agg bound to it, the meta state) of a model step
    case on one process."""
    c = MODEL_STEP_CASES[name]
    cfg, mesh, agg, _, _ = _step_setup(distributed.StackedCollective(), name)
    like = steps.init_train_state(0, cfg, agg, num_clients(mesh), mesh=mesh,
                                  local_steps=c["local_steps"], device="meta")
    agg = steps.configure_agg(agg, mesh, c["local_steps"], params=like.params)
    return mesh, agg, like


@pytest.mark.parametrize("name", sorted(MODEL_STEP_CASES))
def test_model_steps_spread_equal_stacked(spread, name):
    """The model axis over processes: one (client, model shard) cell a
    process, each holding only its shards of every split leaf (params,
    tables, optimizer state), the client levels gathering among the
    processes of one model index, the layers computing on the shards.
    Every metric and every state leaf (the process's rows and shards)
    equals the stacked run at the same T bitwise, and each process sent
    each level's slabs of its own shards (`wire_bytes_per_round` of its
    shard of each split leaf) and to its model group activations (and
    rwkv6's `mu` and hymba's case-c projections and norms, the leaves
    those layers put together), never the whole weights
    (`launch.sharding.model_bytes`). The cases cover every family: dense
    (reduced stablelm-1.6b), moe, ssm (rwkv6), hybrid (hymba with 5 heads
    over 1 kv head at T = 2: case c, `ln` split on its last axis, `wdt`
    whole) and audio (whisper: its encoder by shard over 24 frames)."""
    c = MODEL_STEP_CASES[name]
    world = c["world"]
    want = run_steps(distributed.StackedCollective(), name)
    mesh, agg, like = _model_case(name)
    units, axes = leaf_units(like, agg), leaf_model_axes(like, agg)
    t = c["shape"][-1]
    leaves, unflatten = tree_flatten(like.params)
    shard = unflatten([torch.zeros([d // t if i == ax else d for i, d in
                                    enumerate(v.shape)], dtype=v.dtype,
                                   device="meta")
                       for v, ax in zip(leaves, agg.model_axes)])
    for rank, res in enumerate(spread[0][world]):
        got = res["steps"][name]
        lay = distributed.RankLayout(world, rank, num_clients(mesh),
                                     agg.num_pods(), t)
        assert lay.model_procs == t and lay.local == 1
        for s, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            assert sorted(g) == sorted(w)
            for k in w:
                _same(g[k], w[k], f"process {rank} step {s} {k}")
        assert len(got["state"]) == len(want["state"]) == len(units)
        for i, (g, w, u, ax) in enumerate(zip(got["state"], want["state"],
                                              units, axes)):
            _same(g, _own_cell(w, u, ax, lay), f"process {rank} leaf {i}")
        wire = agg.wire_bytes_per_round(shard)
        expect = _expected_bytes(agg, wire, lay, STEPS * c["local_steps"])
        if "inter_pod" in expect:  # one outer exchange a step
            expect["inter_pod"] //= c["local_steps"]
        expect["model"] = STEPS * c["local_steps"] * model_bytes(
            _cfg(c.get("arch", "stablelm-1.6b")), rows=1, seq=8, t=t,
            shards=1)
        assert got["bytes"] == expect


def test_model_checkpoint_crosses_layouts(spread):
    """The W = 4 run of the (2, 2) mesh (one client shard a process)
    writes the stacked run's checkpoint byte for byte; the stacked layout
    restores it to the stacked state; and W = 4 restores the stacked
    file to each process's rows and shards of that state."""
    _, tmp, stacked = spread
    stacked_file = Path(f"{tmp}/{CKPT_CASE}_stacked.ckpt").read_bytes()
    assert Path(f"{tmp}/{CKPT_CASE}_w4.ckpt").read_bytes() == stacked_file
    got = load_steps_state(distributed.StackedCollective(), CKPT_CASE,
                           f"{tmp}/{CKPT_CASE}_w4.ckpt")
    for i, (g, w) in enumerate(zip(got, stacked["state"])):
        _same(g, w, f"stacked restore leaf {i}")
    mesh, agg, like = _model_case(CKPT_CASE)
    units, axes = leaf_units(like, agg), leaf_model_axes(like, agg)
    for rank, res in enumerate(spread[0][4]):
        lay = distributed.RankLayout(4, rank, num_clients(mesh),
                                     agg.num_pods(), 2)
        for i, (g, w, u, ax) in enumerate(zip(res["resumed"],
                                              stacked["state"], units, axes)):
            _same(g, _own_cell(w, u, ax, lay), f"process {rank} leaf {i}")


# -- the layout and the refusals ----------------------------------------------

@pytest.mark.parametrize("world,pods,inner,outer,rank,ranks_of,pods_of", [
    (2, 1, [(0, 1)], [(0,), (1,)], 1, slice(2, 4), slice(0, 1)),
    (4, 1, [(0, 1, 2, 3)], [(0,), (1,), (2,), (3,)], 2, slice(2, 3),
     slice(0, 1)),
    (2, 2, [(0,), (1,)], [(0, 1)], 1, slice(2, 4), slice(1, 2)),
    (4, 2, [(0, 1), (2, 3)], [(0, 2), (1, 3)], 3, slice(3, 4), slice(1, 2)),
    (2, 4, [(0,), (1,)], [(0, 1)], 1, slice(2, 4), slice(2, 4)),
])
def test_rank_layout(world, pods, inner, outer, rank, ranks_of, pods_of):
    lay = distributed.RankLayout(world, rank, RANKS, pods)
    assert lay.partition("inner") == inner
    assert lay.partition("outer") == outer
    assert lay.partition("world") == [tuple(range(world))]
    assert (lay.local_ranks, lay.local_pods) == (ranks_of, pods_of)


@pytest.mark.parametrize("world,ranks,pods,match", [
    (3, 4, 1, "do not split over 3 processes"),
    (3, 6, 2, "straddle pods"),
    (2, 4, 3, "equal pods"),
])
def test_rank_layout_refusals(world, ranks, pods, match):
    with pytest.raises(ValueError, match=match):
        distributed.RankLayout(world, 0, ranks, pods)


@pytest.mark.parametrize(
    "world,pods,rank,ranks_of,shards_of,groups", [
        # (4, 2) at W = 8: one (client, shard) a process
        (8, 1, 3, slice(1, 2), slice(1, 2),
         {"world": [(0, 2, 4, 6), (1, 3, 5, 7)],
          "fleet": [(0, 2, 4, 6), (1, 3, 5, 7)],
          "inner": [(0, 2, 4, 6), (1, 3, 5, 7)],
          "outer": [(0,), (2,), (4,), (6,), (1,), (3,), (5,), (7,)],
          "model": [(0, 1), (2, 3), (4, 5), (6, 7)]}),
        # (2, 2, 2) at W = 8
        (8, 2, 5, slice(2, 3), slice(1, 2),
         {"inner": [(0, 2), (4, 6), (1, 3), (5, 7)],
          "outer": [(0, 4), (2, 6), (1, 5), (3, 7)],
          "model": [(0, 1), (2, 3), (4, 5), (6, 7)]}),
        # (4, 2) at W = 4: whole clients, the model axis stays in a process
        (4, 1, 2, slice(2, 3), slice(0, 2),
         {"world": [(0, 1, 2, 3)], "model": [(0,), (1,), (2,), (3,)]}),
        # (4, 2) at W = 2
        (2, 2, 1, slice(2, 4), slice(0, 2),
         {"inner": [(0,), (1,)], "outer": [(0, 1)]}),
    ])
def test_rank_layout_model_axis(world, pods, rank, ranks_of, shards_of,
                                groups):
    """The mesh's cells, row-major and contiguous per process: the model
    axis spreads only where the processes outnumber the client ranks; the
    client levels then group the processes of one model index."""
    lay = distributed.RankLayout(world, rank, RANKS, pods, 2)
    assert (lay.local_ranks, lay.local_shards) == (ranks_of, shards_of)
    for level, want in groups.items():
        assert lay.partition(level) == want, level


@pytest.mark.parametrize("world,rank,owned,served,cohort,done,rows", [
    # (4, 2) at W = 8: client process 1 (ranks 2, 3) serves client rank 1
    # and owns clients 1, 5 of 8; of cohort (1, 2, 5, 6) it owns 1 and 5,
    # served by client processes 0 and 2 (two rows out for the gather),
    # and serves client 2, owned by client process 2 (one back)
    (8, 3, (1, 5), slice(1, 2), (1, 2, 5, 6), None, 3),
    # the same with client rank 1's report dropped: the gather's rows only
    (8, 2, (1, 5), slice(1, 2), (1, 2, 5, 6), (1, 0, 1, 1), 2),
    # W = 2: client process 0 serves ranks 0, 1 and owns the even
    # clients; cohort (0, 3, 4, 7): it owns 0 and 4, serving 0 itself and
    # 4 served by process 1 (rank 2); it serves 3 (owned by process 1)
    (2, 0, (0, 2, 4, 6), slice(0, 2), (0, 3, 4, 7), None, 2),
    # W = 4 at one client process a rank: cohort (0, 1, 2, 3), each
    # client served where it is owned: nothing moves
    (4, 2, (2, 6), slice(2, 3), (0, 1, 2, 3), None, 0),
])
def test_fleet_placement_and_bytes(world, rank, owned, served, cohort, done,
                                   rows):
    """Who owns and who serves a fleet's rows over the (4, 2) mesh's
    processes, and the rows a process sends at the "fleet" level in a
    round (`fleet_bytes`, in rows of 10 bytes): client c is owned by the
    client process c mod P of the process's model index, client rank i
    served by the process holding i."""
    from repro_torch.fleet import FleetPlacement
    from repro_torch.launch.sharding import fleet_bytes

    comm = distributed.ProcessGroupCollective(4, 2, world=world, rank=rank)
    pl = FleetPlacement(comm, 4, 1, 2)
    assert tuple(pl.owned(0, 8)) == owned
    assert pl.slots == served
    assert [pl.row(c) for c in owned] == list(range(len(owned)))
    assert fleet_bytes(10, cohort, pl.layout, done=done) == 10 * rows
    assert fleet_bytes(10, cohort, pl.layout, done=[0] * 4) == 0


@pytest.mark.parametrize("world,ranks,model,match", [
    (3, 4, 2, "8 mesh cells .* do not split over 3 processes"),
    (2, 3, 2, "straddle clients"),
])
def test_rank_layout_model_refusals(world, ranks, model, match):
    with pytest.raises(ValueError, match=match):
        distributed.RankLayout(world, 0, ranks, 1, model)


def test_no_process_group_environment_raises(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no process-group environment"):
        distributed.init_process_group("gloo")
    with pytest.raises(ValueError, match="unknown backend"):
        distributed.init_process_group("mpi")
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.ProcessGroupCollective(RANKS)
    with pytest.raises(SystemExit) as exc:  # the trainer says so and exits 1
        train.main(TRAIN_ARGV + ["--dist-backend", "gloo"])
    assert exc.value.code == 1


@pytest.mark.parametrize("argv,env,match", [
    ([], {"WORLD_SIZE": "2"}, "name the backend with --dist-backend"),
    (["--dist-backend", "nccl"], {}, "needs --dist-backend gloo"),
])
def test_trainer_refusals(argv, env, match, monkeypatch, capsys):
    for k, v in {"RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": "1", **env}.items():
        monkeypatch.setenv(k, v)
    if "WORLD_SIZE" not in env:
        monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit) as exc:
        train.main(TRAIN_ARGV + argv)
    assert exc.value.code == 2
    assert match in capsys.readouterr().err
