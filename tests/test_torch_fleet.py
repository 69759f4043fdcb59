"""The port's fleet (`repro_torch.fleet`, `core.algorithms.run_fleet_rounds`)
against the reference's `repro.fleet`.

- Cohorts, async plans and injected store faults: over a grid of seeds and
  shapes the port's `CohortSampler`, `AsyncPlanner` and `FaultyStore`
  schedules equal the reference's (exact).
- The state store: the same gathers, scatters, cursor and bit updates give
  the same rows as the reference's store (exact).
- `FleetRunner` at cohort == population is bitwise the port's own
  full-participation loop (same batches, the same generator a step) for
  q, diana, diana_rr and flat-mesh DIANA-NASTYA (its pod tables round-trip
  through the store): the reference's acceptance criterion.
- Port fleet against reference fleet: 3 rounds of an 8-client population
  on the (4, 1) mesh, reduced stablelm-1.6b in f32, f32 wire at fraction
  1.0 (the window covers every block, so no draw decides anything), from
  the same initial state: every state leaf and store row within 1e-2 of
  its leaf's largest entry (+1e-6), the bound of test_torch_steps.py, and
  the checkpoint metadata (cursor, sampler, store and wire specs) equal. The
  reference's fleet runs in one subprocess (this file run as a script),
  as XLA:CPU aborts on several multi-device transformer programs in one
  process.
- The buffered-async runner's participation counters and store cursors
  equal the planner's closed-form replay; a fleet checkpoint taken
  mid-walk (async, under chaos, paged data) resumes bitwise.
- `run_fleet_rounds` equals `run_epochs` bitwise at cohort == population
  (same draws), and the reference's `run_fleet_rounds` with the draws of
  its key schedule injected at rtol 1e-5 / atol 1e-6 (the simulator's
  tolerance, test_torch_algorithms.py).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro.compression.ops import RandK as JRandK
from repro.core.algorithms import run_fleet_rounds as jax_fleet_rounds
from repro.core.rules import get_rule as jget_rule
from repro.data.logreg import make_federated_logreg as jax_logreg
from repro.data.reshuffle import ReshuffleSampler as JSampler
from repro.fleet import AsyncPlanner as JPlanner
from repro.fleet import ChaosConfig as JChaos
from repro.fleet import ClientStateStore as JStore
from repro.fleet import CohortSampler as JCohorts
from repro.fleet import FaultyStore as JFaulty
from repro.fleet import TransientStoreError as JTransient
from repro_torch.checkpoint.io import (
    load_meta,
    restore_fleet_checkpoint,
    save_fleet_checkpoint,
)
from repro_torch.compression.ops import RandK
from repro_torch.configs import get_config, reduced
from repro_torch.core import salts
from repro_torch.core.algorithms import (
    ALGORITHMS,
    init_algorithm,
    make_epoch_fn,
    run_fleet_rounds,
)
from repro_torch.core.api import tree_flatten, tree_leaves
from repro_torch.core.dist import CompressedAggregation
from repro_torch.core.rules import get_rule
from repro_torch.data.logreg import make_federated_logreg
from repro_torch.data.paging import ClientDataStore, LookaheadPager
from repro_torch.data.pipeline import (
    make_batch_stream,
    run_epochs,
    shared_slots_for_step,
)
from repro_torch.data.reshuffle import ReshuffleSampler
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.fleet import (
    AsyncFleetRunner,
    AsyncPlanner,
    ChaosConfig,
    ClientStateStore,
    CohortSampler,
    FaultyStore,
    FleetRunner,
    TransientStoreError,
)
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
S, B, N, C, ROUNDS, LR = 8, 8, 3, 8, 3, 0.05
REF_METHODS = ("diana", "diana_rr")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _tokens(cfg_vocab, pop, b=B // 4):
    return {"tokens": synthetic_token_batches(
        vocab=cfg_vocab, seq_len=S, batch=b, num_batches=N, num_clients=pop,
        seed=0)}


def _mode(method):
    return "rr_shared" if method == "diana_rr" else "rr"


def _oracle(out_path: str) -> None:
    """The reference's fleet trajectories (run in a subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced
    from repro.core.dist import CompressedAggregation
    from repro.core.rules import WIRE_RULES
    from repro.data.reshuffle import ReshuffleSampler
    from repro.fleet import ClientStateStore, CohortSampler, FleetRunner
    from repro.launch import compat, steps
    from repro.launch.mesh import make_test_mesh

    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b"), seq=S),
                              dtype=jnp.float32)
    mesh = make_test_mesh((4, 1), ("data", "model"))
    data = _tokens(cfg.vocab, C)
    out = {}
    for method in REF_METHODS:
        agg = CompressedAggregation(
            method=method, wire="shared", fraction=1.0,
            n_slots=N if method == "diana_rr" else 1,
            shift_dtype=jnp.float32, mean_scale=4 / C)
        jitted, abstract, shardings, batch_sh = steps.make_train_step(
            cfg, mesh, agg=agg, lr=LR, remat=False, seq_shard=False)
        with compat.set_mesh(mesh):
            state = steps.init_train_state(jax.random.key(0), cfg, agg, 4,
                                           mesh=mesh)
            for i, x in enumerate(jax.tree.leaves(state)):
                out[f"{method}/init/{i}"] = np.asarray(x)
            state = jax.device_put(state, shardings)
            store = ClientStateStore.create(
                abstract.params, C, WIRE_RULES[method], n_slots=agg.n_slots,
                dtype=np.float32, shard_size=3)
            with FleetRunner(jitted, abstract, shardings, batch_sh, agg=agg,
                             mesh=mesh, data=data,
                             sampler=ReshuffleSampler(C, N, mode=_mode(method),
                                                      seed=1),
                             cohorts=CohortSampler(C, 4, seed=9),
                             store=store) as runner:
                state = runner.run(state, jax.random.key(4), ROUNDS)
                out[f"{method}/meta"] = np.array(json.dumps(
                    runner.checkpoint_meta()))
        for i, x in enumerate(jax.tree.leaves(jax.device_get(state))):
            out[f"{method}/final/{i}"] = np.asarray(x)
        for i, x in enumerate(jax.tree.leaves(store.gather(np.arange(C)))):
            out[f"{method}/store/{i}"] = np.asarray(x)
        out[f"{method}/cursor"] = store.cursor
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# schedules: cohorts, async plans, injected store faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("population,cohort,mode,seed", [
    (10, 3, "rr", 0), (10, 3, "rr", 7), (12, 4, "rr", 1), (7, 7, "rr", 2),
    (9, 2, "with_replacement", 3), (25, 6, "rr", 11), (5, 1, "rr", 4)])
def test_cohort_sampler_equals_reference(population, cohort, mode, seed):
    port = CohortSampler(population, cohort, mode=mode, seed=seed)
    ref = JCohorts(population, cohort, mode=mode, seed=seed)
    rounds = 3 * population // cohort + 2
    for t in range(rounds):
        assert np.array_equal(port.cohort_for_round(t),
                              ref.cohort_for_round(t))
        assert port.cursor(t) == ref.cursor(t)
    for t in (0, 1, rounds // 2, rounds):
        assert np.array_equal(port.participation_counts(t),
                              ref.participation_counts(t))
    if mode == "rr":
        for e in (3, 0, 2):  # random access, out of order
            assert np.array_equal(port.effective_order(e),
                                  ref.effective_order(e))
    assert port.spec() == ref.spec()


PLANS = [dict(m=4), dict(m=4, buffer_k=3, late="drop",
                         chaos=dict(dropout=0.2, straggler=0.3, seed=0)),
         dict(m=5, buffer_k=2, late="discount", discount=0.7,
              chaos=dict(dropout=0.4, straggler=0.5, delay=2.0, seed=3)),
         dict(m=3, buffer_k=1, chaos=dict(straggler=0.9, seed=9)),
         dict(m=6, buffer_k=4, late="drop", chaos=dict(dropout=0.6, seed=5),
              resize=True)]


@pytest.mark.parametrize("kw", PLANS)
def test_async_planner_equals_reference(kw):
    kw = dict(kw)
    chaos = kw.pop("chaos", {})
    m = kw.pop("m")
    resize = (lambda t: 1 + t % m) if kw.pop("resize", False) else None
    port = AsyncPlanner(m, chaos=ChaosConfig(**chaos), resize=resize, **kw)
    ref = JPlanner(m, chaos=JChaos(**chaos), resize=resize, **kw)
    assert port.spec() == ref.spec() and port.may_defer == ref.may_defer
    cohort = np.arange(m)
    for t in range(20):
        a, b = port(t, cohort), ref(t, cohort)
        for f in a._fields:
            assert np.array_equal(getattr(a, f), getattr(b, f)), (t, f)


@pytest.mark.parametrize("store_fail,seed", [(0.2, 0), (0.5, 3), (0.9, 1)])
def test_faulty_store_schedule_equals_reference(store_fail, seed):
    params = {"w": np.zeros((3,), np.float32)}
    chaos = dict(store_fail=store_fail, seed=seed)
    port = FaultyStore(ClientStateStore.create(params, 6, get_rule("single")),
                       ChaosConfig(**chaos))
    ref = JFaulty(JStore.create(params, 6, jget_rule("single")),
                  JChaos(**chaos))
    cohort = np.array([1, 4])
    outcomes = []
    for store, err in ((port, TransientStoreError), (ref, JTransient)):
        seen = []
        for i in range(40):
            op = ("gather", "advance", "add_bits", "scatter")[i % 4]
            try:
                if op == "gather":
                    store.gather(cohort)
                elif op == "advance":
                    store.advance(cohort, 1)
                elif op == "add_bits":
                    store.add_bits(cohort, 8.0)
                else:
                    store.scatter(cohort, {"w": np.ones((2, 3), np.float32)})
                seen.append(True)
            except err:
                seen.append(False)
        outcomes.append((seen, store.injected_failures,
                         store.cursor.tolist(), store.bits.tolist()))
    assert outcomes[0] == outcomes[1]


# ---------------------------------------------------------------------------
# the state store
# ---------------------------------------------------------------------------

def _store_params():
    return {"w": np.zeros((3, 5), np.float32), "b": np.zeros((4,), np.float32)}


@pytest.mark.parametrize("rule_name", ["single", "per_slot"])
def test_store_rows_equal_reference(rule_name, tmp_path):
    port = ClientStateStore.create(_store_params(), 11, get_rule(rule_name),
                                   n_slots=2, shard_size=3,
                                   path=str(tmp_path / "p"))
    ref = JStore.create(_store_params(), 11, jget_rule(rule_name), n_slots=2,
                        shard_size=3, path=str(tmp_path / "j"))
    rng = np.random.default_rng(0)
    for cohort in ([0, 2, 5, 10], [1, 2, 3], [4, 9]):
        cohort = np.array(cohort)
        upd = {k: rng.normal(size=v.shape).astype(np.float32)
               for k, v in ref.gather(cohort).items()}
        port.scatter(cohort, {k: torch.from_numpy(v) for k, v in upd.items()})
        ref.scatter(cohort, upd)
        port.advance(cohort, 2)
        ref.advance(cohort, 2)
        port.add_bits(cohort, 640.0)
        ref.add_bits(cohort, 640.0)
    every = np.arange(11)
    got, want = port.gather(every), ref.gather(every)
    for k in want:
        assert got[k].numpy().tobytes() == want[k].tobytes()
    assert np.array_equal(port.cursor, ref.cursor)
    assert np.array_equal(port.bits, ref.bits)
    assert port.spec() == ref.spec()
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "j"))
    assert ClientStateStore.estimate_nbytes(
        _store_params(), 11, get_rule(rule_name), n_slots=2) == \
        JStore.estimate_nbytes(_store_params(), 11, jget_rule(rule_name),
                               n_slots=2)


def test_store_rejects_bad_cohorts_and_paths(tmp_path):
    store = ClientStateStore.create(_store_params(), 8, get_rule("single"),
                                    shard_size=4)
    with pytest.raises(ValueError, match="strictly increasing"):
        store.gather(np.array([2, 1]))
    with pytest.raises(ValueError, match=r"outside \[0, 8\): \[9\]"):
        store.gather(np.array([9, 2]))
    got = store.gather(np.array([0, 1]))
    with pytest.raises(ValueError, match="cohort slice"):
        store.scatter(np.array([0, 1, 2]), got)
    not_a_dir = tmp_path / "occupied"
    not_a_dir.write_bytes(b"x")
    with pytest.raises(OSError, match="not a writable directory"):
        ClientStateStore.create(_store_params(), 4, get_rule("single"),
                                path=str(not_a_dir))


# ---------------------------------------------------------------------------
# the fleet runner on the train step
# ---------------------------------------------------------------------------

def _setup(method, *, pop=4, fraction=0.25, elastic=False, local_steps=1):
    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b"), seq=S),
                              dtype=torch.float32)
    mesh = make_mesh((4, 1))
    agg = CompressedAggregation(
        method=method, fraction=fraction,
        n_slots=N if method == "diana_rr" else 1, shift_dtype=torch.float32,
        mean_scale=4 / pop)
    step = steps.make_train_step(
        cfg, mesh, agg=agg, lr=LR, eta=0.1 if local_steps > 1 else None,
        local_steps=local_steps, remat=False, elastic=elastic)
    state = steps.init_train_state(0, cfg, agg, 4, mesh=mesh, device="cpu",
                                   local_steps=local_steps)
    return cfg, mesh, agg, step, state


def _store(agg, state, pop, **kw):
    return ClientStateStore.create(state.params, pop, agg.rule,
                                   n_slots=agg.n_slots,
                                   dtype=torch.float32, shard_size=3, **kw)


def _copy(state):
    leaves, unflatten = tree_flatten(state)
    return unflatten([x.clone() for x in leaves])


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("method,local_steps", [
    ("q", 1), ("diana", 1), ("diana_rr", 1), ("diana", 2)])
def test_full_cohort_fleet_is_the_full_participation_loop(method,
                                                          local_steps):
    """local_steps 2 is flat-mesh DIANA-NASTYA, whose per-client tables are
    the pod tables: the fleet round-trips `pod_shifts` through the store."""
    cfg, mesh, agg, step, state0 = _setup(method, local_steps=local_steps)
    data = _tokens(cfg.vocab, 4)
    sampler = ReshuffleSampler(4, N, mode=_mode(method), seed=1)
    rounds = N + 2  # across a data epoch
    state = _copy(state0)
    with make_batch_stream(data, sampler, local_steps=local_steps,
                           prefetch=False) as stream:
        for t in range(rounds):
            slots = (shared_slots_for_step(sampler, t, n_slots=N)
                     if method == "diana_rr" else None)
            state, _ = step(state, next(stream), salts.step_generator(
                0, salts.ROUNDS_KEY_SALT, t, "cpu"), slots)
    store = _store(agg, state0, 4)
    with FleetRunner(step, state0.params, agg=agg, mesh=mesh, data=data,
                     sampler=sampler, cohorts=CohortSampler(4, 4, seed=9),
                     store=store, local_steps=local_steps,
                     device="cpu") as runner:
        fleet = runner.run(_copy(state0), 0, rounds)
    assert _equal(fleet, state)
    table = state.pod_shifts if local_steps > 1 else state.shifts
    if agg.rule.has_shifts:
        got = store.gather(np.arange(4))
        assert all(torch.equal(g, s) for g, s in zip(
            tree_leaves(got), tree_leaves(table)))
    assert np.array_equal(store.cursor, np.full(4, rounds * local_steps))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_fleet") / "fleet.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    r = subprocess.run([sys.executable, __file__, str(path)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(path))


def _close(got, want, what):
    g = got.detach().to(torch.float32).numpy()
    w = np.asarray(want, np.float32)
    bound = 1e-2 * float(np.abs(w).max()) + 1e-6
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


@pytest.mark.parametrize("method", REF_METHODS)
def test_fleet_matches_reference_fleet(oracle, method):
    cfg, mesh, agg, step, like = _setup(method, pop=C, fraction=1.0)
    leaves, unflatten = tree_flatten(like)
    state = unflatten([torch.from_numpy(oracle[f"{method}/init/{i}"]).clone()
                       for i in range(len(leaves))])
    store = _store(agg, state, C)
    with FleetRunner(step, state.params, agg=agg, mesh=mesh,
                     data=_tokens(cfg.vocab, C),
                     sampler=ReshuffleSampler(C, N, mode=_mode(method),
                                              seed=1),
                     cohorts=CohortSampler(C, 4, seed=9),
                     store=store, device="cpu") as runner:
        state = runner.run(state, 0, ROUNDS)
        assert runner.checkpoint_meta() == json.loads(
            str(oracle[f"{method}/meta"]))
    for i, x in enumerate(tree_leaves(state)):
        _close(x, oracle[f"{method}/final/{i}"], f"{method} state leaf {i}")
    for i, x in enumerate(tree_leaves(store.gather(np.arange(C)))):
        _close(x, oracle[f"{method}/store/{i}"], f"{method} store leaf {i}")
    assert np.array_equal(store.cursor, oracle[f"{method}/cursor"])


CHAOS = dict(dropout=0.2, straggler=0.3, store_fail=0.2, seed=0)


def _async_runner(step, state, agg, mesh, data, store, *, start_round=0,
                  paged=None):
    return AsyncFleetRunner(
        step, state.params, agg=agg, mesh=mesh, data=data,
        sampler=ReshuffleSampler(C, N, seed=1),
        cohorts=CohortSampler(C, 4, seed=2), store=store, buffer_k=3,
        late="drop", chaos=ChaosConfig(**CHAOS), start_round=start_round,
        paged=paged, device="cpu")


def test_async_counters_equal_planner_replay():
    cfg, mesh, agg, step, state = _setup("diana", pop=C, elastic=True)
    store = _store(agg, state, C)
    seen = []
    with _async_runner(step, state, agg, mesh, _tokens(cfg.vocab, C),
                       store) as runner:
        runner.run(state, 0, 6, callback=lambda t, s, mt: seen.append(mt))
    planner = JPlanner(4, buffer_k=3, late="drop", chaos=JChaos(**CHAOS))
    cohorts = JCohorts(C, 4, seed=2)
    cursor = np.zeros(C, np.int64)
    for t, mt in enumerate(seen):
        cohort = cohorts.cohort_for_round(t)
        plan = planner(t, cohort)
        assert mt["completed"] == int(plan.completes.sum())
        assert mt["on_time"] == int(plan.on_time.sum())
        assert mt["dropped"] == int(plan.on_time.size - plan.reported.sum())
        cursor[cohort[plan.completes]] += 1
    assert np.array_equal(store.cursor, cursor)


def test_fleet_checkpoint_mid_walk_resumes_bitwise(tmp_path):
    """Async, under chaos, on paged data: 2 rounds, a fleet checkpoint,
    then 3 more rounds from it equal 5 rounds straight through."""
    cfg, mesh, agg, step, state0 = _setup("diana", pop=C, elastic=True)
    data = _tokens(cfg.vocab, C)

    def paged(d):
        return LookaheadPager(ClientDataStore.from_stacked(
            str(tmp_path / d), data, shard_size=3))

    store = _store(agg, state0, C)
    with _async_runner(step, state0, agg, mesh, None, store,
                       paged=paged("a")) as runner:
        straight = runner.run(_copy(state0), 0, 5)
    store = _store(agg, state0, C)
    pager = paged("b")
    with _async_runner(step, state0, agg, mesh, None, store,
                       paged=pager) as runner:
        state = runner.run(_copy(state0), 0, 2)
        path = str(tmp_path / "fleet.ckpt")
        save_fleet_checkpoint(path, state, store, step=int(state.step),
                              meta={"fleet": runner.checkpoint_meta()},
                              data_store=pager.data)
    meta = load_meta(path)["meta"]["fleet"]
    assert meta["round"] == 2 and meta["async"]["late"] == "drop"
    fresh = _store(agg, state0, C)
    pager = paged("b")
    state = restore_fleet_checkpoint(path, state0, fresh, device="cpu",
                                     data_store=pager.data)
    with _async_runner(step, state0, agg, mesh, None, fresh, start_round=2,
                       paged=pager) as runner:
        resumed = runner.run(state, 0, 3)
    assert _equal(resumed, straight)
    with pytest.raises(Exception, match="data store"):
        restore_fleet_checkpoint(path, state0, _store(agg, state0, C),
                                 device="cpu")


def test_slotted_fleet_gates():
    cfg, mesh, agg, step, state = _setup("diana_rr", pop=C)
    kw = dict(agg=agg, mesh=mesh, data=_tokens(cfg.vocab, C),
              store=_store(agg, state, C), device="cpu")
    with pytest.raises(ValueError, match="rr_shared"):
        FleetRunner(step, state.params, sampler=ReshuffleSampler(C, N),
                    cohorts=CohortSampler(C, 4), **kw)
    with pytest.raises(ValueError, match="cohort-RR"):
        FleetRunner(step, state.params,
                    sampler=ReshuffleSampler(C, N, mode="rr_shared"),
                    cohorts=CohortSampler(C, 4, mode="with_replacement"), **kw)


# ---------------------------------------------------------------------------
# the simulator's fleet driver
# ---------------------------------------------------------------------------

KW = dict(m=6, n_batches=4, batch=5, d=32, cond=50.0, seed=0)


@pytest.mark.parametrize("name", ["q_rr", "diana", "diana_rr"])
def test_run_fleet_rounds_is_run_epochs_at_full_cohort(name):
    prob = make_federated_logreg(device="cpu", **KW)
    comp = RandK(fraction=0.5)
    starts = torch.from_numpy(np.random.default_rng(1).integers(
        0, prob.d, (2, prob.n, prob.m)))
    sampler = ReshuffleSampler(prob.m, prob.n, mode="rr_once", seed=2)
    spec = ALGORITHMS[name]
    params0 = {"w": torch.zeros(prob.d)}
    store = ClientStateStore.create(params0, prob.m, get_rule(spec.shift_mode),
                                    n_slots=prob.n, shard_size=4)
    pf, info = run_fleet_rounds(
        name, prob.loss_fn(), comp, gamma=0.05, params=params0,
        data=prob.data, sampler=sampler, store=store,
        cohort_sampler=CohortSampler(prob.m, prob.m, seed=1),
        rounds=2 * prob.n, draws=lambda t: starts[t // prob.n, t % prob.n])
    _, epoch = make_epoch_fn(name, prob.loss_fn(), comp, gamma=0.05)
    st = init_algorithm(spec, params0, prob.m, prob.n)
    st = run_epochs(epoch, st, prob.data, sampler, epochs=2,
                    draws=lambda e: {"starts": starts[e]})
    assert torch.equal(pf["w"], st.params["w"])
    if store.has_shifts:
        assert torch.equal(store.gather(np.arange(prob.m))["w"],
                           st.shifts["w"])
    assert info["rounds"] == 2 * prob.n
    assert np.array_equal(store.cursor, np.full(prob.m, 2 * prob.n))


@pytest.mark.parametrize("name", ["diana", "q_rr"])
def test_run_fleet_rounds_matches_reference(name):
    kw = dict(KW, m=12)
    prob, jprob = make_federated_logreg(device="cpu", **kw), jax_logreg(**kw)
    rule = ALGORITHMS[name].shift_mode
    key = jax.random.PRNGKey(5)
    rounds = 9

    def draws(t):
        return torch.from_numpy(np.array(jax.random.randint(
            jax.random.fold_in(key, t), (3,), 0, prob.d)))

    store = ClientStateStore.create({"w": torch.zeros(prob.d)}, 12,
                                    get_rule(rule), shard_size=5)
    jstore = JStore.create({"w": jnp.zeros((prob.d,))}, 12, jget_rule(rule),
                           shard_size=5)
    p, info = run_fleet_rounds(
        name, prob.loss_fn(), RandK(fraction=0.5), gamma=0.05,
        params={"w": torch.zeros(prob.d)}, data=prob.data,
        sampler=ReshuffleSampler(12, 4, mode="rr", seed=3), store=store,
        cohort_sampler=CohortSampler(12, 3, seed=7), rounds=rounds,
        draws=draws)
    jp, jinfo = jax_fleet_rounds(
        name, jprob.loss_fn(), JRandK(fraction=0.5), gamma=0.05,
        params={"w": jnp.zeros((prob.d,))}, data=jprob.data,
        sampler=JSampler(12, 4, mode="rr", seed=3), store=jstore,
        cohort_sampler=JCohorts(12, 3, seed=7), rounds=rounds, key=key)
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-5, atol=1e-6)
    if store.has_shifts:
        np.testing.assert_allclose(store.gather(np.arange(12))["w"].numpy(),
                                   jstore.gather(np.arange(12))["w"],
                                   rtol=1e-5, atol=1e-6)
    assert np.array_equal(store.cursor, jstore.cursor)
    assert np.array_equal(store.bits, jstore.bits)
    assert info == jinfo


def test_run_fleet_rounds_rejects_mismatches():
    prob = make_federated_logreg(device="cpu", **KW)
    store = ClientStateStore.create({"w": torch.zeros(prob.d)}, 5,
                                    get_rule("single"))
    with pytest.raises(ValueError, match="population mismatch"):
        run_fleet_rounds("diana", prob.loss_fn(), RandK(fraction=0.5),
                         gamma=0.05, params={"w": torch.zeros(prob.d)},
                         data=prob.data, sampler=ReshuffleSampler(6, 4),
                         store=store, cohort_sampler=CohortSampler(5, 2),
                         rounds=1)
    with pytest.raises(ValueError, match="local-family"):
        run_fleet_rounds("q_nastya", prob.loss_fn(), RandK(fraction=0.5),
                         gamma=0.05, params={"w": torch.zeros(prob.d)},
                         data=prob.data, sampler=ReshuffleSampler(6, 4),
                         store=store, cohort_sampler=CohortSampler(5, 2),
                         rounds=1)


if __name__ == "__main__":
    _oracle(sys.argv[1])


# ---------------------------------------------------------------------------
# the fleet over processes: the trainer under torchrun's environment
# ---------------------------------------------------------------------------
#
# The trainer's fleet (`--clients 8`, reduced stablelm-1.6b on the (4, 2)
# mesh) at W = 2, 4 and 8 gloo processes, spawned once for the module (the
# three worlds at once, one intra-op thread a process), against the same
# runs on one process: the checkpoint process 0 writes is the one-process
# file byte for byte (every state leaf and every owner's store rows put
# together), and each process sent at the "fleet" level exactly
# `launch.sharding.fleet_bytes` of its rounds. At W = 2 a process serves
# two client ranks of both shards, at W = 4 one, at W = 8 one rank's one
# shard (the model axis spread too).

FLEET_WORLDS = (2, 4, 8)
FLEET_ARGV = ["--device", "cpu", "--reduced", "--seq", "8", "--log-every",
              "100", "--clients", "8", "--wire-dtype", "packed8"]
ASYNC_ARGV = ["--buffer-k", "3", "--late", "drop", "--chaos-dropout", "0.2",
              "--chaos-straggler", "0.3", "--chaos-store-fail", "0.2"]
# run name -> (argv, rounds, start round); {d} is the run's own directory
FLEET_RUNS = {
    # per-slot DIANA-RR: the slotted tables' rows cross processes
    "sync": (["--agg", "diana_rr", "--sampling", "rr_shared", "--steps", "3"],
             3, 0),
    # buffered-async under chaos, paged data, the store's rows in memmaps
    "async": (["--agg", "diana", "--steps", "4", *ASYNC_ARGV,
               "--data-store", "{d}/data", "--store-path", "{d}/rows"], 4, 0),
    # flat-mesh DIANA-NASTYA: every client its own pod, `pod_shifts`
    "nastya": (["--agg", "diana", "--local-steps", "2", "--eta", "0.2",
                "--steps", "3"], 3, 0),
    # resumed at W from the one-process file of the sync run's 2 rounds
    "resumed": (["--agg", "diana_rr", "--sampling", "rr_shared", "--steps",
                 "4", "--resume", "{tmp}/one_sync2.ckpt"], 4, 2),
}


def _fleet_argv(name, tmp, d):
    argv, _, _ = FLEET_RUNS[name]
    return FLEET_ARGV + [a.format(tmp=tmp, d=d) for a in argv] + [
        "--checkpoint", f"{d}/out.ckpt"]


def _fleet_wire(out: str) -> dict:
    """The bytes a trainer run's process reported it sent, by level."""
    line = [x for x in out.splitlines() if x.startswith("wire: ")][-1]
    return json.loads(line[len("wire: "):])["bytes_sent"]


def _fleet_worker(rank, world, ports, tmp, out):
    """One spawned process: each fleet run as torchrun starts the trainer
    (its environment, a store the test process hosts)."""
    import contextlib
    import io

    torch.set_num_threads(1)
    try:
        from repro_torch.launch import train

        res = {}
        for (name, port) in zip(FLEET_RUNS, ports):
            d = f"{tmp}/w{world}_{name}"
            env = {"RANK": str(rank), "WORLD_SIZE": str(world),
                   "LOCAL_RANK": str(rank), "MASTER_ADDR": "localhost",
                   "MASTER_PORT": str(port),
                   "TORCHELASTIC_USE_AGENT_STORE": "True"}
            os.environ.update(env)
            text = io.StringIO()
            try:
                with contextlib.redirect_stdout(text):
                    train.main(_fleet_argv(name, tmp, d)
                               + ["--dist-backend", "gloo"])
            finally:
                for k in env:
                    os.environ.pop(k, None)
            res[name] = _fleet_wire(text.getvalue())
        out.put((world, rank, res))
    except BaseException as exc:
        import traceback

        out.put((world, rank, traceback.format_exc()))
        raise exc


def _one_process(argv):
    from repro_torch.launch import train

    return train.main(argv)


@pytest.fixture(scope="module")
def spread_fleet(tmp_path_factory):
    """{world: [each process's bytes by run]} and the directory holding
    every run's checkpoint; the one-process runs' files beside them."""
    import queue

    import torch.distributed as dist

    tmp = str(tmp_path_factory.mktemp("fleet"))
    _one_process(FLEET_ARGV + FLEET_RUNS["sync"][0][:-1]
                 + ["2", "--checkpoint", f"{tmp}/one_sync2.ckpt"])
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    stores, procs = [], []
    for world in FLEET_WORLDS:
        ports = []
        for _ in FLEET_RUNS:
            store = dist.TCPStore("localhost", 0, world, is_master=True,
                                  wait_for_workers=False)
            stores.append(store)
            ports.append(store.port)
        for rank in range(world):
            p = ctx.Process(target=_fleet_worker,
                            args=(rank, world, ports, tmp, out))
            p.start()
            procs.append(p)
    # the one-process runs while the spread ones run
    for name in FLEET_RUNS:
        os.makedirs(f"{tmp}/one_{name}", exist_ok=True)
        _one_process(_fleet_argv(name, tmp, f"{tmp}/one_{name}"))
    results = {w: [None] * w for w in FLEET_WORLDS}
    try:
        for _ in procs:
            world, rank, res = out.get(timeout=300)
            if isinstance(res, str):
                raise RuntimeError(f"W={world} process {rank} failed:\n{res}")
            results[world][rank] = res
    except queue.Empty:
        raise RuntimeError("a spawned process gave no result in 300 s")
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(10)
    assert not [p.exitcode for p in procs if p.exitcode], "spawn failed"
    return results, tmp


def _fleet_rows(world, rank, name):
    """(the process's layout, one client's store row on it in bytes) of
    a fleet run, from a layout planned on the meta device."""
    from repro_torch.fleet import FleetPlacement
    from repro_torch.launch import distributed, train

    args = train.build_parser().parse_args(_fleet_argv(name, "", "x"))
    cfg = reduced(get_config("stablelm-1.6b"), seq=8)
    mesh = train.train_mesh(args)
    comm = distributed.ProcessGroupCollective(4, 2, world=world, rank=rank)
    agg = train._aggregation(args, 4, train.N_BATCHES, comm)
    whole = train.transformer.init_params(0, cfg, "meta")
    wired = steps.configure_agg(agg, mesh, args.local_steps, params=whole)
    like = steps.init_train_state(0, cfg, agg, 4, mesh=mesh,
                                  local_steps=args.local_steps, device="meta")
    placement = FleetPlacement.of(wired, 4)
    store = ClientStateStore.create(like.params, 1 + placement.procs,
                                    wired.rule, n_slots=wired.n_slots,
                                    placement=placement)
    return placement.layout, store.row_nbytes


@pytest.mark.parametrize("world", FLEET_WORLDS)
@pytest.mark.parametrize("name", sorted(FLEET_RUNS))
def test_fleet_over_processes_is_the_one_process_fleet(spread_fleet, name,
                                                       world):
    """Process 0's checkpoint is the one-process run's file byte for byte
    (the state, the cursors and bit counters, every owner's rows put
    together leaf by leaf), resumed at W from a one-process file too; and
    each process's "fleet" bytes are `fleet_bytes` of its rounds: the
    sync and NASTYA rounds' cohorts, the async rounds' completers from the
    planner's replay."""
    from repro_torch.launch.sharding import fleet_bytes

    results, tmp = spread_fleet
    want = Path(f"{tmp}/one_{name}/out.ckpt").read_bytes()
    assert Path(f"{tmp}/w{world}_{name}/out.ckpt").read_bytes() == want
    _, rounds, start = FLEET_RUNS[name]
    from repro_torch.launch import train

    args = train.build_parser().parse_args(_fleet_argv(name, "", "x"))
    cohorts = CohortSampler(C, 4, seed=2)
    planner = (AsyncPlanner(4, buffer_k=args.buffer_k, late=args.late,
                            discount=args.discount,
                            chaos=train.chaos_from_args(args))
               if name == "async" else None)
    moved = 0
    for rank, res in enumerate(results[world]):
        lay, row = _fleet_rows(world, rank, name)
        expect = 0
        for t in range(start, rounds):
            cohort = cohorts.cohort_for_round(t)
            done = None if planner is None else planner(t, cohort).completes
            expect += fleet_bytes(row, cohort, lay, done=done)
        assert res[name].get("fleet", 0) == expect, (rank, res[name])
        moved += expect
    assert moved > 0


@pytest.mark.parametrize("world", FLEET_WORLDS)
def test_one_process_resumes_a_spread_fleet_file(spread_fleet, world):
    """The one-process trainer resumed from W's 3-round sync file runs
    round 3 into the uninterrupted 4-round file (written at W from the
    one-process 2-round file)."""
    results, tmp = spread_fleet
    back = f"{tmp}/one_from_w{world}.ckpt"
    argv = _fleet_argv("resumed", tmp, "x")
    argv[argv.index("--resume") + 1] = f"{tmp}/w{world}_sync/out.ckpt"
    argv[argv.index("--checkpoint") + 1] = back
    _one_process(argv)
    assert Path(back).read_bytes() == Path(
        f"{tmp}/one_resumed/out.ckpt").read_bytes()


def test_store_shards_fit_a_checkpoint_buffer():
    """A store shard's leaf is one checkpoint buffer (msgpack's bin32,
    under 2^32 bytes): at 2 layers stablelm-1.6b's largest row of f32
    shifts, the embedding's (0.82 GB), takes 5 rows a shard of a
    population of 8, at its 24 the stacked FFN's (1.11 GB) 3; 4 rows of
    the embedding fit one shard, and so do the reduced model's rows of 8
    clients (not of 10^6) and a memory-free rule's; a row past the limit
    alone (8 slots of 1.11 GB) gets one."""
    from repro_torch.fleet.store import checkpoint_shard_size
    from repro_torch.models import transformer as tt

    cfg = get_config("stablelm-1.6b")
    full = tt.init_params(0, cfg, "meta")
    cut = tt.init_params(0, dataclasses.replace(cfg, num_layers=2), "meta")
    small = tt.init_params(0, reduced(get_config("stablelm-1.6b"), seq=S),
                           "meta")
    assert checkpoint_shard_size(cut, 8, get_rule("single")) == 5
    assert checkpoint_shard_size(cut, 4, get_rule("single")) == 65_536
    assert checkpoint_shard_size(full, 8, get_rule("single")) == 3
    assert checkpoint_shard_size(full, 8, get_rule("per_slot"),
                                 n_slots=8) == 1
    assert checkpoint_shard_size(small, 8, get_rule("single")) == 65_536
    # 10^6 clients of the reduced model's 262,144-byte rows: 16,383 a shard
    assert checkpoint_shard_size(small, 10**6, get_rule("single")) == 16_383
    assert checkpoint_shard_size(full, 8, get_rule("none")) == 65_536
