"""The dry run: one process's step of every (arch x input shape x
production mesh), traced on fake tensors, with no card (port of
`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-67b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out dryrun.jsonl

For each pair this runs the step that shape exercises (train:
`steps.make_train_step`, with the slot vector for per-slot methods and
the elastic weights under `--buffer-k`/`--chaos-dropout`; prefill:
`make_prefill_step`; decode: `make_serve_step`) as process 0 of the
reference's production mesh, (16, 16) or (2, 16, 16), one (client, model
shard) a process, as `launch.train.reckon` sizes it: its state from
`init_train_state` (or its shards of the parameters and its slice of the
cache) and its share of the shape's batch, all fake tensors
(`launch.cost_analysis`). It records the step's traced peak memory, its
FLOPs, bytes and kernel launches, its messages by level and the
three-term roofline at an H100's data-sheet peaks, beside `reckon`'s
terms and whether the peak fits an H100's 80 GB.

The reference compiles the full depth with a `lax.scan` layer loop, whose
cost model counts a loop body once, so its FLOPs and bytes come from two
unrolled depth probes extrapolated to the depth (`--no-probes`,
`models/flags.py`). The port's layer loop is Python: the census sees every
layer at full depth, and there are no probes and no flags module to port.
MoE routing in the census is balanced (`models.moe.expert_counts`: the
record says "moe_routing": "balanced") and NASTYA's pod orders the
identity; both run the card's ops.

Each record is one JSON line with the reference's keys ("status" "ok",
"skipped" with `shape_supported`'s reason, or "error"; "memory",
"roofline", "top_collectives", "model_params", "active_params", "agg",
"remat", "seq_shard", "local_steps", "elastic", "fleet") and the port's:
"kernels" (launches and bytes a kernel), "collectives_by_level",
"reckon" (train: `launch.train.reckon`'s terms and total beside the
traced peak) and "fits" (the traced peak against `train.H100_BYTES`).
`python -m repro_torch.launch.roofline FILE` tabulates a grid.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import salts
from repro_torch.configs.shapes import (
    INPUT_SHAPES,
    InputShape,
    input_specs,
    shape_supported,
)
from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.data.pipeline import abstract_stream_batch
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import distributed, sharding, steps, train
from repro_torch.launch.mesh import (
    make_production_mesh,
    model_size,
    num_clients,
    num_pods,
)
from repro_torch.models import transformer

N_SLOTS = train.N_BATCHES  # diana_rr's slot rows, as the trainer sizes them


def _train_args(arch, shape, *, multi_pod, agg_method, agg_wire, wire_dtype,
                fraction, local_steps, clients):
    argv = ["--arch", arch, "--agg", agg_method, "--wire", agg_wire,
            "--wire-dtype", wire_dtype, "--fraction", str(fraction),
            "--batch", str(shape.global_batch), "--seq", str(shape.seq_len),
            "--local-steps", str(local_steps),
            "--multi-pod" if multi_pod else "--production-mesh"]
    if clients is not None:
        argv += ["--clients", str(clients)]
    return train.build_parser().parse_args(argv)


def _collectives(records) -> tuple[dict, list]:
    stats = ca.collective_stats(records)
    by_level = {lvl: {"count": stats.count_by_kind[lvl],
                      "bytes": stats.bytes_by_kind[lvl]}
                for lvl in stats.bytes_by_kind}
    by_level["by_key"] = stats.bytes_by_key
    top = [(f"{b:.3e}", lvl, shp) for b, lvl, shp in stats.top[:5]]
    return by_level, top


class TrainTrace(NamedTuple):
    """`trace_train`'s result: the ops census (`ops.kern` the kernels'),
    the wire bound to the mesh, the state's bytes, the state handed to
    the step and the state it returned."""

    ops: ca.OpCensus
    wired: Any
    held: int
    state: Any
    stepped: Any


def trace_train(cfg, mesh, agg, *, rows: int, seq: int, remat="full",
                ce="gather", seq_shard=True, local_steps=1, elastic=False,
                weights=None, fake=True) -> TrainTrace:
    """One process's train step on fake tensors. `agg` is the unbound
    wire, its collective a `CensusCollective` (the process's layout, whose
    records the step's messages fill); `rows` the process's sequences of
    `seq` tokens a local step; `weights` the elastic step's (m,) weights
    (ones by default), which the census watches (`OpCensus.watch`). With
    `fake` False the same step runs on real tensors of the census device
    under the same census (the tests hold the two to each other). The
    dry run's records and the step census (`analysis.graph`) both read
    it."""
    m = num_clients(mesh)
    dev = ca.census_device()
    mode = ca.fake_mode() if fake else None
    specs = abstract_stream_batch(input_specs(
        cfg, InputShape("process", seq, rows, "train"))["batch"],
        local_steps)
    with mode or contextlib.nullcontext():
        state = steps.init_train_state(0, cfg, agg, m, mesh=mesh,
                                       local_steps=local_steps, device=dev)
        step = steps.make_train_step(cfg, mesh, agg=agg, remat=remat, ce=ce,
                                     seq_shard=seq_shard,
                                     local_steps=local_steps, elastic=elastic)
        batch = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                               device=dev), specs)
        gen = salts.step_generator(0, salts.ROUNDS_KEY_SALT, 0, dev)
        w = None
        if elastic:
            w = torch.tensor(np.ones(m) if weights is None else weights,
                             dtype=torch.float32, device=dev)
    slots = (np.arange(local_steps) % agg.n_slots if agg.rule.slotted
             else None)
    wired = steps.configure_agg(agg, mesh, local_steps,
                                params=transformer.init_params(0, cfg,
                                                               "meta"))
    with ca.trace(state, batch, w, fake=mode) as ops:
        if w is not None:
            ops.watch(w, "weights")
        stepped, _ = step(state, batch, gen, slots, w)
    return TrainTrace(ops, wired, ca.state_bytes(state), state, stepped)


def _serve_trace(cfg, mesh, shape):
    """One process's prefill or decode step of `shape` on fake tensors."""
    m, t = num_clients(mesh), model_size(mesh)
    coll = ca.CensusCollective(m, t, world=m * t, rank=0)
    b = shape.global_batch
    dev = ca.census_device()
    mode = ca.fake_mode()
    shared = sharding.batch_shared(b, m)
    clients = range(m)[coll.local("rank", num_pods(mesh))]
    rows = (b // m) * (clients.stop - clients.start) if shared else b
    with mode:
        whole = transformer.init_params(0, cfg, "meta")
        axes = sharding.split_axes(whole, t)
        params = sharding.take_model_shards(
            transformer.init_params(0, cfg, dev), axes,
            coll.local_shards(t), t)
        if shape.kind == "prefill":
            step = steps.make_prefill_step(cfg, mesh, cache_len=shape.seq_len,
                                           collective=coll, batch=b)
            inputs = (params, input_specs(cfg, shape, device=dev,
                                          batch=rows)["batch"])
        else:
            step = steps.make_serve_step(cfg, mesh, cache_len=shape.seq_len,
                                         collective=coll, batch=b)
            ms = steps.serve_shards(cfg, mesh, shape.seq_len, coll,
                                    None if shared else b)
            specs = input_specs(cfg, shape, device=dev, batch=rows,
                                shards=ms)
            inputs = (params, specs["cache"], specs["tokens"],
                      shape.seq_len - 1)
    with ca.trace(*inputs, fake=mode) as ops:
        step(*inputs)
    return ops, coll, ca.state_bytes(inputs[:-1] if shape.kind == "decode"
                                     else inputs)


def trace_pair(arch: str, shape_name: str, *, multi_pod: bool,
               agg_method: str = "diana", agg_wire: str = "shared",
               wire_dtype: str = "packed8", fraction: float = 0.02,
               remat="full", ce: str = "gather", seq_shard: bool = True,
               local_steps: int = 1, clients: int | None = None,
               buffer_k: int | None = None, chaos_dropout: float = 0.0,
               data_store: str | None = None, extra_tags: dict | None = None,
               cfg=None, mesh=None) -> dict:
    """Trace one (arch, shape, mesh); returns its record (the reference's
    `lower_pair`). `cfg` replaces the named configuration (a cut one),
    `mesh` the production mesh (a smaller one)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = INPUT_SHAPES[shape_name]
    label = "multi" if multi_pod else "single"
    ok, reason = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": label,
                "status": "skipped", "reason": reason}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    m, t = num_clients(mesh), model_size(mesh)
    elastic = buffer_k is not None or chaos_dropout > 0
    remat = False if remat in ("none", None, False) else remat
    t0 = time.perf_counter()
    result = {"arch": arch, "shape": shape_name, "mesh": label,
              "status": "ok", "n_devices": m * t, "clients": m,
              "agg": {"method": agg_method, "wire": agg_wire,
                      "fraction": fraction, "wire_dtype": wire_dtype},
              "remat": str(remat), "ce": ce, "seq_shard": seq_shard,
              "local_steps": local_steps, "elastic": elastic,
              "device": ca.census_device()}
    if shape.kind == "train":
        args_ns = _train_args(arch, shape, multi_pod=multi_pod,
                              agg_method=agg_method, agg_wire=agg_wire,
                              wire_dtype=wire_dtype, fraction=fraction,
                              local_steps=local_steps, clients=clients)
        coll = ca.CensusCollective(m, t, world=m * t, rank=0)
        agg = train._aggregation(args_ns, m, N_SLOTS, coll)
        rows = (max(1, shape.global_batch // m)
                * coll.layout(num_pods(mesh)).local)
        ops, wired, held = trace_train(
            cfg, mesh, agg, rows=rows, seq=shape.seq_len, remat=remat, ce=ce,
            seq_shard=seq_shard, local_steps=local_steps,
            elastic=elastic)[:3]
        terms = train.reckon(cfg, mesh, args_ns)
        result["reckon"] = {**terms, "total": sum(terms.values())}
        result["wire_bytes_per_round"] = wired.wire_bytes_per_round(
            transformer.init_params(0, cfg, "meta"))
        if local_steps > 1:
            result["nastya_orders"] = "identity"
    else:
        ops, coll, held = _serve_trace(cfg, mesh, shape)
    result["trace_s"] = round(time.perf_counter() - t0, 1)
    if cfg.experts_per_token:
        result["moe_routing"] = "balanced"
    summary = ops.summary()
    result["memory"] = {**summary["memory"], "state_bytes": held}
    result["ops"] = {k: summary[k] for k in ("flops", "f32_flops",
                                             "op_bytes", "ops",
                                             "top_flops")}
    result["kernels"] = ops.kern.summary()
    result["collectives_by_level"], result["top_collectives"] = (
        _collectives(coll.records))
    result["roofline"] = ca.roofline(ops, coll.records, m * t).as_dict()
    result["fits"] = summary["memory"]["peak_bytes"] <= train.H100_BYTES
    result["model_params"] = cfg.param_count()
    result["active_params"] = cfg.active_param_count()
    if clients is not None and shape.kind == "train":
        result["fleet"] = fleet_smoke(
            cfg, mesh, train._aggregation(args_ns, m, N_SLOTS,
                                          distributed.StackedCollective()),
            clients,
            local_steps=local_steps, buffer_k=buffer_k,
            chaos_dropout=chaos_dropout, data_store=data_store)
    if extra_tags:
        result.update(extra_tags)
    return result


def fleet_smoke(cfg, mesh, agg, clients: int, *, local_steps: int = 1,
                buffer_k: int | None = None, chaos_dropout: float = 0.0,
                chaos_seed: int = 0, data_store: str | None = None) -> dict:
    """Fleet sizing at population scale C, with no population-sized
    allocation (the reference's `fleet_smoke`): the cohort walk draws
    valid mesh-rank-sized cohorts, the host store's bytes are the
    closed-form `ClientStateStore.estimate_nbytes`, and every device
    shift table is keyed on the mesh's client count, never the
    population. With `buffer_k`/`chaos_dropout` the buffered-async
    planner is probed for 16 rounds; with `data_store` a sparse paged
    data store under that directory is walked for 8 rounds across a
    fleet-epoch boundary, its resident bytes held under the lookahead
    window's bound. `agg` is unbound, its collective one process's (the
    whole mesh's tables, sized on the meta device)."""
    from repro_torch.fleet import (
        AsyncPlanner,
        ChaosConfig,
        ClientStateStore,
        CohortSampler,
    )

    m = num_clients(mesh)
    agg_c = steps.configure_agg(agg, mesh, local_steps)
    state = steps.init_train_state(0, cfg, agg, m, mesh=mesh,
                                   local_steps=local_steps, device="meta")
    cohorts = CohortSampler(clients, m, seed=0)
    for r in (0, 1, clients // m):  # a round past a fleet epoch's end too
        c = cohorts.cohort_for_round(r)
        if not (c.shape == (m,) and 0 <= c[0] and c[-1] < clients
                and (np.diff(c) > 0).all()):
            raise AssertionError(f"round {r}'s cohort {c} is not {m} sorted "
                                 f"distinct clients of {clients}")
    shift_leaves = tree_leaves(state.shifts) if state.shifts is not None \
        else []
    for leaf in shift_leaves:
        if leaf.shape[0] != m:
            raise AssertionError(
                f"device shift table leading dim {tuple(leaf.shape)} != "
                f"cohort size {m}: per-client state must stay O(cohort)")
    device_shift_bytes = sum(x.numel() * x.element_size()
                             for x in shift_leaves)
    store_bytes = ClientStateStore.estimate_nbytes(
        state.params, clients, agg_c.rule, n_slots=agg_c.n_slots,
        dtype=agg_c.shift_dtype)
    out = {"population": clients, "cohort": m, "cohort_mode": "rr",
           "rounds_per_fleet_epoch": clients / m,
           "device_shift_bytes": device_shift_bytes,
           "store_bytes": store_bytes}
    if buffer_k is not None or chaos_dropout > 0:
        planner = AsyncPlanner(
            m, buffer_k=buffer_k,
            chaos=ChaosConfig(dropout=chaos_dropout, seed=chaos_seed))
        probed = [planner(r, cohorts.cohort_for_round(r)) for r in range(16)]
        done = [int(p.completes.sum()) for p in probed]
        out["async"] = {"buffer_k": planner.buffer_k,
                        "chaos_dropout": chaos_dropout,
                        "rounds_probed": len(probed),
                        "mean_completers": float(np.mean(done)),
                        "min_completers": int(min(done))}
    if data_store is not None:
        from repro_torch.data.paging import ClientDataStore, LookaheadPager
        from repro_torch.data.pipeline import CohortStream
        from repro_torch.data.reshuffle import ReshuffleSampler

        n_probe, b_probe = 2, 1
        dstore = ClientDataStore.create(
            data_store, clients,
            {"tokens": torch.empty((n_probe, b_probe, 64), dtype=torch.int32,
                                   device="meta")},
            shard_size=512)
        pager = LookaheadPager(dstore, lookahead=1)
        start = max(0, clients // m - 3)
        stream = CohortStream(None, ReshuffleSampler(clients, n_probe,
                                                     seed=1),
                              cohorts, paged=pager, start_round=start)
        with stream:
            for _ in range(8):
                fr = next(stream)
                if fr.batch["tokens"].shape[0] != m * b_probe:
                    raise AssertionError("a paged round's batch is not the "
                                         "cohort's rows")
        bound = pager.resident_bound_nbytes(m)
        if pager.resident_nbytes() > bound:
            raise AssertionError(
                f"paged resident set {pager.resident_nbytes()} B exceeds the "
                f"lookahead window bound {bound} B")
        stats = pager.stats()
        out["paging"] = {"path": data_store,
                         "num_shards": dstore.num_shards,
                         "store_nbytes": dstore.nbytes,
                         "resident_nbytes": pager.resident_nbytes(),
                         "resident_bound_nbytes": bound,
                         **{k: stats[k] for k in ("hits", "misses",
                                                  "evictions")}}
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) combination")
    ap.add_argument("--agg", "--method", default="diana",
                    choices=("dense", "q", "diana", "diana_rr", "ef"))
    ap.add_argument("--wire", default="shared",
                    choices=("shared", "independent"))
    ap.add_argument("--wire-dtype", default="packed8",
                    choices=("f32", "bf16", "packed8", "packed4"),
                    help="transport of the shared wire's slabs: by default "
                         "packed8, the wire the card's train path runs, whose "
                         "records hold all six wire kernels (the "
                         "reference's default is f32)")
    ap.add_argument("--fraction", type=float, default=0.02)
    ap.add_argument("--remat", default="full", choices=("full", "none"),
                    help="the port's remat policies (the reference's 'dots' "
                         "has no counterpart)")
    ap.add_argument("--ce", default="gather", choices=("streaming", "gather"))
    ap.add_argument("--seq-shard", dest="seq_shard", action="store_true",
                    default=True)
    ap.add_argument("--no-seq-shard", dest="seq_shard", action="store_false")
    ap.add_argument("--local-steps", type=int, default=1,
                    help="NASTYA local mini-epochs per round")
    ap.add_argument("--clients", type=int, default=None,
                    help="fleet population size: record the cohort walk and "
                         "the state store's sizing next to the step (train "
                         "shapes only)")
    ap.add_argument("--buffer-k", type=int, default=None,
                    help="trace the buffered-async ELASTIC step and probe the "
                         "K-of-m plan on the host (with --clients)")
    ap.add_argument("--chaos-dropout", type=float, default=0.0,
                    help="per-round client dropout of the async probe")
    ap.add_argument("--data-store", default=None,
                    help="probe the paged-data path: a sparse per-client "
                         "data store under this directory, walked across a "
                         "fleet-epoch boundary (with --clients)")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--tag", default=None, help="label stored with results")
    ap.add_argument("--telemetry", default=None, metavar="JSONL",
                    help="stream the dry run's spans to this JSONL file")
    ap.add_argument("--trace", default=None, metavar="JSON",
                    help="also export a Chrome/Perfetto trace at exit")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("name --arch and --shape, or pass --all")
    tpath = train.telemetry_path(args)
    if tpath is not None:
        telemetry.install(telemetry.MetricsSink(tpath))
        telemetry.run_meta({"tool": "dryrun", "agg": args.agg,
                            "wire_dtype": args.wire_dtype,
                            "clients": args.clients,
                            "data_store": bool(args.data_store)})
    pairs = ([(a, s) for a in ARCH_NAMES for s in INPUT_SHAPES] if args.all
             else [(args.arch, args.shape)])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    try:
        for arch, shape in pairs:
            for multi in meshes:
                try:
                    with telemetry.span("dryrun", arch=arch, shape=shape):
                        res = trace_pair(
                            arch, shape, multi_pod=multi, agg_method=args.agg,
                            agg_wire=args.wire, wire_dtype=args.wire_dtype,
                            fraction=args.fraction, remat=args.remat,
                            ce=args.ce, seq_shard=args.seq_shard,
                            local_steps=args.local_steps,
                            clients=args.clients, buffer_k=args.buffer_k,
                            chaos_dropout=args.chaos_dropout,
                            data_store=args.data_store,
                            extra_tags={"tag": args.tag} if args.tag
                            else None)
                except Exception as e:  # a failed trace is a fault
                    failures += 1
                    res = {"arch": arch, "shape": shape,
                           "mesh": "multi" if multi else "single",
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                line = json.dumps(res)
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    finally:
        sink = telemetry.active()
        if sink is not None:
            telemetry.uninstall()
            sink.close()
            if args.trace:
                n = telemetry.write_trace(telemetry.read_events(tpath),
                                          args.trace)
                print(f"trace -> {args.trace} ({n} trace events)",
                      file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
