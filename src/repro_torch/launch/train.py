"""Production training driver (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --steps 100 --agg diana --fraction 0.02
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \
        --steps 6 --seq 16

By default the full configuration runs on the card, on the reference's
(4, 2) mesh: 4 client ranks of 2 model shards each (`--pods 2|4` splits
the ranks into a (pods, 4 / pods, 2) mesh), with the activations
recomputed in the backward pass (remat "full"); without a card that exits
non-zero and says why (there is no fallback to the host). `--device cpu
--reduced` runs the reference's reduced variant of the configuration on
the host. The wire compresses each leaf that the model axis splits shard
by shard (`launch.sharding`, `core.dist`), as the reference's does.
`--production-mesh` builds the reference's (16, 16) mesh and
`--multi-pod` its (2, 16, 16) mesh, both with the full configuration;
before anything is allocated, the state a process would hold is sized on
the "meta" device, and a run that does not fit the device's memory exits
naming both (on one card, the usual case).

Across processes, the mesh's cells (client rank x model shard, row-major)
spread over torchrun's N processes (`launch.distributed`): N divides the
cells, a process holds an equal share of one pod or whole pods, and where
N exceeds the client ranks the model axis spreads too, a process holding
its shards of every split leaf (every family's layers compute on them
and exchange activations; the run prints how). `--mesh CxT` builds any flat mesh; `--dry-run`
sizes one process of a mesh spread one cell a process on the meta device
and says whether it fits an H100. The wire's messages cross the process
group of the named backend:

    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --dist-backend nccl --steps 100
    python -m torch.distributed.run --nproc-per-node 8 \
        -m repro_torch.launch.train --dist-backend gloo --device cpu \
        --reduced --steps 6 --seq 16

Each process runs on `cuda:{LOCAL_RANK % cards}`. NCCL takes one process
a card; several processes share one card only over gloo. The run's bits
equal the single-process run's at any N, and so does its checkpoint,
which process 0 writes; `--resume` reads a checkpoint of any N at any
other. So does the fleet (`--clients`): every process walks the same
cohorts and plan, feeds and serves its own client ranks, and holds the
shift rows of the clients it owns (`fleet.store.FleetPlacement`; with
`--store-path` in files of its own there, and `--data-store` a directory
every process reads, which process 0 writes where it is empty).

Every piece is the production path: per-client gradients, the paper's
compressed wire, DIANA shifts, the epoch-indexed RR batch stream
(`data.pipeline`, DESIGN.md §3.7) with double-buffered prefetch onto the
card, and cursor-checkpointed resume (`--resume` bit-reproduces the data
stream and, since step t's generator is a pure function of t, the wire's
draws).

`--clients C` (with C > the mesh client count) switches to the FLEET path
(DESIGN.md §3.9): each round samples a cohort of mesh-rank-many clients
from a C-client population (`--cohort-mode rr` walks a fresh population
permutation per fleet epoch — client-level RR; `with_replacement` is the
i.i.d. baseline), DIANA(-RR) shifts live in a host-sharded
`ClientStateStore` and only the cohort's slices touch the card, and
`--checkpoint/--resume` persist the store + fleet cursor so a resumed run
bit-reproduces an uninterrupted one. With C equal to the mesh client count
the fleet path bit-matches this file's full-participation loop.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.checkpoint import load_meta, restore_train_state, save_pytree
from repro_torch.checkpoint.io import (
    restore_fleet_checkpoint,
    save_fleet_checkpoint,
)
from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.core import salts
from repro_torch.core.api import tree_leaves
from repro_torch.core.dist import CompressedAggregation
from repro_torch.data.paging import ClientDataStore, LookaheadPager
from repro_torch.data.pipeline import (
    DevicePut,
    make_batch_stream,
    shared_slots_for_step,
)
from repro_torch.data.reshuffle import ReshuffleSampler
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.device import resolve_device
from repro_torch.fleet import (
    COHORT_MODES,
    LATE_POLICIES,
    AsyncFleetRunner,
    AsyncPlanner,
    ChaosConfig,
    ClientStateStore,
    CohortSampler,
    FleetPlacement,
    FleetRunner,
)
from repro_torch.fleet.store import checkpoint_shard_size
from repro_torch.launch import distributed, sharding, steps
from repro_torch.launch.mesh import (
    make_mesh,
    make_production_mesh,
    model_size,
    num_clients,
)
from repro_torch.launch.sharding import StateShards, local_clients
from repro_torch.models import mixers, tp, transformer

# an H100 80GB's memory as PyTorch reports it (79.18 GiB): what a
# --dry-run process is sized against
H100_BYTES = int(79.18 * 2**30)
N_BATCHES = 8  # each client's batches: the RR epoch, DIANA-RR's slots


def stub_modalities(cfg, m: int, n_batches: int, b: int, *, seed: int = 0):
    """Client-stacked VLM/audio stub leaves, (m, n, b, ...) like the tokens.

    Each (client, batch-slot) holds its own deterministic rows (the
    reference's draws, in the config's dtype), so the stream's RR gather
    keeps modalities row-aligned with the tokens.
    """
    extras = {}
    rng = np.random.default_rng((seed, salts.MODALITY_STUB_SALT))
    if cfg.family == "vlm":
        extras["patches"] = torch.from_numpy(rng.normal(
            size=(m, n_batches, b, cfg.vision_patches, cfg.d_model)
        )).to(cfg.dtype)
    if cfg.is_encdec:
        extras["frames"] = torch.from_numpy(rng.normal(
            size=(m, n_batches, b, cfg.encoder_seq, cfg.d_model)
        )).to(cfg.dtype)
    return extras


def chaos_from_args(args) -> ChaosConfig:
    """The --chaos-* CLI surface -> one deterministic fault config."""
    return ChaosConfig(
        dropout=args.chaos_dropout, straggler=args.chaos_straggler,
        delay=args.chaos_delay, store_fail=args.chaos_store_fail,
        max_retries=args.chaos_retries, backoff=args.chaos_backoff,
        seed=args.chaos_seed)


def fleet_is_async(args) -> bool:
    """Buffered-async mode turns on when any async/chaos knob is set; a
    plain --clients run keeps the synchronous driver and its step."""
    chaos = chaos_from_args(args)
    return (args.buffer_k is not None or args.late == "drop"
            or chaos.dropout > 0 or chaos.straggler > 0
            or chaos.store_fail > 0)


def _fresh_state(args, cfg, agg, m, mesh, device):
    return steps.init_train_state(
        salts.step_generator(0, salts.PARAMS_KEY_SALT, None, device), cfg,
        agg, m, optimizer=args.optimizer, mesh=mesh,
        local_steps=args.local_steps, device=device)


def run_fleet(args, cfg, mesh, agg, m, n_batches, b, step, abstract, device):
    """The fleet (partial-participation) loop: C-client population, cohort
    of m mesh ranks per round, host state store (DESIGN.md §3.9); returns
    the final TrainState.

    Without --data-store the synthetic population DATASET is materialized
    dense on the host. With --data-store PATH the dataset lives on disk as
    per-client rows (`data.paging.ClientDataStore`) and each round's cohort
    pages in through the deterministic lookahead pager — host RSS is
    bounded by the lookahead window, not the population (DESIGN.md §3.11).
    Batches are bit-identical either way.
    """
    C = args.clients
    comm = agg.collective
    lead = comm.rank == 0  # the process that reports
    whole = transformer.init_params(0, cfg, "meta")
    data = {"tokens": synthetic_token_batches(
        vocab=cfg.vocab, seq_len=args.seq, batch=b,
        num_batches=n_batches, num_clients=C, seed=0)}
    data.update(stub_modalities(cfg, C, n_batches, b))
    sampler = ReshuffleSampler(C, n_batches, mode=args.sampling, seed=1)
    cohorts = CohortSampler(C, m, mode=args.cohort_mode, seed=2)
    # spread over processes: this process's shards of the clients it
    # owns; store shards a checkpoint can write
    store = ClientStateStore.create(
        abstract.params, C, agg.rule, n_slots=agg.n_slots,
        dtype=agg.shift_dtype, path=args.store_path,
        shard_size=checkpoint_shard_size(whole, C, agg.rule,
                                         n_slots=agg.n_slots,
                                         dtype=agg.shift_dtype),
        placement=FleetPlacement.of(agg, m))
    est = ClientStateStore.estimate_nbytes(
        whole, C, agg.rule, n_slots=agg.n_slots, dtype=agg.shift_dtype)
    if lead:
        print(f"fleet: population {C}, cohort {m} ({args.cohort_mode}), "
              f"store {est/1e6:.1f}MB "
              + (f"mmap@{args.store_path}" if args.store_path
                 else "host RAM")
              + " / O(cohort) device"
              + (f", over {comm.world} processes" if comm.world > 1
                 else ""))

    pager = None
    if args.data_store:
        spec = os.path.join(args.data_store, "data_store.json")
        if lead and not os.path.exists(spec):
            ClientDataStore.from_stacked(args.data_store, data)
        comm.barrier()  # the others open what process 0 wrote
        dstore = ClientDataStore.open(args.data_store)
        pager = LookaheadPager(dstore, state=store)
        if lead:
            print(f"data store: {dstore.nbytes/1e6:.1f}MB on disk "
                  f"@{args.data_store} ({dstore.num_shards} shards x "
                  f"{dstore.shard_size} clients), resident <= "
                  f"{pager.resident_bound_nbytes(m)/1e6:.1f}MB")
        data = None

    use_async = fleet_is_async(args)
    chaos = chaos_from_args(args)
    async_spec = AsyncPlanner(
        m, buffer_k=args.buffer_k, late=args.late, discount=args.discount,
        chaos=chaos).spec() if use_async else None

    start_round = 0
    if args.resume:
        meta = load_meta(args.resume)
        fm = (meta.get("meta") or {}).get("fleet")
        if fm is None:
            raise SystemExit(f"{args.resume}: no fleet cursor in manifest — "
                             "not a fleet checkpoint?")
        if fm["sampler"] != sampler.spec() or \
                fm["cohort_sampler"] != cohorts.spec() or \
                fm["local_steps"] != args.local_steps:
            raise SystemExit(
                f"{args.resume}: checkpointed fleet walk {fm} does not "
                "match this run's samplers/local_steps — refusing to "
                "resume onto a different cohort walk")
        if fm.get("async") != async_spec:
            raise SystemExit(
                f"{args.resume}: checkpointed async/chaos plan "
                f"{fm.get('async')} does not match this run's "
                f"{async_spec} — the participation schedule is part of "
                "the walk; resume with the same --buffer-k/--late/"
                "--chaos-* flags")
        have_ds = None if pager is None else pager.data.spec()
        if fm.get("data_store") != have_ds:
            raise SystemExit(
                f"{args.resume}: checkpointed data-store layout "
                f"{fm.get('data_store')} does not match this run's "
                f"{have_ds} — resume with the same --data-store layout "
                "(page identities derive from it)")
        start_round = fm["round"]

    shards = (None if args.dist_backend is None
              else StateShards(agg, abstract))
    if args.resume:
        state = restore_fleet_checkpoint(
            args.resume, abstract, store, device=device,
            data_store=None if pager is None else pager.data, shards=shards)
        if lead:
            print(f"resumed {args.resume} at round {start_round} "
                  f"(fleet epoch {fm['fleet_epoch']})")
    else:
        state = _fresh_state(args, cfg, agg, m, mesh, device)
    common = dict(agg=agg, mesh=mesh, data=data, sampler=sampler,
                  cohorts=cohorts, store=store,
                  local_steps=args.local_steps, prefetch=args.prefetch,
                  start_round=start_round, paged=pager, device=device)
    if use_async:
        runner = AsyncFleetRunner(
            step, whole, buffer_k=args.buffer_k, late=args.late,
            discount=args.discount, chaos=chaos, **common)
        if lead:
            print(f"async: buffer K={runner._planner.buffer_k}/{m} "
                  f"late={args.late} chaos={chaos.spec()}")
    else:
        runner = FleetRunner(step, whole, **common)

    # monotonic rate over the stepping window only: start() fires after
    # restore + runner/stream construction, and the checkpoint write
    # below lands after the last report — neither folds into s/round
    reporter = telemetry.ConsoleReporter(
        unit="round", log_every=args.log_every, total=args.steps,
        start=start_round)

    def log(t, _state, metrics):
        if lead:
            reporter.report(t, metrics, cohort=m)

    with runner:
        reporter.start()
        state = runner.run(state, 0, args.steps - start_round, callback=log)
        if args.checkpoint:
            save_fleet_checkpoint(
                args.checkpoint, state, store, step=int(state.step),
                meta={"fleet": runner.checkpoint_meta()},
                data_store=None if pager is None else pager.data,
                shards=shards)
            if lead:
                print(f"fleet checkpoint -> {args.checkpoint} "
                      f"(round {runner.round})")
    return state


def build_parser() -> argparse.ArgumentParser:
    """The CLI surface (separate so tests can assert the module docstring's
    example flags stay parseable — flag/doc drift is a bug)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.1,
                    help="client/local stepsize gamma")
    ap.add_argument("--local-steps", type=int, default=1,
                    help=">1 runs Q-NASTYA/DIANA-NASTYA at pod granularity: "
                         "that many local RR mini-epochs between rounds")
    ap.add_argument("--eta", type=float, default=None,
                    help="server stepsize for --local-steps>1 "
                         "(default gamma*local_steps = FedRR equivalence)")
    ap.add_argument("--agg", "--method",
                    choices=("diana", "q", "dense", "diana_rr", "ef"),
                    default="diana",
                    help="wire aggregation method; 'diana_rr' runs the "
                         "paper's per-slot shifts (Algorithm 3) and needs "
                         "--sampling rr_shared, 'ef' is error feedback")
    ap.add_argument("--wire", choices=("shared", "independent"), default="shared")
    ap.add_argument("--wire-dtype",
                    choices=("f32", "bf16", "packed8", "packed4"),
                    default="f32",
                    help="shared-wire slab transport: 'packed8'/'packed4' "
                         "bit-pack quantized levels with an f32 scale "
                         "sideband (DESIGN.md §3.13); 'bf16' halves the "
                         "mean's lanes")
    # the paper's headline compression ratio (k/d ~= 0.02, Sec. 3) — must
    # stay in sync with the module-docstring example above
    ap.add_argument("--fraction", type=float, default=0.02)
    ap.add_argument("--pods", type=int, default=1,
                    help=">1 splits the 4 client ranks into a (pods, "
                         "4/pods, 2) ('pod','data','model') mesh for the "
                         "two-level wire")
    ap.add_argument("--mesh", default=None, metavar="CxT",
                    help="a flat ('data', 'model') mesh of C client ranks of "
                         "T model shards each, e.g. 2x4, in place of the "
                         "reference trainer's (4, 2)")
    ap.add_argument("--optimizer", choices=("sgd", "momentum", "adamw"),
                    default="sgd")
    ap.add_argument("--sampling", choices=("rr", "rr_once", "rr_shared", "wr"),
                    default="rr")
    ap.add_argument("--clients", type=int, default=None,
                    help="fleet population size C: sample a cohort of "
                         "mesh-rank-many clients per round from C clients "
                         "whose shifts live in a host state store "
                         "(DESIGN.md §3.9); default = full participation")
    ap.add_argument("--cohort-mode", choices=COHORT_MODES, default="rr",
                    help="'rr' = cohort-RR (every client once per fleet "
                         "epoch); 'with_replacement' = i.i.d. baseline")
    ap.add_argument("--buffer-k", type=int, default=None,
                    help="buffered-async trigger: apply the server update "
                         "once K of the cohort's reports arrive "
                         "(DESIGN.md §3.10); default = synchronous rounds")
    ap.add_argument("--late", choices=LATE_POLICIES, default="discount",
                    help="late reports past the K-of-m deadline: "
                         "'discount' folds them in with weight "
                         "discount/(1+staleness); 'drop' discards them and "
                         "rewinds their RR data cursor (exactly-once)")
    ap.add_argument("--discount", type=float, default=0.5,
                    help="staleness-discount numerator for --late discount")
    ap.add_argument("--chaos-dropout", type=float, default=0.0,
                    help="P(a cohort client goes dark for the round) — "
                         "deterministic per (--chaos-seed, round)")
    ap.add_argument("--chaos-straggler", type=float, default=0.0,
                    help="P(an alive client reports after the deadline)")
    ap.add_argument("--chaos-delay", type=float, default=1.0,
                    help="mean extra straggler latency (base-round units)")
    ap.add_argument("--chaos-store-fail", type=float, default=0.0,
                    help="P(a store gather/scatter raises a transient "
                         "error); the driver retries with backoff")
    ap.add_argument("--chaos-retries", type=int, default=3,
                    help="bounded retry budget per store op")
    ap.add_argument("--chaos-backoff", type=float, default=0.0,
                    help="base seconds for exponential retry backoff")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed every fault draw derives from")
    ap.add_argument("--data-store", default=None,
                    help="page the fleet population's DATASETS from disk: "
                         "lay them out as per-client rows in sharded memmap "
                         "files under this directory (built on first run, "
                         "reused if present) and stream each cohort through "
                         "the deterministic lookahead pager (DESIGN.md "
                         "§3.11)")
    ap.add_argument("--store-path", default=None,
                    help="back the fleet client-state store with np.memmap "
                         "shards under this directory; default keeps shards "
                         "in host RAM — large --clients runs want this")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's pod mesh: 16 clients x 16 model "
                         "shards, full configuration; exits before "
                         "allocating where a process's state does not fit "
                         "its device")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's multi-pod mesh: 2 pods x 16 "
                         "clients x 16 model shards, full configuration "
                         "(as --production-mesh)")
    ap.add_argument("--checkpoint", default=None, help="save state here at end")
    ap.add_argument("--resume", default=None,
                    help="checkpoint to restore (state + data-stream cursor; "
                         "the continued run bit-matches an uninterrupted one)")
    ap.add_argument("--no-prefetch", dest="prefetch", action="store_false",
                    help="disable the double-buffered host prefetch")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--telemetry", default=None, metavar="JSONL",
                    help="stream structured run events (round metrics, host "
                         "phase spans, wire/chaos/pager counters) to this "
                         "JSONL file; inspect with `python -m "
                         "repro_torch.telemetry` (DESIGN.md §3.14). Off by "
                         "default and bitwise the same run when on")
    ap.add_argument("--trace", default=None, metavar="JSON",
                    help="also export a Chrome/Perfetto trace_event JSON at "
                         "exit (implies --telemetry to a sibling file when "
                         "not set)")
    ap.add_argument("--device-metrics", action="store_true",
                    help="carry opt-in compression diagnostics in the "
                         "step's metrics (‖ḡ−D‖², shift norms)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card exits "
                         "non-zero")
    ap.add_argument("--dist-backend", choices=distributed.BACKENDS,
                    default=None,
                    help="spread the client ranks over torchrun's processes "
                         "on this backend: nccl (one process a card) or "
                         "gloo (the host, or several processes on one card)")
    ap.add_argument("--dry-run", action="store_true",
                    help="size one process's state and step on the meta "
                         "device, the mesh's cells one a process, against "
                         "an H100 80GB's memory; print the verdict and exit "
                         "(0 where it fits, else 2). Allocates nothing and "
                         "needs no card")
    ap.add_argument("--reduced", action="store_true",
                    help="the configuration's reduced variant (2 layers, "
                         "d_model 128), as the CPU tests run it")
    return ap


def telemetry_path(args) -> str | None:
    """--telemetry wins; --trace alone derives a sibling JSONL path."""
    if args.telemetry:
        return args.telemetry
    if args.trace:
        base = (args.trace[:-5] if args.trace.endswith(".json")
                else args.trace)
        return base + ".telemetry.jsonl"
    return None


def device_memory(device: torch.device) -> int:
    """The bytes of memory the device has: the card's total, or the
    host's physical memory."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _probs(rows: int, heads: int, sq: int, skv: int, causal: bool,
           window: int | None = None) -> int:
    """`chunked_attention`'s saved probabilities (f32 scores and
    probabilities, bf16 probabilities: 10 bytes) of each (q block, kv
    block) pair it computes (the kv blocks in up to 1024 tokens, those
    wholly masked by the causal mask or the window skipped)."""
    kb = min(skv, 1024)
    nk = -(-skv // kb)
    qb = min(kb, sq)
    pairs = 0
    for qi in range(-(-sq // qb)):
        lo, hi = qi * qb, min((qi + 1) * qb, sq) - 1
        j_lo = 0 if window is None else max(0, (lo - window + 1) // kb)
        j_hi = min(nk - 1, hi // kb) if causal else nk - 1
        pairs += max(j_hi, j_lo) - j_lo + 1
    return rows * heads * pairs * qb * kb * 10


def _attention_acts(cfg, rows: int, seq: int, t: int, n: int, src: int = 0,
                    causal: bool = True) -> int:
    """One attention layer's saved tensors on a process computing n of T
    shards: the projections and rotations (q and k twice, v once) and the
    output for the heads it computes (its shards' in cases a and b, the
    kv heads repeated to the q heads in b; every head once in c), over
    `seq` query tokens and, for cross-attention, `src` key tokens; and
    the probabilities (`_probs`; a causal layer under the config's
    window)."""
    e, hd = torch.finfo(cfg.dtype).bits // 8, cfg.head_dim
    h, kh = cfg.num_heads, cfg.num_kv_heads
    case = sharding.attention_case(cfg, t) if t > 1 else "a"
    if case == "c":
        hq, hkv = h, kh
    else:
        hq = n * h // t
        hkv = hq if case == "b" else n * kh // t
    skv = src or seq
    window = cfg.sliding_window if causal else None
    return (rows * e * hd * (3 * hq * seq + 3 * hkv * skv)
            + _probs(rows, hq, seq, skv, causal, window))


def _scan_acts(rows: int, seq: int, heads: int, dk: int, dv: int) -> int:
    """`chunked_linear_attention`'s f32 saved tensors over `heads` heads:
    a chunk's streams, decays and decayed queries and keys (about ten
    tokens x heads x dk), the masked scores and the state at each chunk's
    start."""
    c = min(seq, 64)
    chunks = seq // c
    return 4 * rows * heads * (10 * seq * dk + chunks * (c * c + dk * dv))


def stash_bytes(cfg, rows: int, seq: int, t: int, n: int, *,
                start: int = 0, seq_shard: bool = True) -> int:
    """What a client's forward keeps for its backward under remat "full"
    on a process that computes shards [start, start + n) of T: each
    decoder block's input and the final norm's, (L + 1) x rows x d_model
    in the model's dtype over the sequence rows those shards hold
    (`tp.seq_rows`: ceil(seq / T) a shard, with `seq_shard`), else over
    all `seq`."""
    e = torch.finfo(cfg.dtype).bits // 8
    lo, hi = (tp.seq_rows(seq, t, range(start, start + n)) if seq_shard
              else (0, seq))
    return (cfg.num_layers + 1) * rows * (hi - lo) * cfg.d_model * e


def activation_bytes(cfg, rows: int, seq: int, t: int, n: int,
                     remat, *, start: int = 0) -> int:
    """An estimate of the activations one client's forward and backward
    holds at its peak on a process that computes n of the client's T
    model shards, from shard `start` (`rows` sequences of `seq` tokens;
    the layers by shard, `models.tp`; T = n = 1: the whole layers). With
    remat "full" the stash (`stash_bytes`: every decoder block's input and
    the final norm's, the rows of the sequence the process's shards hold,
    as the train step's default `seq_shard` keeps them) and one block's
    saved tensors; without, every
    block's saved tensors; then the head's: its
    logits (the process's vocab shards) in the model's dtype and in f32,
    and their exponentials. A block's saved tensors: the norms' inputs in
    f32 and their outputs (tokens x d_model each, twice), the mixer's and
    the FFN's up, gate, activation and product (4 x tokens x the
    process's d_ff; a MoE block k copies of each token, and the shared
    expert's). The mixer's: attention (`_attention_acts`); rwkv6's five mixes (replicated), its heads' projections
    and gate, the f32 decay pre-activation (replicated) and the linear
    attention's state (`_scan_acts`) and group norm over its heads;
    hymba's (case c, every head on every shard) attention, SSD streams,
    scan and head norms, and its rows of the fused output; whisper's
    decoder adds the cross-attention over `encoder_seq` frames, and its
    encoder (every block's input over the frames, the output, and at the
    peak the larger of an encoder and a decoder block)."""
    e = torch.finfo(cfg.dtype).bits // 8
    tok, d, hd = rows * seq, cfg.d_model, cfg.head_dim
    h = cfg.num_heads
    norms = tok * d * 2 * (4 + e)
    if cfg.attention_mixer == "rwkv6":
        dn, hn = n * d // t, n * h // t
        mixer = (tok * e * (5 * d + 6 * dn) + tok * 4 * (d + 3 * dn)
                 + _scan_acts(rows, seq, hn, d // h, d // h)
                 + tok * 4 * n * mixers.DECAY_LORA // t)
    elif cfg.attention_mixer == "hymba":
        ns = cfg.ssm_state
        mixer = (_attention_acts(cfg, rows, seq, t, n)
                 + tok * e * h * (hd + 2 * ns) + tok * 4 * h * 2
                 + _scan_acts(rows, seq, h, ns, hd)
                 + tok * h * hd * (16 + e + e * n // t))
    else:
        mixer = _attention_acts(cfg, rows, seq, t, n)
    if cfg.is_encdec:
        frames = rows * cfg.encoder_seq
        mixer += _attention_acts(cfg, rows, seq, t, n, cfg.encoder_seq,
                                 causal=False)
    ffn = 4 * tok * e * (n * cfg.d_ff // t) * max(1, cfg.experts_per_token)
    ffn += 4 * tok * e * (n * cfg.shared_expert_ff // t)
    block = norms + mixer + ffn
    stash = stash_bytes(cfg, rows, seq, t, n, start=start)
    if cfg.is_encdec:  # the encoder's blocks over the frames
        enc_block = (frames * d * 2 * (4 + e)
                     + _attention_acts(cfg, rows, cfg.encoder_seq, t, n,
                                       causal=False)
                     + 4 * frames * e * (n * cfg.d_ff // t))
        enc_stash = (cfg.encoder_layers + 2) * frames * d * e
        acts = (stash + enc_stash + max(block, enc_block) if remat
                else cfg.num_layers * block + cfg.encoder_layers * enc_block)
    else:
        acts = stash + block if remat else cfg.num_layers * block
    vp = cfg.padded_vocab()
    vocab = n * vp // t if vp % t == 0 else vp
    return acts + tok * vocab * (e + 8)


def _remat(args):
    production = args.production_mesh or args.multi_pod
    return False if args.reduced and not production else "full"


def reckon(cfg, mesh, args, collective=None) -> dict:
    """One process's bytes in a step of `args`' run at `cfg` on `mesh`,
    by term, sized on the meta device; `collective` is the run's (by
    default the layout of process 0 with the mesh's cells one a process).
    Its state: "parameters" (its rows and shards of them) and "tables"
    (the rest: the wire's f32 shift tables, the optimizer's, the step).
    Its step: its clients' "gradients" (its shards of each leaf) and one
    client's "activations" (`activation_bytes`). Then the "wire f32
    transients": six f32 copies of its largest parameter leaf for each
    of its clients (the payload, the decompressed canvas,
    diana_shift_update's three outputs and the direction put together; on
    an H100 a process of qwen2.5-32b on (2, 4) held 4.9 of them when the
    sixth did not fit)."""
    m, t = num_clients(mesh), model_size(mesh)
    if collective is None:
        collective = distributed.ProcessGroupCollective(m, t, world=m * t,
                                                        rank=0)
    agg = _aggregation(args, m, N_BATCHES, collective)
    whole = transformer.init_params(0, cfg, "meta")
    wired = steps.configure_agg(agg, mesh, args.local_steps, params=whole)
    state = steps.init_train_state(0, cfg, agg, m, optimizer=args.optimizer,
                                   mesh=mesh, local_steps=args.local_steps,
                                   device="meta")
    clients = len(range(m)[local_clients(wired)])
    own = _nbytes(state.params)
    terms = {"parameters": own, "tables": _nbytes(state) - own}
    shards = wired.local_shards
    terms["gradients"] = clients * own
    terms["activations"] = activation_bytes(
        cfg, max(1, args.batch // m), args.seq, t,
        shards.stop - shards.start, _remat(args), start=shards.start)
    terms["wire f32 transients"] = 6 * 4 * clients * max(
        x.numel() for x in tree_leaves(state.params))
    return terms


def check_fits(ap, mesh, terms: dict, have: int, device: str) -> bool:
    """Whether a process's bytes (`reckon`'s terms: its state, its rows
    and shards, and one step's terms) fit `have` bytes of `device`; where
    they do not, exit before anything is allocated, naming the bytes of
    each term and the largest (the counterpart of the reference's refusal
    of a mesh larger than its devices). `ap` None: print that and return
    the verdict instead of exiting."""
    state = terms["parameters"] + terms["tables"]
    step = {k: v for k, v in terms.items()
            if k not in ("parameters", "tables")}
    total = state + sum(step.values())
    if total <= have:
        return True
    named = ", ".join(f"{k} {v}" for k, v in step.items())
    largest = max({"state": state, **step}.items(), key=lambda kv: kv[1])
    msg = (f"the {mesh.sizes} mesh does not fit: a process's state takes "
           f"{state} bytes and a step {total - state} more ({named}), "
           f"{total} bytes in all; the {device} device has {have} bytes; "
           f"the largest term is the {largest[0]} ({largest[1]} bytes; "
           "spread the mesh over more processes, or cut the configuration)")
    if ap is None:
        print(msg)
        return False
    ap.error(msg)


def main(argv=None, cfg=None):
    """Parse `argv` and train; returns the final TrainState. `cfg`, when
    given, replaces the configuration `--arch`/`--reduced` name (a caller
    that cuts the depth passes it here)."""
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.dry_run:
        raise SystemExit(0 if dry_run(ap, args, cfg) else 2)
    env = distributed.torchrun_env()
    if args.dist_backend is None and env and int(env["WORLD_SIZE"]) > 1:
        ap.error(f"launched as {env['WORLD_SIZE']} processes: name the "
                 "backend with --dist-backend nccl|gloo")
    if args.dist_backend is not None:
        if args.dist_backend == "nccl" and args.device != "cuda":
            ap.error("--dist-backend nccl runs on the card: the host needs "
                     "--dist-backend gloo")
    try:
        if args.dist_backend is None:
            device = resolve_device(args.device)
        else:
            local_rank = distributed.init_process_group(args.dist_backend)
            device = distributed.process_device(args.device, local_rank)
    except RuntimeError as exc:  # no card or no process group
        print(f"train: {exc} (on the host: --device cpu --reduced)",
              file=sys.stderr)
        raise SystemExit(1) from None
    try:
        return _main(ap, args, cfg, device)
    finally:
        if args.dist_backend is not None:
            distributed.destroy_process_group()


def _aggregation(args, m: int, n_batches: int, collective):
    """The run's wire (unbound to the mesh): `args`' method, transport and
    fraction; cohort-sampled fleets rescale the DIANA mean-shift update by
    M/C so the server's resident mean shift tracks the population mean
    h_bar (DESIGN.md §3.10; M == C gives 1.0, the full-participation
    form)."""
    mean_scale = m / args.clients if args.clients is not None else 1.0
    return CompressedAggregation(method=args.agg, wire=args.wire,
                                 fraction=args.fraction,
                                 n_slots=(n_batches if args.agg == "diana_rr"
                                          else 1),
                                 mean_scale=mean_scale,
                                 shift_dtype=torch.float32,
                                 wire_dtype=args.wire_dtype,
                                 collective=collective)


def _config(args, cfg, production: bool):
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced and not production:
            cfg = reduced(cfg, seq=args.seq)
    return cfg


def dry_run(ap, args, cfg=None) -> bool:
    """`--dry-run`: one process's bytes (`reckon`) on the meta device,
    the mesh's cells spread one (client, model shard) a process, against
    an H100's memory; prints them and the verdict."""
    try:
        mesh = train_mesh(args)
    except ValueError as exc:
        ap.error(str(exc))
    cfg = _config(args, cfg, args.production_mesh or args.multi_pod)
    m, t = num_clients(mesh), model_size(mesh)
    terms = reckon(cfg, mesh, args)
    print(f"dry run: {cfg.name} on the {mesh.sizes} mesh, one (client, "
          f"model shard) a process ({m * t} processes), batch {args.batch} "
          f"x seq {args.seq}; {sharding.model_layout(cfg, t)}")
    print("dry run: a process (bytes): "
          + ", ".join(f"{k} {v}" for k, v in terms.items())
          + f"; the device has {H100_BYTES}")
    if _remat(args):
        rows = max(1, args.batch // m)
        lo, hi = tp.seq_rows(args.seq, t, range(1))
        print(f"dry run: of the activations, the remat stash "
              f"{stash_bytes(cfg, rows, args.seq, t, 1)} bytes "
              f"({cfg.num_layers + 1} x {rows} x {hi - lo} of {args.seq} "
              f"rows (seq_shard) x {cfg.d_model}; whole "
              f"{stash_bytes(cfg, rows, args.seq, t, 1, seq_shard=False)})")
    fits = check_fits(None, mesh, terms, H100_BYTES, "planned")
    print(f"dry run: {cfg.name} {'fits' if fits else 'does not fit'}")
    return fits


def train_mesh(args):
    """The run's mesh, the reference trainer's: the production meshes
    (16, 16) or (2, 16, 16), else (4, 2) flat or (pods, 4 / pods, 2); or
    the flat mesh --mesh names."""
    if args.mesh is not None:
        if args.production_mesh or args.multi_pod or args.pods > 1:
            raise ValueError("--mesh names a flat mesh: it takes no --pods, "
                             "--production-mesh or --multi-pod")
        try:
            c, t = (int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            raise ValueError(f"--mesh {args.mesh!r}: expected CxT, e.g. "
                             "2x4") from None
        if c < 1 or t < 1:
            raise ValueError(f"--mesh {args.mesh!r}: sizes must be >= 1")
        return make_mesh((c, t), ("data", "model"))
    if args.production_mesh or args.multi_pod:
        return make_production_mesh(multi_pod=args.multi_pod)
    if args.pods > 1:
        if args.pods not in (2, 4):
            raise ValueError("--pods must be 1, 2 or 4 (the mesh has 4 "
                             "client ranks to split into pods)")
        return make_mesh((args.pods, 4 // args.pods, 2),
                         ("pod", "data", "model"))
    return make_mesh((4, 2), ("data", "model"))


def _main(ap, args, cfg, device):
    """`main` once the device (and the process group) is there."""
    production = args.production_mesh or args.multi_pod
    try:
        mesh = train_mesh(args)
    except ValueError as exc:
        ap.error(str(exc))
    cfg = _config(args, cfg, production)
    m = num_clients(mesh)
    n_batches = N_BATCHES
    slotted = args.agg == "diana_rr"
    if slotted and args.sampling != "rr_shared":
        ap.error("--agg diana_rr needs --sampling rr_shared: the per-slot "
                 "wire reads/writes one shared shift-table row per round, "
                 "so every client must walk its data in the same index "
                 "order (DESIGN.md §3.8)")
    if args.clients is not None:
        if args.clients < m:
            ap.error(f"--clients {args.clients} < mesh client ranks {m}: "
                     "the cohort fills every mesh rank each round")
        if slotted and (args.cohort_mode != "rr" or args.clients % m != 0):
            ap.error("--agg diana_rr on the fleet path needs --cohort-mode "
                     "rr and --clients divisible by the mesh client count "
                     "(shared-slot wire contract, DESIGN.md §3.9)")
        if fleet_is_async(args) and args.local_steps > 1:
            ap.error("--buffer-k/--chaos-* need --local-steps 1: a NASTYA "
                     "epoch has no well-defined RR rewind point for a "
                     "mid-epoch straggler (DESIGN.md §3.10)")
    elif fleet_is_async(args):
        ap.error("--buffer-k/--late drop/--chaos-* are fleet knobs — pass "
                 "--clients C to run partial participation")
    try:
        collective = (distributed.StackedCollective()
                      if args.dist_backend is None
                      else distributed.ProcessGroupCollective(
                          m, model_size(mesh)))
    except ValueError as exc:  # the cells do not split over the processes
        ap.error(str(exc))
    agg = _aggregation(args, m, n_batches, collective)
    whole = transformer.init_params(0, cfg, "meta")  # shapes only
    agg_c = steps.configure_agg(agg, mesh, args.local_steps, params=whole)
    try:
        local_clients(agg_c)
    except ValueError as exc:  # the ranks do not split over the processes
        ap.error(str(exc))
    step = steps.make_train_step(
        cfg, mesh, agg=agg, lr=args.lr, eta=args.eta,
        local_steps=args.local_steps, remat=_remat(args),
        optimizer=args.optimizer, elastic=fleet_is_async(args),
        debug_metrics=args.device_metrics)
    abstract = steps.init_train_state(
        0, cfg, agg, m, optimizer=args.optimizer, mesh=mesh,
        local_steps=args.local_steps, device="meta")
    check_fits(ap, mesh, reckon(cfg, mesh, args, collective),
               device_memory(device), device.type)
    n_params = sum(x.numel() for x in tree_leaves(whole))
    if collective.rank == 0:
        print(f"arch={cfg.name} ({n_params/1e6:.1f}M params) clients={m} "
              f"mesh={dict(mesh.shape)} "
              f"agg={args.agg}/{args.wire}"
              + (f"/{args.wire_dtype}" if args.wire_dtype != "f32" else "")
              + f" k/d={args.fraction} "
              f"local_steps={args.local_steps} opt={args.optimizer}"
              + (f" fleet=C{args.clients}/{args.cohort_mode}"
                 if args.clients is not None else "")
              + f" device={device.type}"
              + (f" processes={collective.world}/{args.dist_backend}"
                 if args.dist_backend is not None else ""))
        print(sharding.model_layout(cfg, model_size(mesh)))

    # only process 0 writes the telemetry and the trace
    tpath = telemetry_path(args) if collective.rank == 0 else None
    if tpath is not None:
        telemetry.install(telemetry.MetricsSink(tpath))
        flags = {k: v for k, v in sorted(vars(args).items())
                 if isinstance(v, (str, int, float, bool, type(None)))}
        wire = agg_c.wire_bytes_per_round(whole)
        telemetry.run_meta({
            "argv": flags, "arch": cfg.name, "n_params": n_params,
            "mesh_clients": m,
            "wire_bytes_per_round": {k: int(v) for k, v in wire.items()}})
    try:
        state = _run(args, cfg, mesh, agg_c, m, n_batches, step, abstract,
                     device)
        # what this process put on each wire level (launch.distributed)
        print("wire: " + json.dumps({
            "rank": collective.rank, "world": collective.world,
            "bytes_sent": dict(collective.bytes_sent)}), flush=True)
        return state
    finally:
        sink = telemetry.active()
        if sink is not None:
            telemetry.uninstall()
            sink.close()
            print(f"telemetry -> {tpath}")
            if args.trace:
                n = telemetry.write_trace(
                    telemetry.read_events(tpath), args.trace)
                print(f"trace -> {args.trace} ({n} trace events)")


def _run(args, cfg, mesh, agg, m, n_batches, step, abstract, device):
    """The full-participation loop (or `run_fleet` under --clients);
    returns the final TrainState. `agg` is bound to the mesh and the
    parameters (`steps.configure_agg`), `abstract` is the process's state
    in shapes (a TrainState of meta tensors), `step` the train step."""
    slotted = args.agg == "diana_rr"
    b = max(1, args.batch // m)
    if args.clients is not None:
        return run_fleet(args, cfg, mesh, agg, m, n_batches, b, step,
                         abstract, device)
    data = {"tokens": synthetic_token_batches(
        vocab=cfg.vocab, seq_len=args.seq, batch=b,
        num_batches=n_batches, num_clients=m, seed=0)}
    sampler = ReshuffleSampler(m, n_batches, mode=args.sampling, seed=1)

    start_step = 0
    if args.resume:
        meta = load_meta(args.resume)
        cursor = (meta.get("meta") or {}).get("data_stream")
        if cursor is None:
            raise SystemExit(f"{args.resume}: no data-stream cursor in "
                             "manifest — not a train.py checkpoint?")
        if cursor["sampler"] != sampler.spec() or \
                cursor["local_steps"] != args.local_steps:
            raise SystemExit(
                f"{args.resume}: checkpointed stream {cursor} does not match "
                "this run's sampler/local_steps — refusing to resume onto a "
                "different data stream")
        start_step = cursor["train_step"]

    shards = (None if args.dist_backend is None
              else StateShards(agg, abstract))
    lead = agg.collective.rank == 0  # the process that reports
    if args.resume:
        state = restore_train_state(args.resume, abstract, device,
                                    shards=shards)
        if lead:
            print(f"resumed {args.resume} at step {start_step} "
                  f"(epoch {cursor['epoch']}, batch {cursor['step']})")
    else:
        state = _fresh_state(args, cfg, agg, m, mesh, device)

    if telemetry.enabled():
        wire = agg.wire_bytes_per_round(
            transformer.init_params(0, cfg, "meta"))
        bits_per_client = 8.0 * (wire["intra_pod"] if agg.client_axes
                                 else wire["inter_pod"])
    reporter = telemetry.ConsoleReporter(
        unit="step", log_every=args.log_every, total=args.steps,
        start=start_step)

    # the NASTYA-aware stream owns RR order, client-major assembly,
    # modality alignment, and prefetch + host-to-device overlap
    stream = make_batch_stream(
        data, sampler, local_steps=args.local_steps,
        extras=stub_modalities(cfg, m, n_batches, b),
        put=DevicePut(device), prefetch=args.prefetch,
        start_step=start_step, clients=local_clients(agg))
    with stream:
        # start the rate clock AFTER restore + stream construction so
        # neither checkpoint-restore nor first-build time folds in
        reporter.start()
        for t, batch in zip(range(start_step, args.steps), stream):
            # step t's generator is a pure function of t, as the
            # reference folds the step into its fixed key: --resume draws
            # what the uninterrupted run drew
            gen = salts.step_generator(0, salts.ROUNDS_KEY_SALT, t, device)
            # the shared slot stream is a pure function of the stateless
            # sampler, so --resume re-derives it exactly
            slots = (shared_slots_for_step(sampler, t, args.local_steps,
                                           n_slots=agg.n_slots)
                     if slotted else None)
            with telemetry.span("device_step", round=t):
                state, metrics = step(state, batch, gen, slots)
            if not lead:  # the other processes copy and print nothing
                continue
            # the loop's one device-to-host copy of the metrics, staged
            # without waiting; the reporter and the sink read this copy
            metrics = telemetry.stage(metrics)
            if telemetry.enabled():
                telemetry.counter("wire.uplink_bits",
                                  m * bits_per_client, round=t)
                telemetry.round_metrics(t, metrics)
            reporter.report(t, metrics)
        if args.checkpoint:
            save_pytree(args.checkpoint, state, step=int(state.step),
                        meta={"data_stream": stream.cursor_meta()},
                        shards=shards)
            if lead:
                print(f"checkpoint -> {args.checkpoint} "
                      f"(cursor {stream.cursor})")
    return state


if __name__ == "__main__":
    main()
