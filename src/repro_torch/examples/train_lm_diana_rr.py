"""End-to-end driver: train an LM with the production DIANA-RR
compressed-gradient wire on the reference's (data=4, model=2) mesh: per-client
gradients, Rand-block compression, the sparse all-gather, the DIANA shift
update and SGD, on the random-reshuffling data pipeline, the loss falling
on a learnable synthetic token stream (port of
`examples/train_lm_diana_rr.py`).

    PYTHONPATH=src python -m repro_torch.examples.train_lm_diana_rr \\
        --preset tiny --steps 60
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.examples.train_lm_diana_rr --dist-backend nccl
    PYTHONPATH=src python -m repro_torch.examples.train_lm_diana_rr \\
        --device cpu --steps 3 --seq 16

Alone, one process runs the 4 client ranks stacked; under torchrun with
`--dist-backend` the mesh's 8 cells spread over the processes
(`launch.distributed`; at 8 processes one (client, model shard) each),
with the same bits. The model axis is the reference's 2-way tensor
parallelism: each split leaf is compressed shard by shard, and a process
that holds one shard computes its layers on it (`models.tp`).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import salts
from repro_torch.core.api import tree_leaves
from repro_torch.core.dist import CompressedAggregation
from repro_torch.data.pipeline import (
    DevicePut,
    make_batch_stream,
    shared_slots_for_step,
)
from repro_torch.data.reshuffle import ReshuffleSampler
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.device import resolve_device
from repro_torch.launch import distributed, steps
from repro_torch.launch.mesh import make_mesh, model_size, num_clients
from repro_torch.launch.sharding import local_clients
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig

PRESETS = {
    # ~10M: CI-speed sanity run
    "tiny": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=4,
                 d_ff=1024, vocab=2048),
    # ~100M-class model (the deliverable's end-to-end scale)
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
                 d_ff=3072, vocab=8192),
}


def main(argv=None) -> tuple[float, float]:
    """Trains and returns (first, last) logged loss."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)  # global; 2 per client
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--fraction", type=float, default=0.05)
    ap.add_argument("--agg", choices=("diana_rr", "diana", "q", "dense"),
                    default="diana_rr",
                    help="diana_rr is the paper's Algorithm 3 on the wire: "
                         "per-slot shift tables + the shared (rr_shared) "
                         "reshuffling order")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", choices=distributed.BACKENDS,
                    default=None,
                    help="spread the client ranks over torchrun's processes "
                         "on this backend")
    args = ap.parse_args(argv)

    if args.dist_backend is None:
        dev = resolve_device(args.device)
        collective = distributed.StackedCollective()
    else:
        dev = distributed.process_device(
            args.device, distributed.init_process_group(args.dist_backend))
    try:
        mesh = make_mesh((4, 2), ("data", "model"))
        m = num_clients(mesh)
        if args.dist_backend is not None:
            collective = distributed.ProcessGroupCollective(
                m, model_size(mesh))
        return _train(args, dev, mesh, m, collective)
    finally:
        distributed.destroy_process_group()


def _train(args, dev, mesh, m, collective):
    cfg = ArchConfig(name=f"lm-{args.preset}", family="dense",
                     norm="rmsnorm", act="swiglu", **PRESETS[args.preset])
    n_batches = 8
    slotted = args.agg == "diana_rr"
    agg = CompressedAggregation(method=args.agg, wire="shared",
                                fraction=args.fraction,
                                n_slots=n_batches if slotted else 1,
                                shift_dtype=torch.float32,
                                collective=collective)
    step = steps.make_train_step(cfg, mesh, agg=agg, lr=args.lr, remat=False)
    state = steps.init_train_state(0, cfg, agg, m, mesh=mesh, device=dev)
    lead = collective.rank == 0
    if lead:
        n_params = sum(x.numel() for x in tree_leaves(
            transformer.init_params(0, cfg, "meta")))
        print(f"model: {n_params/1e6:.1f}M params | clients={m} | "
              f"agg={args.agg} (k/d={args.fraction}) | mesh=(data=4, "
              f"model=2) | processes={collective.world}")

    # random-reshuffling data pipeline; DIANA-RR uses the SHARED per-epoch
    # order so every client sits on the same shift-table slot each round
    data = synthetic_token_batches(
        vocab=cfg.vocab, seq_len=args.seq, batch=args.batch // m,
        num_batches=n_batches, num_clients=m, seed=0)
    sampler = ReshuffleSampler(m, n_batches,
                               mode="rr_shared" if slotted else "rr", seed=1)
    stream = make_batch_stream(
        {"tokens": data}, sampler, put=DevicePut(dev),
        clients=local_clients(steps.configure_agg(agg, mesh)))
    first = last = None
    t0 = time.time()
    with stream:
        for t, batch in zip(range(args.steps), stream):
            slots = (shared_slots_for_step(sampler, t, n_slots=agg.n_slots)
                     if slotted else None)
            state, metrics = step(
                state, batch,
                salts.step_generator(1, salts.ROUNDS_KEY_SALT, t, dev), slots)
            if lead and (t % args.log_every == 0 or t == args.steps - 1):
                loss = float(metrics["loss"])
                first = first if first is not None else loss
                last = loss
                print(f"step {t:4d} | loss {loss:7.4f} | "
                      f"gnorm {float(metrics['grad_norm']):8.3f} | "
                      f"{(time.time()-t0)/(t+1):5.2f}s/step", flush=True)
    if lead:
        verdict = ("DECREASED" if last < first - 0.05
                   else "no significant change")
        print(f"loss: {first:.4f} -> {last:.4f} ({verdict})")
    return first, last


if __name__ == "__main__":
    main()
