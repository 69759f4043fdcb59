"""Serving front end: prefill a request batch, then decode token by token
(port of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 8 \\
        -m repro_torch.launch.serve --dist-backend gloo --device cpu --reduced

By default the full configuration runs on the card, with random bf16
weights from `--seed`; without a card that exits non-zero and says why
(there is no fallback to the host). `--device cpu --reduced` runs the
reference's reduced variant of the configuration on the host.

The mesh is the reference's: (4, 2) ("data", "model") by default, 4
client ranks of 2 model shards; `--production-mesh` (16, 16) and
`--multi-pod` (2, 16, 16) with the full configuration. Each client serves
an equal share of the requests where the client ranks divide the batch;
any other batch (fewer requests than clients, as long_500k's one) every
client serves whole, its cache split over the client ranks and the model
shards jointly (the reference's `cache_specs`). Under torchrun
(`--dist-backend nccl|gloo`) the mesh's cells spread over the processes as
the trainer's do (`launch.distributed.RankLayout`): each holds its
clients' rows (or the whole batch), its shards of the parameters and its
slice of the cache as `cache_specs` lays it
(`launch.steps.make_prefill_step`), and exchanges activations with its
model group (and, over a joint leaf, with every process). One process
holds every cell, and
then computes each layer whole: the same function as its shards' partial
sums, in one call a layer instead of one a (client, shard). Before
anything is allocated a process's parameter shards and cache slice are
sized on the meta device; where they do not fit the device the run exits
2 naming the bytes.

The prompt tokens (and the VLM's patch and the encoder-decoder's frame
embeddings, the stubs of their encoders) are drawn from a generator
seeded by `--seed`. Sampling follows the reference: greedy argmax over the
true vocab at temperature 0, else a categorical draw at the temperature
from a generator seeded by `--seed` (over every request's logits, the
client ranks' gathered where they share the batch over processes). Prints
the ms
per decoded token (host clock, synchronised) and request 0's token ids.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.core.api import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.launch import distributed, sharding, steps
from repro_torch.launch.mesh import (
    make_mesh,
    make_production_mesh,
    model_size,
    num_clients,
    num_pods,
)
from repro_torch.models import transformer


def parse_args(argv=None):
    ap = build_parser()
    return ap.parse_args(argv)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="stablelm-1.6b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card exits "
                         "non-zero")
    ap.add_argument("--reduced", action="store_true",
                    help="the configuration's reduced variant (2 layers, "
                         "d_model 128), as the CPU tests run it")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's (16, 16) mesh, full config")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's (2, 16, 16) mesh, full config")
    ap.add_argument("--dist-backend", choices=distributed.BACKENDS,
                    default=None,
                    help="spread the mesh's cells over the processes "
                         "torchrun starts (required under torchrun with "
                         "WORLD_SIZE > 1)")
    return ap


def serve_mesh(args):
    """The reference's serving meshes: (16, 16) or (2, 16, 16), else
    (4, 2)."""
    if args.production_mesh or args.multi_pod:
        return make_production_mesh(multi_pod=args.multi_pod)
    return make_mesh((4, 2), ("data", "model"))


def serve_config(args):
    cfg = get_config(args.arch)
    if args.reduced and not (args.production_mesh or args.multi_pod):
        cfg = reduced(cfg, seq=max(64, 2 * args.prompt_len))
    return cfg


def reckon(cfg, mesh, args, comm) -> dict:
    """One process's bytes, sized on the meta device: its shards of the
    parameters and its slice of the cache (its clients' rows and its
    model shards of each leaf, or, for a batch the clients do not share,
    its joint parts, its shards or the whole leaf, as `cache_specs`
    splits it)."""
    t = model_size(mesh)
    cache_len = args.prompt_len + args.tokens + 8
    whole = transformer.init_params(0, cfg, "meta")
    shards = comm.local_shards(t)
    own = sharding.take_model_shards(whole, sharding.split_axes(whole, t),
                                     shards, t)
    rows = _own_rows(mesh, args.batch, comm)
    ms = steps.serve_shards(cfg, mesh, cache_len, comm,
                            None if _shared(mesh, args.batch)
                            else args.batch)
    cache = transformer.init_cache(whole, cfg, batch=rows.stop - rows.start,
                                   cache_len=cache_len, shards=ms)
    return {"parameters": _nbytes(own), "cache": _nbytes(cache)}


def _shared(mesh, b: int) -> bool:
    return sharding.batch_shared(b, num_clients(mesh))


def _own_rows(mesh, b: int, comm) -> range:
    """The requests a process serves: its clients' rows where the client
    ranks share the batch, else every one."""
    if not _shared(mesh, b):
        return range(b)
    m = num_clients(mesh)
    clients = range(m)[comm.local("rank", num_pods(mesh))]
    rows = b // m
    return range(clients.start * rows, clients.stop * rows)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sample(logits, cfg, temperature: float, gen: torch.Generator):
    """(B, 1, Vp) logits -> (B, 1) int64 ids over the true vocab."""
    lg = logits[:, -1, :cfg.vocab].float()
    if temperature <= 0:
        return torch.argmax(lg, dim=-1, keepdim=True)
    return torch.multinomial(torch.softmax(lg / temperature, dim=-1), 1,
                             generator=gen)


def _params(gen, cfg, dev, mesh, comm):
    """The seeded parameters, this process's shards of them. Over
    processes each draws the whole tree in turn (one whole copy on a
    device at a time) and keeps its shards, so every process's generator
    is where one process's is after the draw."""
    if comm.world == 1:
        return transformer.init_params(gen, cfg, dev)
    t = model_size(mesh)
    shards = comm.local_shards(t)
    axes = sharding.split_axes(transformer.init_params(0, cfg, "meta"), t)
    params = None
    for r in range(comm.world):
        if r == comm.rank:
            params = sharding.take_model_shards(
                transformer.init_params(gen, cfg, dev), axes, shards, t)
            _sync(dev)
            if dev.type == "cuda":  # the whole tree's blocks, for the next
                torch.cuda.empty_cache()
        torch.distributed.barrier()
    return params


def serve(args, dev: torch.device, comm=None,
          mesh=None) -> tuple[float, list[int]]:
    """Runs the request batch on `dev`; returns (ms per decoded token,
    request 0's ids: the prompt's next token and each decoded one).

    Over processes (`comm`'s world > 1) the process computes its cells
    of `mesh` (by default the front end's, `serve_mesh`) by model shard.
    One process (`comm` by default) holds every cell and computes each
    layer whole, unless a `mesh` of model shards is given: then it
    computes by shard, with the bits a spread over processes gives."""
    cfg = serve_config(args)
    comm = comm or distributed.StackedCollective()
    if mesh is None and comm.world > 1:
        mesh = serve_mesh(args)
    by_shard = mesh is not None and model_size(mesh) > 1
    if comm.world > 1 and not by_shard:
        raise ValueError(f"the {dict(mesh.shape)} mesh has one model shard: "
                         "serving over processes spreads the model axis")
    if args.prompt_len < cfg.vision_patches:
        raise ValueError(f"--prompt-len {args.prompt_len} must cover the "
                         f"{cfg.vision_patches} patch positions of {cfg.name}")
    # analysis: allow[rng-unstructured-seed] the front end's --seed draws the
    # prompts and the samples, as the port has drawn them since serving came in
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = _params(gen, cfg, dev, mesh, comm)
    cache_len = args.prompt_len + args.tokens + 8
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=dev)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(
            args.batch, cfg.vision_patches, cfg.d_model, generator=gen,
            device=dev).to(cfg.dtype)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(
            args.batch, cfg.encoder_seq, cfg.d_model, generator=gen,
            device=dev).to(cfg.dtype)
    own, pods = slice(None), 1
    if by_shard:
        rows = _own_rows(mesh, args.batch, comm)
        own, pods = slice(rows.start, rows.stop), num_pods(mesh)
    # the client ranks share the batch over processes: every request's
    # logits are gathered (a whole batch's are every process's already)
    spread = (comm.world > 1 and comm.world // comm.model_procs > 1
              and _shared(mesh, args.batch))
    prefill = steps.make_prefill_step(cfg, mesh, cache_len=cache_len,
                                      collective=comm, batch=args.batch)
    step = steps.make_serve_step(cfg, mesh, cache_len=cache_len,
                                 collective=comm, batch=args.batch)

    def next_token(logits):
        if spread:  # every request's logits, in rank order
            logits = comm.gather(logits, "world", pods)
        return sample(logits, cfg, args.temperature, gen)[own]

    logits, cache = prefill(params, {k: v[own] for k, v in batch.items()})
    tok = next_token(logits)
    out = [tok]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(args.tokens):
        logits, cache = step(params, cache, tok, args.prompt_len + i)
        tok = next_token(logits)
        out.append(tok)
    _sync(dev)
    ms = (time.perf_counter() - t0) / max(args.tokens, 1) * 1e3
    return ms, torch.cat(out, dim=1)[0].tolist()


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    env = distributed.torchrun_env()
    if args.dist_backend is None and env and int(env["WORLD_SIZE"]) > 1:
        ap.error(f"launched as {env['WORLD_SIZE']} processes: name the "
                 "backend with --dist-backend nccl|gloo")
    if args.dist_backend == "nccl" and args.device != "cuda":
        ap.error("--dist-backend nccl runs on the card: the host needs "
                 "--dist-backend gloo")
    if args.batch < 1:
        ap.error(f"--batch {args.batch}: serving takes at least one request")
    mesh = serve_mesh(args)
    try:
        if args.dist_backend is None:
            dev = resolve_device(args.device)
        else:
            local_rank = distributed.init_process_group(args.dist_backend)
            dev = distributed.process_device(args.device, local_rank)
    except RuntimeError as exc:  # no card, or no process group
        print(f"serve: {exc} (on the host: --device cpu)", file=sys.stderr)
        return 1
    try:
        return _main(ap, args, mesh, dev)
    finally:
        if args.dist_backend is not None:
            distributed.destroy_process_group()


def _main(ap, args, mesh, dev) -> int:
    from repro_torch.launch.train import device_memory

    try:
        comm = (distributed.StackedCollective() if args.dist_backend is None
                else distributed.ProcessGroupCollective(num_clients(mesh),
                                                        model_size(mesh)))
    except ValueError as exc:  # the cells do not split over the processes
        ap.error(str(exc))
    cfg = serve_config(args)
    need = reckon(cfg, mesh, args, comm)
    have = device_memory(dev)
    if sum(need.values()) > have:
        ap.error(f"the {mesh.sizes} mesh does not fit: a process's "
                 f"parameter shards take {need['parameters']} bytes and its "
                 f"cache slice {need['cache']}, {sum(need.values())} bytes "
                 f"in all; the {dev.type} device has {have} bytes (spread "
                 "the mesh over more processes, or cut the configuration)")
    ms, ids = serve(args, dev, comm)
    if comm.rank == 0:
        name = args.arch + (" (reduced)" if args.reduced else "")
        layers = "by shard" if comm.world > 1 else "whole, one process"
        print(f"arch={name} device={args.device} batch={args.batch} "
              f"mesh={dict(mesh.shape)} layers={layers} | {ms:.1f} ms/token")
        print("request 0 token ids:", ids)
    return 0


if __name__ == "__main__":
    sys.exit(main())
