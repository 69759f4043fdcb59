"""Client ranks spread over processes (the counterpart of the reference's
device placement, `repro.launch.mesh`:8-37 and `launch/compat.py`:18-36).

The reference places each client rank of its mesh on a device of its own
and runs the wire inside a `shard_map`: the level means are `lax.pmean`
and the packed transports `all_gather` the byte lattice and its scales.
Here W processes each hold R_local = R / W of the R client ranks, stacked
on a leading dimension as one process stacks all R (or, where W exceeds
R, a share of one client's model shards), and the wire's messages cross
a `torch.distributed` process group.

The one primitive is `gather(x_local, level, pods)`: this level's message
of every process of the level's group, in the stacked layout, in rank
order. The wire then reduces the gathered stack with the code that runs on
one process (`level_mean`, `bf16_level_mean`, `unpack_reduce`), so every
process reduces the same bits and a run at any W equals the stacked run
bit for bit. Levels:

``inner``
    the ranks of one pod (the intra-pod wire): the processes that hold
    the pod's ranks;
``outer``
    the pods (the inter-pod wire): every pod's message. A pod spread over
    several processes is held whole by each of them, so the processes at
    the same position in their pods gather among themselves;
``world``
    every rank: the losses, the norms' per-rank partial sums, the dense
    method's mean, a checkpoint's per-rank tables;
``model``
    the processes that hold the shards of one client (the mesh's "model"
    axis spread over processes): the layers' activations (each reduction
    over the shards gathers the shards' partials, `models.tp`), the
    leaves a layer puts together (case b and c attention, rwkv6's `mu`,
    hymba's split projections and norms); the norms' per-shard partial
    sums, a checkpoint's shards; serving's activations a token (q, k and
    v, the split softmax's statistics and products, the row-parallel
    partials), never its cache;
``fleet``
    the processes of one model index, as "world": the fleet's per-client
    shift rows (their model shards' slices), each moved once, process to
    process (`exchange`), between the process that owns the client's rows
    (`fleet.store.FleetPlacement`) and the one that serves the client's
    rank in the round, for the gather before the step and the scatter
    after it;
``joint``
    every process of the mesh, in rank order: serving's exchanges over a
    cache leaf split over the client ranks and the model shards jointly
    (a batch the clients cannot share, `launch.sharding.cache_specs`):
    the split softmax's statistics and products, rwkv6's states' and
    x_prev's parts, hymba's SSD outputs. Its parts are numbered client
    rank x T + shard, the order of the reference's `P((*client_axes,
    "model"))`, and a process holds those of its clients and shards
    (`RankLayout.joint_parts`).

`RankLayout` fixes which cells of the mesh (client rank x model shard) a
process holds: contiguous in the mesh's row-major order, as the
reference's devices are, so ranks are pod-major and a process holds an
equal share of one pod or whole pods, never a part of two. The model axis
spreads only where the processes outnumber the client ranks; then the
client levels gather among the processes of one model index, each holding
its shards of every split leaf (`launch.sharding`). Every family's layers
compute on those shards and exchange activations over "model"
(`models.tp`). Serving lays the cells out the same way: a process holds
its clients' rows of the requests, its shards of the parameters and its
slice of the cache (`launch.steps.make_serve_step`).

Backends are named by the caller and never swapped: ``nccl`` on the card,
one process a card (NCCL refuses two ranks of one communicator on one
GPU), and ``gloo`` on the host or where several processes share one card.
Gloo is a host transport: it takes the CUDA tensors of every dtype the
wire moves (f32, bf16, uint8, int64) and stages them through host memory
itself.
"""
from __future__ import annotations

import collections
import dataclasses
import os

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
LEVELS = ("inner", "outer", "world", "model", "joint", "fleet")
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """Which cells of a mesh of R = pods * clients client ranks times
    `model` shards process `rank` of `world` holds: cells / world of them,
    contiguous in the mesh's row-major order (the reference's device
    order), so a process holds whole clients (every shard of each), or,
    when the processes outnumber the client ranks, a share of one client's
    shards. The model axis spreads only then: `model_procs` processes hold
    the shards of one client, each `model / model_procs` of them."""

    world: int
    rank: int
    ranks: int
    pods: int
    model: int = 1

    def __post_init__(self):
        if self.pods < 1 or self.ranks % self.pods:
            raise ValueError(f"{self.ranks} client ranks do not form "
                             f"{self.pods} equal pods")
        cells = self.ranks * self.model
        if cells % self.world:
            what = (f"{self.ranks} client ranks" if self.model == 1 else
                    f"{cells} mesh cells ({self.ranks} client ranks x "
                    f"{self.model} model shards)")
            raise ValueError(f"{what} do not split over {self.world} "
                             "processes")
        per = cells // self.world
        if (per % self.model if per >= self.model else self.model % per):
            raise ValueError(
                f"{per} mesh cells a process would straddle clients of "
                f"{self.model} model shards: a process holds whole clients "
                "or an equal share of one client's shards")
        if self.clients % self.local and self.local % self.clients:
            raise ValueError(
                f"{self.local} ranks a process would straddle pods of "
                f"{self.clients} clients: a process holds an equal share of "
                "one pod or whole pods")

    @property
    def clients(self) -> int:
        """Client ranks per pod."""
        return self.ranks // self.pods

    @property
    def model_procs(self) -> int:
        """Processes that share each client's model shards."""
        return max(1, self.world // self.ranks)

    @property
    def client_world(self) -> int:
        """Processes of one model index: the client ranks spread over
        these."""
        return self.world // self.model_procs

    @property
    def _client_rank(self) -> int:
        return self.rank // self.model_procs

    @property
    def local(self) -> int:
        """Client ranks per process."""
        return self.ranks // self.client_world

    @property
    def local_shards(self) -> slice:
        """The model shards this process holds of its clients."""
        n = self.model // self.model_procs
        j = self.rank % self.model_procs
        return slice(j * n, (j + 1) * n)

    @property
    def _procs_per_pod(self) -> int:
        return max(1, self.clients // self.local)

    @property
    def local_ranks(self) -> slice:
        r = self._client_rank
        return slice(r * self.local, (r + 1) * self.local)

    @property
    def local_pods(self) -> slice:
        r = self._client_rank
        if self.local < self.clients:
            p = r // self._procs_per_pod
            return slice(p, p + 1)
        per = self.local // self.clients
        return slice(r * per, (r + 1) * per)

    @property
    def joint_parts(self) -> tuple[int, ...]:
        """The parts of a leaf split over the client ranks and the model
        shards jointly that this process holds, in part order: client
        rank c's shard j is part c * model + j (wherever the process's
        clients and shards fall, so they need not be contiguous)."""
        shards = self.local_shards
        return tuple(c * self.model + j
                     for c in range(self.local_ranks.start,
                                    self.local_ranks.stop)
                     for j in range(shards.start, shards.stop))

    def partition(self, level: str) -> list[tuple[int, ...]]:
        """The processes split into `level`'s groups, each in rank order.
        The client levels group the processes of one model index; "model"
        groups the processes that share a client's shards; "joint" is
        every process."""
        wm = self.model_procs
        if level == "model":
            return [tuple(c * wm + j for j in range(wm))
                    for c in range(self.client_world)]
        if level == "joint":
            return [tuple(range(self.world))]
        ppp, cw = self._procs_per_pod, self.client_world
        if level in ("world", "fleet"):
            groups = [tuple(range(cw))]
        elif level == "inner":
            groups = [tuple(range(k * ppp, (k + 1) * ppp))
                      for k in range(cw // ppp)]
        elif level == "outer":
            if self.local >= self.clients:
                groups = [tuple(range(cw))]
            else:
                groups = [tuple(p * ppp + j for p in range(self.pods))
                          for j in range(ppp)]
        else:
            raise ValueError(f"unknown level {level!r}; options: {LEVELS}")
        return [tuple(c * wm + j for c in g) for j in range(wm)
                for g in groups]


class StackedCollective:
    """W = 1 without a process group: every rank on this process, the
    gather the identity. It counts what each level would send, so a
    stacked run reports the bytes a spread one sends."""

    world, rank, model_procs, host_staged = 1, 0, 1, False

    def __init__(self):
        self.bytes_sent: collections.Counter = collections.Counter()

    # analysis: allow[ignored-argument] the collective interface's; one process
    # holds every row
    def local(self, unit: str, pods: int) -> slice:
        """This process's rows of a "rank" or "pod" table: all of them."""
        return slice(None)

    def local_shards(self, model: int) -> slice:
        """This process's model shards of each client: all of them."""
        return slice(0, model)

    # analysis: allow[ignored-argument] the collective interface's; one process
    # holds every part
    def joint_parts(self, ranks: int, model: int, pods: int) -> tuple:
        """This process's parts of a leaf split jointly: all of them."""
        return tuple(range(ranks * model))

    # analysis: allow[ignored-argument] the collective interface's; one
    # process's parts in order
    def joint_order(self, ranks: int, model: int, pods: int) -> list[int]:
        """The parts a "joint" gather stacks, in its order."""
        return list(range(ranks * model))

    # analysis: allow[ignored-argument] the collective interface's; this layout
    # needs only some of its arguments
    def units(self, unit: str, pods: int, n_local: int) -> int:
        """The rows of a "rank" or "pod" table over every process."""
        return n_local

    # analysis: allow[ignored-argument] the collective interface's; one
    # process's gather is the identity
    def gather(self, x: torch.Tensor, level: str, pods: int, *,
               key: str | None = None, to_first: bool = False
               ) -> torch.Tensor:
        if key is not None:
            self.bytes_sent[key] += x.numel() * x.element_size()
        return x

    def barrier(self) -> None:
        """Nothing to wait for."""


class ProcessGroupCollective:
    """The wire's collectives over the default process group (joined with
    `init_process_group`) for a mesh of `ranks` client ranks of `model`
    shards each. Given `world` and `rank`, the layout of that process
    without a process group: what the trainer's reckoning sizes on the
    meta device (`launch.train.reckon`); it gathers nothing."""

    def __init__(self, ranks: int, model: int = 1, *,
                 world: int | None = None, rank: int | None = None):
        self.planned = world is not None
        if not self.planned and not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "launch.distributed.init_process_group first")
        self.world = int(world) if self.planned else dist.get_world_size()
        self.rank = int(rank) if self.planned else dist.get_rank()
        self.ranks = int(ranks)
        self.model = int(model)
        # the cells split over W
        lay = RankLayout(self.world, self.rank, self.ranks, 1, self.model)
        self.model_procs = lay.model_procs
        # gloo stages every message through host memory: what only the
        # host needs (a checkpoint's leaves) is gathered there
        self.host_staged = (not self.planned
                            and dist.get_backend() == "gloo")
        self.bytes_sent: collections.Counter = collections.Counter()
        self._groups: dict = {}

    def layout(self, pods: int) -> RankLayout:
        return RankLayout(self.world, self.rank, self.ranks, pods, self.model)

    def local(self, unit: str, pods: int) -> slice:
        lay = self.layout(pods)
        return lay.local_ranks if unit == "rank" else lay.local_pods

    def local_shards(self, model: int) -> slice:
        if model != self.model:
            raise ValueError(f"the collective's mesh has {self.model} model "
                             f"shards, the wire {model}")
        return self.layout(1).local_shards

    # analysis: allow[ignored-argument] the collective interface's; this layout
    # needs only some of its arguments
    def units(self, unit: str, pods: int, n_local: int) -> int:
        return self.ranks if unit == "rank" else pods

    def _joint_layout(self, ranks: int, model: int, pods: int, r: int):
        if (ranks, model) != (self.ranks, self.model):
            raise ValueError(f"the collective's mesh has {self.ranks} client "
                             f"ranks of {self.model} shards, the cache's "
                             f"{ranks} of {model}")
        return RankLayout(self.world, r, self.ranks, pods, self.model)

    def joint_parts(self, ranks: int, model: int, pods: int) -> tuple:
        """This process's parts of a leaf split jointly over the mesh's
        client ranks and model shards (`RankLayout.joint_parts`)."""
        return self._joint_layout(ranks, model, pods, self.rank).joint_parts

    def joint_order(self, ranks: int, model: int, pods: int) -> list[int]:
        """The parts a "joint" gather stacks, in its order: each process's
        `RankLayout.joint_parts`, the processes in rank order."""
        return [p for r in range(self.world)
                for p in self._joint_layout(ranks, model, pods,
                                            r).joint_parts]

    def _group(self, level: str, pods: int):
        """(group, members) of this process at `level`. Every process
        creates every group of the level, in the same order, the first
        time any of them is needed (new_group is collective)."""
        key = (level, pods)
        if key not in self._groups:
            mine = None
            for members in self.layout(pods).partition(level):
                g = (dist.group.WORLD if len(members) == self.world
                     else dist.new_group(list(members)))
                if self.rank in members:
                    mine = (g, members)
            self._groups[key] = mine
        return self._groups[key]

    def gather(self, x: torch.Tensor, level: str, pods: int, *,
               key: str | None = None, to_first: bool = False
               ) -> torch.Tensor | None:
        """Every member's `x` stacked along dim 0, in rank order. A group
        of one process still runs its collective (so NCCL at W = 1 runs
        the path it runs at W > 1). With `to_first` only the group's first
        member receives the stack (None elsewhere): what one process
        writes out."""
        if self.planned:
            raise RuntimeError("a planned layout has no process group to "
                               "gather over")
        group, members = self._group(level, pods)
        x = x.contiguous()
        if key is not None:
            self.bytes_sent[key] += x.numel() * x.element_size()
        first = self.rank == members[0]
        out = (x.new_empty((len(members) * x.shape[0], *x.shape[1:]))
               if first or not to_first else None)
        parts = (None if out is None
                 else list(out.view(len(members), *x.shape).unbind(0)))
        if to_first:
            dist.gather(x, parts, dst=members[0], group=group)
        else:
            dist.all_gather(parts, x, group=group)
        return out


    def barrier(self) -> None:
        """Wait until every process of the group gets here."""
        dist.barrier()

    def exchange(self, sends: list, recvs: list, *, key: str | None = None
                 ) -> None:
        """Process-to-process messages: `sends` (peer rank, tensor, tag)
        and `recvs` (peer rank, tensor to fill, tag), posted together and
        waited for; a send is matched by the receive of the same tag on
        its peer. The sent bytes count under `key`. Host tensors cross a
        gloo group as they are; NCCL stages them through the card."""
        if self.planned:
            raise RuntimeError("a planned layout has no process group to "
                               "exchange over")
        stage = (None if self.host_staged
                 else torch.device("cuda", torch.cuda.current_device()))
        ops, back = [], []
        for peer, x, tag in sends:
            x = x.contiguous()
            if key is not None:
                self.bytes_sent[key] += x.numel() * x.element_size()
            if stage is not None:
                x = x.to(stage)
            ops.append(dist.P2POp(dist.isend, x, peer, tag=tag))
        for peer, out, tag in recvs:
            buf = out if stage is None and out.is_contiguous() else \
                torch.empty(out.shape, dtype=out.dtype,
                            device=stage or out.device)
            back.append((out, buf))
            ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for out, buf in back:
            if buf is not out:
                out.copy_(buf)


def torchrun_env() -> dict[str, str] | None:
    """torchrun's variables, or None outside torchrun."""
    if not all(k in os.environ for k in _TORCHRUN_ENV):
        return None
    return {k: os.environ[k] for k in _TORCHRUN_ENV}


def init_process_group(backend: str, *, rank: int | None = None,
                       world_size: int | None = None,
                       init_method: str | None = None) -> int:
    """Join the default process group over `backend` ("nccl" or "gloo");
    returns this process's local rank. Without `init_method` the group
    comes from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT), which must be complete; with it, `rank`
    and `world_size` are required (the local rank is then `rank`)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    if init_method is None:
        env = torchrun_env()
        if env is None:
            missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
            raise RuntimeError(
                f"no process-group environment: {', '.join(missing)} unset "
                "(launch with `python -m torch.distributed.run "
                "--nproc-per-node N ...`, or pass init_method, rank and "
                "world_size)")
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env["LOCAL_RANK"])
        init_method = "env://"
    else:
        if rank is None or world_size is None:
            raise ValueError("init_method needs rank and world_size")
        local_rank = rank
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return local_rank


def process_device(device: str, local_rank: int) -> torch.device:
    """This process's device: `cuda:{local_rank % device_count}` for
    "cuda" (every process on cuda:0 of a one-card machine), else the host.
    A CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA process group member needs a card and "
                           "none is available")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def destroy_process_group() -> None:
    """Leave the default process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
