"""Client ranks spread over processes (the counterpart of the reference's
device placement, `repro.launch.mesh`:8-37 and `launch/compat.py`:18-36).

The reference places each client rank of its mesh on a device of its own
and runs the wire inside a `shard_map`: the level means are `lax.pmean`
and the packed transports `all_gather` the byte lattice and its scales.
Here W processes each hold R_local = R / W of the R client ranks, stacked
on a leading dimension as one process stacks all R, and the wire's
messages cross a `torch.distributed` process group.

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
    method's mean, a checkpoint's per-rank tables.

`RankLayout` fixes which ranks a process holds: ranks pod-major and
contiguous per process, and a process holds either an equal share of one
pod or whole pods, never a part of two.

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
LEVELS = ("inner", "outer", "world")
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """Which of the R = pods * clients client ranks process `rank` of
    `world` holds: `local` = R / world ranks, contiguous, pod-major."""

    world: int
    rank: int
    ranks: int
    pods: int

    def __post_init__(self):
        if self.pods < 1 or self.ranks % self.pods:
            raise ValueError(f"{self.ranks} client ranks do not form "
                             f"{self.pods} equal pods")
        if self.ranks % self.world:
            raise ValueError(f"{self.ranks} client ranks do not split over "
                             f"{self.world} processes")
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
    def local(self) -> int:
        """Client ranks per process."""
        return self.ranks // self.world

    @property
    def _procs_per_pod(self) -> int:
        return max(1, self.clients // self.local)

    @property
    def local_ranks(self) -> slice:
        return slice(self.rank * self.local, (self.rank + 1) * self.local)

    @property
    def local_pods(self) -> slice:
        if self.local < self.clients:
            p = self.rank // self._procs_per_pod
            return slice(p, p + 1)
        per = self.local // self.clients
        return slice(self.rank * per, (self.rank + 1) * per)

    def partition(self, level: str) -> list[tuple[int, ...]]:
        """The processes split into `level`'s groups, each in rank order."""
        ppp = self._procs_per_pod
        if level == "world":
            return [tuple(range(self.world))]
        if level == "inner":
            return [tuple(range(k * ppp, (k + 1) * ppp))
                    for k in range(self.world // ppp)]
        if level == "outer":
            if self.local >= self.clients:
                return [tuple(range(self.world))]
            return [tuple(p * ppp + j for p in range(self.pods))
                    for j in range(ppp)]
        raise ValueError(f"unknown level {level!r}; options: {LEVELS}")


class StackedCollective:
    """W = 1 without a process group: every rank on this process, the
    gather the identity. It counts what each level would send, so a
    stacked run reports the bytes a spread one sends."""

    world, rank = 1, 0

    def __init__(self):
        self.bytes_sent: collections.Counter = collections.Counter()

    def local(self, unit: str, pods: int) -> slice:
        """This process's rows of a "rank" or "pod" table: all of them."""
        return slice(None)

    def units(self, unit: str, pods: int, n_local: int) -> int:
        """The rows of a "rank" or "pod" table over every process."""
        return n_local

    def gather(self, x: torch.Tensor, level: str, pods: int, *,
               key: str | None = None) -> torch.Tensor:
        if key is not None:
            self.bytes_sent[key] += x.numel() * x.element_size()
        return x


class ProcessGroupCollective:
    """The wire's collectives over the default process group (joined with
    `init_process_group`) for a mesh of `ranks` client ranks."""

    def __init__(self, ranks: int):
        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "launch.distributed.init_process_group first")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.ranks = int(ranks)
        RankLayout(self.world, self.rank, self.ranks, 1)  # R splits over W
        self.bytes_sent: collections.Counter = collections.Counter()
        self._groups: dict = {}

    def layout(self, pods: int) -> RankLayout:
        return RankLayout(self.world, self.rank, self.ranks, pods)

    def local(self, unit: str, pods: int) -> slice:
        lay = self.layout(pods)
        return lay.local_ranks if unit == "rank" else lay.local_pods

    def units(self, unit: str, pods: int, n_local: int) -> int:
        return self.ranks if unit == "rank" else pods

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
               key: str | None = None) -> torch.Tensor:
        """Every member's `x` stacked along dim 0, in rank order. A group
        of one process still runs its collective (so NCCL at W = 1 runs
        the path it runs at W > 1)."""
        group, members = self._group(level, pods)
        x = x.contiguous()
        if key is not None:
            self.bytes_sent[key] += x.numel() * x.element_size()
        out = x.new_empty((len(members) * x.shape[0], *x.shape[1:]))
        dist.all_gather(list(out.view(len(members), *x.shape).unbind(0)), x,
                        group=group)
        return out


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
