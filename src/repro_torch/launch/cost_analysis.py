"""Cost analysis of a step run on fake tensors: its FLOPs, bytes, memory,
collectives and kernel launches, and the three-term roofline (the
counterpart of `repro.launch.hlo_analysis`).

The reference compiles its step for 512 faked TPU devices and reads XLA's
`cost_analysis`, `memory_analysis` and the HLO text. The port runs one
process's real step under `torch._subclasses.fake_tensor.FakeTensorMode`
(`fake_mode`) and records what that run would allocate, compute, move and
launch (`trace`):

op census (`OpCensus`)
    a `TorchDispatchMode` that sees every aten op: its FLOPs by
    `torch.utils.flop_counter`'s formulas (FlopCounterMode's registry:
    matmuls, attention, convolutions; element-wise work counts in bytes),
    split by the dtype its tensor cores or CUDA cores run it at; the bytes
    of its tensor inputs and outputs (an upper bound of its HBM traffic,
    like XLA's "bytes accessed"; views and allocations move none); the op
    sequence. The kernel wrappers record their launches themselves
    (`kernels.census`): the card runs one kernel there, so the ops of a
    plain version (the host's) are left out, and the kernel's bytes count
    instead.
memory (`memory_summary`)
    the live bytes of the tensors' storages, each rounded up as the CUDA
    caching allocator rounds a block (512 bytes), from the state handed in
    (`track`) and every storage an op or a kernel allocates, freed when its
    last tensor dies: the peak, and its parts at the peak ("state",
    "kernel outputs", "ops"). torch's `MemTracker` sorts bytes by the
    `nn.Module`s and optimizers it hooks; the port's models and optimizers
    are functions of tensor trees, so the tracker here follows storages
    itself.
collectives (`CensusCollective`, `collective_stats`)
    a `launch.distributed.ProcessGroupCollective` of a planned layout (no
    process group) that records each gather's level, key, operand bytes
    (the live collective's counter's rule: what the process contributes)
    and group, and returns a fake tensor of the gathered stack.

Host reads of device values have no values to read on fake tensors: under
`trace`'s census, MoE routing is balanced (`models.moe.expert_counts`) and
NASTYA's pod orders are the identity (`launch.steps.host_orders`).
Every op the card's path runs still runs.

On a host whose torch has no CUDA (this repository's CPU tests) the fake
tensors lie on the CPU device: autograd on a fake CUDA tensor needs the
CUDA build's device guard. The port's ops branch on the device only in the
kernel wrappers, whose census branch takes a fake tensor on either device
after the card's checks, so the ops are the card's. On a machine with a card the fake tensors lie on "cuda"
(`census_device`).

`Roofline` takes NVIDIA's data-sheet peaks of an H100 SXM5 80GB HBM3 at
700 W: 989.4 TFLOP/s dense bf16 (tensor cores), 66.9 TFLOP/s f32 (CUDA
cores; the port leaves TF32 off), 3.35 TB/s of HBM, 450 GB/s a direction
of NVLink among the 8 cards of a node and 50 GB/s a direction of 400 Gb/s
InfiniBand between nodes. A gather's group decides its link: processes
are numbered as the mesh's cells, row-major, 8 a node, so a group inside
one node's 8 takes NVLink, any other InfiniBand. On the production meshes
one (client, model shard) a process, (16, 16) and (2, 16, 16), every
level crosses nodes: a client's 16 shards ("model") span two nodes, and
the client levels ("inner", "outer", "world") join processes 16 apart.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.api import tree_leaves
from repro_torch.kernels import census
from repro_torch.launch import distributed

# NVIDIA H100 SXM5 80GB HBM3 data sheet, at its 700 W limit
H100_BF16_FLOPS = 989.4e12  # dense bf16, tensor cores
H100_F32_FLOPS = 66.9e12  # f32, CUDA cores (no TF32)
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 450e9  # a direction, among a node's 8 cards
H100_IB_BYTES_PER_S = 50e9  # a direction, 400 Gb/s InfiniBand NDR
H100_NODE_CARDS = 8
# the CUDA caching allocator rounds every block up to this many bytes
BLOCK_BYTES = 512


def fake_mode() -> FakeTensorMode:
    """The dry run's fake mode: tensors with shapes, dtypes and devices,
    and no memory."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def census_device() -> str:
    """The device a fake step's tensors lie on: "cuda" where torch can
    see a card, else "cpu" (see the module docstring)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's arguments or outputs: nested lists, tuples
    and dicts (what aten ops take and return)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rounded(n: int) -> int:
    return -(-n // BLOCK_BYTES) * BLOCK_BYTES


# ops that allocate without writing, or only rename metadata
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "alias"}


class OpCensus(TorchDispatchMode):
    """Records every aten op that runs while it is active (see the module
    docstring). Nest it inside the fake mode, and the kernels' census
    (`kern`) active around it."""

    def __init__(self, kern: census.Census):
        super().__init__()
        self.kern = kern
        kern.on_outputs = lambda outs: self._allocated(outs, "kernel outputs")
        self.sequence: list = []  # each op's OpOverload, in order
        self.flops_by_op: collections.Counter = collections.Counter()
        self.flops = 0
        self.f32_flops = 0
        self.op_bytes = 0
        self.host_reads = 0  # .item() / .tolist() of a device value
        self._live: dict[int, tuple] = {}
        self._by_cat: collections.Counter = collections.Counter()
        self.current = 0
        self.peak = 0
        self.peak_parts: dict = {}
        self._watch: dict[int, str] = {}
        self.read: set[str] = set()
        self.dtypes: set[str] = set()

    # -- memory ------------------------------------------------------------

    def _track(self, t: torch.Tensor, cat: str) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = _rounded(st.nbytes())
        if n == 0:
            return
        ref = weakref.ref(st, lambda _, k=key: self._free(k))
        self._live[key] = (n, cat, ref)
        self._by_cat[cat] += n
        self.current += n
        if self.current > self.peak:
            self.peak = self.current
            self.peak_parts = dict(self._by_cat)

    def _free(self, key: int) -> None:
        n, cat, _ = self._live.pop(key)
        self._by_cat[cat] -= n
        self.current -= n

    def _allocated(self, outs, cat: str) -> None:
        for t in _tensors(outs):
            self._track(t, cat)

    def track(self, *trees, cat: str = "state") -> None:
        """Count the storages of the tensors of `trees` (made before the
        census: the state, the batch) as live."""
        for tree in trees:
            for t in tree_leaves(tree):
                if isinstance(t, torch.Tensor):
                    self._track(t, cat)

    def watch(self, t: torch.Tensor, name: str) -> None:
        """Note in `read` whether an op (other than a view) reads `t`'s
        storage: the elastic weights' check (`analysis.graph`)."""
        self._watch[t.untyped_storage()._cdata] = name

    # -- ops ---------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # inside a kernel the card runs one launch; prim ops are a fake
        # tensor's metadata queries (its device), no op of the card's
        if self.kern.depth or func.namespace == "prim":
            return func(*args, **kwargs)
        # a composite op reaches this mode whole where autograd is off
        # (prefill and decode run under inference_mode): count the ops it
        # is made of, as FlopCounterMode does
        if func.overloadpacket not in flop_registry:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if (ins or outs) and all(t.device.type == "meta" for t in ins + outs):
            return out  # shapes only (a layout sized on "meta"): no work
        name = func.overloadpacket.__name__
        self.sequence.append(func)
        if name == "_local_scalar_dense":
            self.host_reads += 1
        self.dtypes.update(str(t.dtype) for t in outs)
        packet = func.overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[name] += n
            if ins and ins[0].dtype == torch.float32:
                self.f32_flops += n
        if not func.is_view and name not in _NO_TRAFFIC:
            self.op_bytes += (sum(_nbytes(t) for t in ins)
                              + sum(_nbytes(t) for t in outs))
            if self._watch:
                for t in ins:
                    w = self._watch.get(t.untyped_storage()._cdata)
                    if w is not None:
                        self.read.add(w)
        self._allocated(outs, "ops")
        return out

    def summary(self) -> dict:
        """FLOPs, op bytes, memory and op counts as JSON-ready numbers."""
        return {"flops": self.flops, "f32_flops": self.f32_flops,
                "op_bytes": self.op_bytes, "ops": len(self.sequence),
                "host_reads": self.host_reads,
                "top_flops": dict(self.flops_by_op.most_common(8)),
                "memory": memory_summary(self)}


def memory_summary(ops: OpCensus) -> dict:
    """The counterpart of the reference's `memory_analysis` read: the
    traced peak of live bytes (allocator-rounded) and its parts at the
    peak, and what is live at the end."""
    return {"peak_bytes": ops.peak,
            "peak_by_category": {k: v for k, v in ops.peak_parts.items()
                                 if v},
            "end_bytes": ops.current}


@contextlib.contextmanager
def trace(*track, fake=None):
    """Census of the ops and kernel launches of the block: yields an
    `OpCensus` (its `kern` the kernels' records), with the tensors of the
    trees `track` (the state, the batch) counted live from the start.
    Enter `fake` (a `fake_mode()`) or a real device's tensors: on real
    host tensors the same census results, the plain versions recorded as
    the kernels the card would launch. MoE routing is balanced and NASTYA
    orders the identity in the block (see the module docstring)."""
    kern = census.Census()
    ops = OpCensus(kern)
    with contextlib.ExitStack() as stack:
        if fake is not None:
            stack.enter_context(fake)
        stack.enter_context(census.recording(kern))
        ops.track(*track)
        stack.enter_context(ops)
        yield ops


# -- collectives ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GatherRecord:
    level: str
    key: str | None
    nbytes: int  # what this process contributes (the operand)
    members: tuple  # the group's processes, in rank order
    shape: tuple
    dtype: str = ""


class CensusCollective(distributed.ProcessGroupCollective):
    """The layout of process `rank` of `world` over a mesh of `ranks`
    client ranks of `model` shards (`ProcessGroupCollective`'s planned
    layout), with no process group: `gather` returns a fake tensor of the
    gathered stack (at world 1, the stacked process's identity, as
    `StackedCollective`), `exchange` leaves the receives as they are, and
    both record each message (`records`, and `bytes_sent` by key as the
    live collective counts)."""

    def __init__(self, ranks: int, model: int = 1, *, world: int,
                 rank: int = 0):
        super().__init__(ranks, model, world=world, rank=rank)
        self.records: list[GatherRecord] = []

    def members(self, level: str, pods: int) -> tuple:
        for group in self.layout(pods).partition(level):
            if self.rank in group:
                return group
        raise ValueError(f"process {self.rank} is in no {level} group")

    def gather(self, x, level, pods, *, key=None, to_first=False):
        stacked = self.world == 1
        if not stacked:
            x = x.contiguous()
        n = _nbytes(x)
        if key is not None:
            self.bytes_sent[key] += n
        members = self.members(level, pods)
        self.records.append(GatherRecord(level, key, n, members,
                                         tuple(x.shape), str(x.dtype)))
        if stacked:
            return x
        if to_first and self.rank != members[0]:
            return None
        return x.new_empty((len(members) * x.shape[0], *x.shape[1:]))

    # analysis: allow[ignored-argument] the collective interface's; the census
    # leaves the receives as they are
    def exchange(self, sends, recvs, *, key=None):
        for peer, x, _ in sends:
            n = _nbytes(x)
            if key is not None:
                self.bytes_sent[key] += n
            self.records.append(GatherRecord(
                "fleet", key, n, (self.rank, peer), tuple(x.shape),
                str(x.dtype)))

    def barrier(self) -> None:
        """Nothing to wait for."""


@dataclasses.dataclass
class CollectiveStats:
    """The counterpart of the reference's: bytes and counts by kind (here
    the level) and the largest messages."""

    bytes_by_kind: dict
    count_by_kind: dict
    top: list = dataclasses.field(default_factory=list)
    bytes_by_key: dict = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def collective_stats(records, top_n: int = 8) -> CollectiveStats:
    """Sum a census's gather records by level and by key; the `top_n`
    largest as (bytes, level, shape)."""
    by, count, keys = (collections.Counter(), collections.Counter(),
                       collections.Counter())
    for r in records:
        by[r.level] += r.nbytes
        count[r.level] += 1
        if r.key is not None:
            keys[r.key] += r.nbytes
    top = sorted(((r.nbytes, r.level, str(r.shape)) for r in records),
                 reverse=True)[:top_n]
    return CollectiveStats(dict(by), dict(count), top, dict(keys))


def link_rate(members) -> float:
    """The bytes a second of the link a group's gathers cross: NVLink
    inside one node's cards, InfiniBand across nodes."""
    nodes = {m // H100_NODE_CARDS for m in members}
    return (H100_NVLINK_BYTES_PER_S if len(nodes) == 1
            else H100_IB_BYTES_PER_S)


def received_seconds(records) -> float:
    """The gathers' time at their links' rates: each process receives the
    (n - 1) other members' messages of each gather of a group of n (the
    ring's bytes), one message a gather of equal operands; an exchange's
    send is received once."""
    total = 0.0
    for r in records:
        others = max(1, len(r.members) - 1) if r.level != "fleet" else 1
        if len(r.members) > 1:
            total += others * r.nbytes / link_rate(r.members)
    return total


# -- the roofline ---------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    """Three-term per-process roofline (seconds) at the H100's data-sheet
    peaks: `flops` (of which `f32_flops` at the f32 rate, the rest at
    bf16's), `hbm_bytes` at the HBM rate, and the gathers' time at their
    links' rates (`collective_s`, from `received_seconds`);
    `collective_bytes` is what the process contributes."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    n_devices: int
    f32_flops: float = 0.0
    collective_time: float = 0.0

    @property
    def compute_s(self) -> float:
        return ((self.flops - self.f32_flops) / H100_BF16_FLOPS
                + self.f32_flops / H100_F32_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / H100_HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return self.collective_time

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s,
                "dominant": self.dominant}


def roofline(ops: OpCensus, records, n_devices: int) -> Roofline:
    """The roofline of a traced step: its ops' FLOPs, its ops' and
    kernels' bytes, its gathers."""
    kern = sum(r.read + r.written for r in ops.kern.records)
    return Roofline(flops=ops.flops, hbm_bytes=ops.op_bytes + kern,
                    collective_bytes=sum(r.nbytes for r in records),
                    n_devices=n_devices, f32_flops=ops.f32_flops,
                    collective_time=received_seconds(records))


def state_bytes(tree) -> int:
    """The bytes of a tree's tensors (their shapes and dtypes)."""
    return sum(_nbytes(x) for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))
