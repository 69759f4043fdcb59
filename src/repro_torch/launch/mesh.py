"""A virtual client mesh (port of `repro.launch.mesh`'s axis helpers).

The reference's mesh spreads the federated clients over TPU devices: axes
("data", "model") or ("pod", "data", "model"), where the ("pod", "data")
ranks are the clients and "model" is tensor parallelism inside each. Here
the mesh is only names and sizes: it tells `launch.steps` how many clients
there are, how they group into pods, and into how many model shards T each
client's parameters split. Its cells, row-major as the reference's
`np.asarray(devices[:n]).reshape(shape)` orders its devices, are what
processes hold (`launch.distributed.RankLayout`): one process holds them
all, stacked, or W processes each hold a contiguous run of them.

With T > 1 each leaf that the model-axis rules split (`launch.sharding`)
is compressed per shard, as the reference's wire does inside its
`shard_map`. A process that holds a model shard stores only that shard of
the state and its layers compute on it (`models.tp`).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """Axis names and sizes, outermost first (the reference's mesh order)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")
        if self.axis_names not in (("data", "model"),
                                   ("pod", "data", "model")):
            raise ValueError(
                "a mesh has axes ('data', 'model') or ('pod', 'data', "
                f"'model'), got {self.axis_names}")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"mesh sizes must be positive, got {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_mesh(shape=(4, 1), axes=("data", "model")) -> VirtualMesh:
    """(clients, T) flat or (pods, clients per pod, T) two-level."""
    return VirtualMesh(tuple(axes), tuple(int(s) for s in shape))


def make_production_mesh(*, multi_pod: bool = False) -> VirtualMesh:
    """The reference's production meshes: (16, 16) ("data", "model") on one
    pod, (2, 16, 16) ("pod", "data", "model") on two; "model" is 16-way
    tensor parallelism inside each client."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def client_axes(mesh: VirtualMesh) -> tuple[str, ...]:
    """The axes that enumerate federated clients (everything but TP)."""
    return tuple(n for n in mesh.axis_names if n != "model")


def num_clients(mesh: VirtualMesh) -> int:
    return math.prod(mesh.shape[a] for a in client_axes(mesh))


def model_size(mesh: VirtualMesh) -> int:
    """T, the model shards of each client."""
    return mesh.shape["model"]


def pod_axes(mesh: VirtualMesh) -> tuple[str, ...]:
    """The outer (inter-pod) wire axes: present only on two-level meshes."""
    return ("pod",) if "pod" in mesh.axis_names else ()


def data_axes(mesh: VirtualMesh) -> tuple[str, ...]:
    """The inner (intra-pod) client axes: everything but TP and "pod"."""
    return tuple(n for n in mesh.axis_names if n not in ("model", "pod"))


def num_pods(mesh: VirtualMesh) -> int:
    return mesh.shape["pod"] if pod_axes(mesh) else 1
