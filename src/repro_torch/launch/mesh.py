"""A virtual client mesh (port of `repro.launch.mesh`'s axis helpers).

The reference's mesh spreads the federated clients over TPU devices: axes
("data", "model") or ("pod", "data", "model"), where the ("pod", "data")
ranks are the clients and "model" is tensor parallelism inside each. One
H100 runs every client rank stacked on a leading dimension, so the mesh
here is only names and sizes: it tells `launch.steps` how many clients
there are and how they group into pods. "model" must be 1: tensor
parallelism would split each rank's wire into per-shard windows and
scales, which a single card does not have (ROADMAP Queue C).
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
        if self.shape["model"] != 1:
            raise ValueError(
                "the port runs every client rank on one card: the 'model' "
                f"axis (tensor parallelism) must be 1, got "
                f"{self.shape['model']}")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"mesh sizes must be positive, got {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_mesh(shape=(4, 1), axes=("data", "model")) -> VirtualMesh:
    """(clients, 1) flat or (pods, clients per pod, 1) two-level."""
    return VirtualMesh(tuple(axes), tuple(int(s) for s in shape))


def client_axes(mesh: VirtualMesh) -> tuple[str, ...]:
    """The axes that enumerate federated clients (everything but TP)."""
    return tuple(n for n in mesh.axis_names if n != "model")


def num_clients(mesh: VirtualMesh) -> int:
    return math.prod(mesh.shape[a] for a in client_axes(mesh))


def pod_axes(mesh: VirtualMesh) -> tuple[str, ...]:
    """The outer (inter-pod) wire axes: present only on two-level meshes."""
    return ("pod",) if "pod" in mesh.axis_names else ()


def data_axes(mesh: VirtualMesh) -> tuple[str, ...]:
    """The inner (intra-pod) client axes: everything but TP and "pod"."""
    return tuple(n for n in mesh.axis_names if n not in ("model", "pod"))


def num_pods(mesh: VirtualMesh) -> int:
    return mesh.shape["pod"] if pod_axes(mesh) else 1
