"""Hand-written CUDA kernels for Hopper, one per TPU kernel of the slice.

<name>.py = wrapper (checks, launch, launch count) over `csrc/<name>.cu`;
ref.py = plain PyTorch versions, which the wrappers use for CPU tensors;
_build.py = the nvcc build and ctypes loader.
"""
from repro_torch.kernels import ref
from repro_torch.kernels._build import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "ref", "reset_launches"]
