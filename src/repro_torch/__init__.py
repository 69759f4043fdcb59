"""PyTorch/CUDA port of `repro`: the paper's federated simulator (Q-RR,
DIANA-RR, Q-NASTYA, DIANA-NASTYA and their baselines) on an NVIDIA H100.

The JAX package `repro` stays the reference; this package imports none of
it. Module names follow the reference's so each counterpart is easy to
find. Entry points run on the card unless the caller passes device="cpu".
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
