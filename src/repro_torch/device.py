"""Device resolution for every entry point of the port.

`device=None` means the card. Without CUDA that raises: the CPU runs only
when the caller names it (`device="cpu"`, as the tests do), so a run that
was meant for the card never silently measures the host instead.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` -> "cuda"; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host")
    return dev
