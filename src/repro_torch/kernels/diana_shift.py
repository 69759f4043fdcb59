"""Fused DIANA shift/direction update (port of `repro.kernels.diana_shift`).

The element-wise update the paper's method adds on top of SGD (Algorithm 3
lines 7-9 / Algorithm 5 lines 8-11):

    direction = H_t + Q_mean
    h'        = h   + alpha * Q_own
    H'        = H_t + beta  * Q_mean

`beta` defaults to `alpha`. The CUDA kernel (`csrc/diana_shift.cu`) reads
the four inputs once and writes the three outputs in the same pass; a CPU
tensor takes the plain version `ref.diana_shift_update_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import diana_shift_update_ref

_DTYPES = (torch.float32, torch.bfloat16)


def diana_shift_update(h, q_own, mh, q_mean, *, alpha: float,
                       beta: float | None = None):
    """All inputs (N,), one dtype (f32 or bf16), one device. Returns
    (direction, h', H') in that dtype."""
    if beta is None:
        beta = alpha
    ins = (h, q_own, mh, q_mean)
    if any(t.dim() != 1 or t.shape != h.shape for t in ins):
        raise ValueError("diana_shift_update takes four (N,) tensors, got "
                         f"{[tuple(t.shape) for t in ins]}")
    if h.dtype not in _DTYPES or any(t.dtype != h.dtype for t in ins):
        raise ValueError("diana_shift_update takes one dtype, f32 or bf16, "
                         f"for all inputs, got {[t.dtype for t in ins]}")
    if any(t.device != h.device for t in ins):
        raise ValueError("diana_shift_update: inputs on different devices")
    if h.device.type == "cpu":
        return diana_shift_update_ref(h, q_own, mh, q_mean, alpha, beta)
    if h.device.type != "cuda":
        raise ValueError(f"diana_shift_update runs on cuda or cpu, not {h.device}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("diana_shift_update takes contiguous tensors")
    outs = [torch.empty_like(h) for _ in range(3)]
    n = h.shape[0]
    if n == 0:
        return tuple(outs)
    lib = _build.library()
    _build.check(lib.diana_shift_launch(
        *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs), n,
        float(alpha), float(beta), int(h.dtype == torch.bfloat16),
        _build.stream_of(h)), "diana_shift_update")
    _build.LAUNCHES["diana_shift_update"] += 1
    return tuple(outs)
