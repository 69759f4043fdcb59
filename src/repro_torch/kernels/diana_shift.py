"""Fused DIANA shift/direction update (port of `repro.kernels.diana_shift`).

The element-wise update the paper's method adds on top of SGD (Algorithm 3
lines 7-9 / Algorithm 5 lines 8-11):

    direction = H_t + Q_mean
    h'        = h   + alpha * Q_own
    H'        = H_t + beta  * Q_mean

`beta` defaults to `alpha`. The CUDA kernel (`csrc/diana_shift.cu`) reads
the four inputs once and writes the three outputs in the same pass, in
16-byte lanes where n and the pointers allow; a CPU tensor takes the plain
version `ref.diana_shift_update_ref`. The simulator passes flat buffers;
the rank-stacked wire passes a group's ranks beside the group's one mean
table.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, census
from repro_torch.kernels.ref import diana_shift_update_ref

_DTYPES = (torch.float32, torch.bfloat16)


def _layout(hs: torch.Size, ms: torch.Size):
    """(ranks, ranks per group, n) of an h-side / H-side shape pair, or None."""
    if len(hs) == 1 and hs == ms:
        return 1, 1, hs[0]
    if len(hs) == 3 and len(ms) == 2 and hs[0] == ms[0] and hs[2] == ms[1]:
        return hs[0] * hs[1], hs[1], hs[2]
    return None


def _shift_lane_values(ins, outs, n: int) -> int:
    """Values in one lane of diana_shift_update's kernel: 16 bytes' worth
    on the wider side (4 when h or Q is f32, 8 when both are bf16) when n
    is a multiple of it and every input and output starts on a 16-byte
    boundary (each rank's row then starts on its lanes' grid); else 1."""
    v = 16 // max(t.element_size() for t in ins)
    if n % v == 0 and all(t.data_ptr() % 16 == 0 for t in (*ins, *outs)):
        return v
    return 1


def diana_shift_update(h, q_own, mh, q_mean, *, alpha: float,
                       beta: float | None = None):
    """h, Q_own (N,) with H, Q_mean (N,); or h, Q_own (G, C, n) with
    H, Q_mean (G, n): the C ranks of each of G groups beside the group's one
    mean. h and H share one dtype, Q_own and Q_mean another (f32 or bf16
    each), all on one device. Returns (direction, h', H'): the direction in
    Q_mean's dtype and shape, h' like h, H' like H."""
    if beta is None:
        beta = alpha
    ins = (h, q_own, mh, q_mean)
    layout = _layout(h.shape, mh.shape)
    if q_own.shape != h.shape or q_mean.shape != mh.shape or layout is None:
        raise ValueError(
            "diana_shift_update takes h, Q_own, H, Q_mean all (N,), or h, "
            "Q_own (G, C, n) with H, Q_mean (G, n), got "
            f"{[tuple(t.shape) for t in ins]}")
    if (h.dtype not in _DTYPES or mh.dtype != h.dtype
            or q_own.dtype not in _DTYPES or q_mean.dtype != q_own.dtype):
        raise ValueError(
            "diana_shift_update takes h and H in one dtype and Q_own and "
            "Q_mean in one dtype, each f32 or bf16, got "
            f"{[t.dtype for t in ins]}")
    if any(t.device != h.device for t in ins):
        raise ValueError("diana_shift_update: inputs on different devices")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"diana_shift_update runs on cuda or cpu, not {h.device}")
    if census.card(*ins) and not all(t.is_contiguous() for t in ins):
        raise ValueError("diana_shift_update takes contiguous tensors")
    if census.faked(*ins):
        return census.launch("diana_shift_update", ins, lambda: (
            torch.empty_like(q_mean), torch.empty_like(h),
            torch.empty_like(mh)))
    if h.device.type == "cpu":
        return census.plain("diana_shift_update", ins,
                            lambda: diana_shift_update_ref(
                                h, q_own, mh, q_mean, alpha, beta))
    outs = (torch.empty_like(q_mean), torch.empty_like(h), torch.empty_like(mh))
    ranks, per_group, n = layout
    if h.numel() == 0:
        return outs
    lib = _build.library()
    _build.check(lib.diana_shift_launch(
        *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs), ranks,
        per_group, n, float(alpha), float(beta), int(h.dtype == torch.bfloat16),
        int(q_own.dtype == torch.bfloat16), _shift_lane_values(ins, outs, n),
        _build.stream_of(h)), "diana_shift_update")
    _build.LAUNCHES["diana_shift_update"] += 1
    return outs
