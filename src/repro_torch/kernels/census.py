"""The dry run's record of the kernels a step launches (`launch.dryrun`,
`launch.cost_analysis`).

Under an active census (`recording`), a wrapper handed a fake tensor (a
`torch._subclasses.fake_tensor.FakeTensor`, which the dry run's step runs
on) neither builds nor launches its kernel: after the checks of the card's
path (`card`), it records the launch the card would make and returns
outputs of the kernel's shapes and dtypes (`launch`). `_build.LAUNCHES`
counts only real launches: the census's count is its records. A real
tensor never
takes that branch: on the card the wrapper launches, on the host it runs
the plain version, which under a census is recorded as the launch the card
would make (`plain`), so the same step on real host tensors and on fake
ones gives the same records. A fake tensor outside a census raises: the
card's path builds and launches the kernel or fails.

A record's bytes are the numerator of its kernel's bound (`PERF.md` §6):
each input read once and each output written once, except where the
wrapper says the kernel reads less (randk_compress reads only its
window's rows, randk_mask the k values of each row's window).
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor


class KernelRecord(NamedTuple):
    """One launch: the kernel, its inputs' shapes and dtypes, the bytes it
    must read and write."""

    name: str
    shapes: tuple
    read: int
    written: int


class Census:
    """The launches recorded while it is active. `depth` is above 0 while
    a kernel's body (its plain version, or the fake outputs' allocation)
    runs, so an op census can leave those ops out: the card runs one
    kernel there. `on_outputs(outs)`, where set, sees each launch's
    outputs (the op census's memory tracker counts them)."""

    def __init__(self):
        self.records: list[KernelRecord] = []
        self.depth = 0
        self.on_outputs: Callable | None = None

    def summary(self) -> dict:
        """{kernel: {"launches", "read", "written"}}, the kernels in the
        order of their first launch."""
        out: dict = {}
        for r in self.records:
            row = out.setdefault(r.name, {"launches": 0, "read": 0,
                                          "written": 0})
            row["launches"] += 1
            row["read"] += r.read
            row["written"] += r.written
        return out


_STACK: list[Census] = []


def active() -> Census | None:
    """The innermost active census, or None."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def recording(census: Census | None = None):
    """Record the kernels launched in the block into `census` (a new one
    by default), which the block gets."""
    census = Census() if census is None else census
    _STACK.append(census)
    try:
        yield census
    finally:
        _STACK.remove(census)


def faked(*tensors: torch.Tensor) -> bool:
    """Whether a wrapper's inputs are the dry run's fake tensors (then it
    records, `launch`); raises for a fake tensor outside a census."""
    if not any(isinstance(t, FakeTensor) for t in tensors):
        return False
    if active() is None:
        raise RuntimeError("a fake tensor reached a kernel wrapper outside a "
                           "census (kernels.census.recording): the card's "
                           "path needs real tensors")
    return True


def card(*tensors: torch.Tensor) -> bool:
    """Whether a wrapper applies the checks of the card's path: its inputs
    lie on a CUDA device, or are the dry run's fake tensors (`faked`),
    which stand for them (on a host without CUDA they lie on the CPU)."""
    return faked(*tensors) or tensors[0].device.type == "cuda"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _record(c: Census, name: str, inputs, body: Callable, read):
    c.depth += 1
    try:
        out = body()
    finally:
        c.depth -= 1
    outs = out if isinstance(out, tuple) else (out,)
    if outs[0].numel() == 0:  # the wrappers launch nothing for no work
        return out
    written = sum(_nbytes(t) for t in outs)
    got = (sum(_nbytes(t) for t in inputs) if read is None
           else read(outs) if callable(read) else int(read))
    c.records.append(KernelRecord(
        name, tuple((tuple(t.shape), str(t.dtype)) for t in inputs), got,
        written))
    if c.on_outputs is not None:
        c.on_outputs(outs)
    return out


def launch(name: str, inputs, outputs: Callable, read=None):
    """The fake branch of a wrapper, after its checks: record the launch
    of kernel `name` on `inputs` (the tensors it reads) and return
    `outputs()` (empty tensors of the kernel's outputs' shapes and
    dtypes). `read`: the bytes it reads (an int, or a function of the
    outputs), where not all of every input."""
    return _record(active(), name, inputs, outputs, read)


def plain(name: str, inputs, fn: Callable, read=None):
    """A host tensor's plain version `fn()`; under a census also recorded
    as the launch of kernel `name` that the card would make."""
    c = active()
    if c is None:
        return fn()
    return _record(c, name, inputs, fn, read)
