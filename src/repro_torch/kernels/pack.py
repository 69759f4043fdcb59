"""Quantize + bit-pack the wire's slabs, decode them, and reduce a gathered
stack of them to its mean (port of `repro.kernels.pack`'s `pack_slab`,
`unpack_slab` and `unpack_reduce`).

`pack_slab` turns each row of a (K, D) slab into a byte lattice: a per-row
max-abs scale, stochastic rounding to q in [-L, L] with uniforms given as an
input, the biased byte b = q + L; rows pad to a BLOCK_ROWS multiple, and
with `nibble` two consecutive ROWS share a byte (lo | hi<<4). `unpack_slab`
is the repository's only dequantization, v = (b - L) * scale: its kernel
takes unpack_reduce's flat units at one rank a group.
`unpack_reduce` is the receive half of the packed collective: the gathered
slabs of each group's C ranks, decoded and accumulated in rank order, then
divided by C. The f32 wire with `wire_levels` round-trips its slab through
pack -> unpack and takes the same rank-order mean, so the packed transports
move the very same bytes and give the very same mean.

A stack of R slabs (one per rank) packs in one launch beside one shared
(K, D) array of uniforms. The CUDA kernels are `csrc/pack.cu` (the decode
is `csrc/pack.cuh`); a CPU tensor takes the plain versions in `ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, census
from repro_torch.kernels.ref import (
    BLOCK_ROWS,
    pack_slab_ref,
    unpack_reduce_ref,
    unpack_slab_ref,
)

_DTYPES = (torch.float32, torch.bfloat16)
# the most ranks unpack_reduce takes in a group (its kernel walks them in
# chunks of four, in registers)
_MAX_REDUCE_RANKS = 4096
# pack_slab's register variant (csrc/pack.cu): a thread holds NU units of
# each of the block's rows (NU in _PACK_UNITS). Preferred: at most 256
# threads holding at most 16 values of one rank each; else up to the
# kernel's limits, 512 threads and 32 values
_PACK_UNITS = (1, 2, 4, 8)
_PACK_BUDGETS = ((256, 16), (512, 32))  # (threads, values a thread)


def _check_levels(name: str, levels: int, nibble: bool) -> None:
    cap = 7 if nibble else 127  # 2L + 1 lattice points must fit the lane
    if not 1 <= levels <= cap:
        raise ValueError(f"{name} needs 1 <= levels <= {cap} "
                         f"({'nibble' if nibble else 'byte'} lane), got {levels}")


def _check_device(name: str, t: torch.Tensor, *others: torch.Tensor) -> None:
    if any(o.device != t.device for o in others):
        raise ValueError(f"{name}: inputs on different devices")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    if census.card(t, *others) and not all(
            x.is_contiguous() for x in (t, *others)):
        raise ValueError(f"{name} takes contiguous tensors")


def _pack_plan(vals: torch.Tensor, u: torch.Tensor, packed: torch.Tensor,
               nibble: bool) -> tuple[int, int, int]:
    """(vec, nu, threads) of pack_slab's launch.

    vec = 1 takes 16-byte units (4 f32 or 8 bf16 values) where D is a
    multiple of the unit and vals, u and packed start on 16-byte
    boundaries; else units of one value. nu = units a thread holds in
    registers, the smallest within the first budget of _PACK_BUDGETS that
    fits the row, with `threads` a multiple of 32. nu = 0 (the wide
    variant, 512 threads) for rows past the register budget: D > 16384 in
    byte mode and D > 8192 in nibble mode with 16-byte units, D > 4096 with
    one value a unit. At the wire's widths: (4, 2000, 2048) f32 takes
    nu = 2 with 256 threads, (4, 976, 5632) nu = 4 with 352.
    """
    d = vals.shape[-1]
    wide = 16 // vals.element_size()
    vec = int(d % wide == 0 and all(t.data_ptr() % 16 == 0
                                    for t in (vals, u, packed)))
    per_unit = wide if vec else 1
    units = -(-d // per_unit)
    rows = 2 if nibble else 1
    for max_threads, max_values in _PACK_BUDGETS:
        for nu in _PACK_UNITS:
            threads = -(-units // nu)
            if rows * nu * per_unit <= max_values and threads <= max_threads:
                return vec, nu, -(-threads // 32) * 32
    return vec, 0, _PACK_BUDGETS[-1][0]


def _reduce_unit(packed: torch.Tensor, out: torch.Tensor) -> int:
    """Packed bytes of one stored row that a thread of unpack_reduce's
    kernel takes: 8 where D is a multiple of 8 and packed starts on an
    8-byte boundary, else 4 where D is a multiple of 4 and packed starts on
    a 4-byte boundary, else 1; out must start on a 16-byte boundary for the
    first two (its float4 stores; a fresh tensor always does). At the
    wire's widths: D = 2048, 1408, 5632 and 64 take 8, the router's 60
    takes 4, hymba's 25 takes 1."""
    d = packed.shape[-1]
    if out.data_ptr() % 16 == 0:
        for unit in (8, 4):
            if d % unit == 0 and packed.data_ptr() % unit == 0:
                return unit
    return 1


# the widest unit a thread of unpack_slab's kernel takes (packed bytes of
# one stored row): at 4, each float4 store of a warp is 512 contiguous bytes
_SLAB_UNIT = 4


def _slab_unit(packed: torch.Tensor, out: torch.Tensor) -> int:
    """Packed bytes of one stored row that a thread of unpack_slab's kernel
    takes: unpack_reduce's plan (`_reduce_unit`) capped at _SLAB_UNIT, so 4
    at D = 2048, 1408, 5632, 64 and 60, 1 at 25 and 1003."""
    return min(_reduce_unit(packed, out), _SLAB_UNIT)


def pack_slab(vals: torch.Tensor, u: torch.Tensor, *, levels: int,
              nibble: bool = False):
    """vals: (K, D) or (R, K, D) f32/bf16; u: (K, D) f32 uniforms shared by
    the stack. Returns (packed uint8 (..., Kp, D) or, with nibble,
    (..., Kp / 2, D); scales (..., Kp, 1) f32), Kp = K rounded up to a
    multiple of BLOCK_ROWS."""
    if vals.dim() not in (2, 3) or vals.dtype not in _DTYPES:
        raise ValueError(f"pack_slab takes vals (K, D) or (R, K, D) f32/bf16,"
                         f" got {tuple(vals.shape)} {vals.dtype}")
    *lead, k, d = vals.shape
    if u.shape != (k, d) or u.dtype != torch.float32:
        raise ValueError(f"pack_slab takes u ({k}, {d}) f32, got "
                         f"{tuple(u.shape)} {u.dtype}")
    _check_levels("pack_slab", levels, nibble)
    _check_device("pack_slab", vals, u)
    if census.card(vals, u) and d >= 2**31:
        raise ValueError(f"pack_slab's kernel indexes a row in 32 bits: "
                         f"D < 2^31, got {d}")
    kp = k + (-k) % BLOCK_ROWS

    def empty():
        return (torch.empty(*lead, kp // 2 if nibble else kp, d,
                            dtype=torch.uint8, device=vals.device),
                torch.empty(*lead, kp, 1, dtype=torch.float32,
                            device=vals.device))

    if census.faked(vals, u):
        return census.launch("pack_slab", (vals, u), empty)
    if vals.device.type == "cpu":
        return census.plain("pack_slab", (vals, u), lambda: pack_slab_ref(
            vals, u, levels=levels, nibble=nibble))
    packed, scales = empty()
    if packed.numel() == 0:
        return packed, scales
    lib = _build.library()
    _build.check(lib.pack_slab_launch(
        vals.data_ptr(), u.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        vals.numel() // (k * d), k, kp, d, float(levels), int(nibble),
        int(vals.dtype == torch.bfloat16), *_pack_plan(vals, u, packed, nibble),
        _build.stream_of(vals)), "pack_slab")
    _build.LAUNCHES["pack_slab"] += 1
    return packed, scales


def unpack_slab(packed: torch.Tensor, scales: torch.Tensor, *, levels: int,
                n_rows: int, nibble: bool = False) -> torch.Tensor:
    """(..., Kp[/2], D) uint8 + (..., Kp, 1) f32 scales -> (..., n_rows, D)
    f32 values v = (b - L) * scale, n_rows <= Kp."""
    if packed.dim() not in (2, 3) or packed.dtype != torch.uint8:
        raise ValueError(f"unpack_slab takes packed (Kp, D) or (R, Kp, D) "
                         f"uint8, got {tuple(packed.shape)} {packed.dtype}")
    *lead, prows, d = packed.shape
    kp = 2 * prows if nibble else prows
    if scales.shape != (*lead, kp, 1) or scales.dtype != torch.float32:
        raise ValueError(f"unpack_slab takes scales {(*lead, kp, 1)} f32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    if not 0 <= n_rows <= kp:
        raise ValueError(f"unpack_slab needs 0 <= n_rows <= {kp}, got {n_rows}")
    _check_levels("unpack_slab", levels, nibble)
    _check_device("unpack_slab", packed, scales)

    def empty():
        return torch.empty(*lead, n_rows, d, dtype=torch.float32,
                           device=packed.device)

    if census.faked(packed, scales):
        return census.launch("unpack_slab", (packed, scales), empty)
    if packed.device.type == "cpu":
        return census.plain("unpack_slab", (packed, scales),
                            lambda: unpack_slab_ref(
                                packed, scales, levels=levels, n_rows=n_rows,
                                nibble=nibble))
    out = empty()
    if out.numel() == 0:
        return out
    lib = _build.library()
    _build.check(lib.unpack_slab_launch(
        packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        packed.numel() // (prows * d), n_rows, kp, d, float(levels),
        int(nibble), _slab_unit(packed, out), _build.stream_of(packed)),
        "unpack_slab")
    _build.LAUNCHES["unpack_slab"] += 1
    return out


def unpack_reduce(packed: torch.Tensor, scales: torch.Tensor, *, levels: int,
                  n_rows: int, nibble: bool = False) -> torch.Tensor:
    """([G,] C, Kp[/2], D) uint8 gathered slabs + ([G,] C, Kp, 1) f32
    scales -> the ([G,] n_rows, D) f32 mean of each group's C decoded
    slabs, accumulated in rank order, n_rows <= Kp."""
    if packed.dim() not in (3, 4) or packed.dtype != torch.uint8:
        raise ValueError(f"unpack_reduce takes packed (C, Kp, D) or (G, C, "
                         f"Kp, D) uint8, got {tuple(packed.shape)} "
                         f"{packed.dtype}")
    *lead, c, prows, d = packed.shape
    kp = 2 * prows if nibble else prows
    if scales.shape != (*lead, c, kp, 1) or scales.dtype != torch.float32:
        raise ValueError(f"unpack_reduce takes scales {(*lead, c, kp, 1)} "
                         f"f32, got {tuple(scales.shape)} {scales.dtype}")
    if not 1 <= c <= _MAX_REDUCE_RANKS:
        raise ValueError(f"unpack_reduce needs 1 <= C <= {_MAX_REDUCE_RANKS} "
                         f"ranks, got {c}")
    if not 0 <= n_rows <= kp:
        raise ValueError(f"unpack_reduce needs 0 <= n_rows <= {kp}, got "
                         f"{n_rows}")
    _check_levels("unpack_reduce", levels, nibble)
    _check_device("unpack_reduce", packed, scales)

    def empty():
        return torch.empty(*lead, n_rows, d, dtype=torch.float32,
                           device=packed.device)

    if census.faked(packed, scales):
        return census.launch("unpack_reduce", (packed, scales), empty)
    if packed.device.type == "cpu":
        return census.plain("unpack_reduce", (packed, scales),
                            lambda: unpack_reduce_ref(
                                packed, scales, levels=levels, n_rows=n_rows,
                                nibble=nibble))
    out = empty()
    if out.numel() == 0:
        return out
    lib = _build.library()
    _build.check(lib.unpack_reduce_launch(
        packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        packed.numel() // (c * prows * d), c, n_rows, kp, d, float(levels),
        int(nibble), _reduce_unit(packed, out), _build.stream_of(packed)),
        "unpack_reduce")
    _build.LAUNCHES["unpack_reduce"] += 1
    return out
