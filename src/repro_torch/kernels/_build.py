"""Build and load the port's CUDA kernels, and count their launches.

The sources in `csrc/` have a plain C interface. At first use they are
compiled for Hopper (`sm_90a`), one `nvcc` process per source, all started
together, and linked into one shared library that `ctypes` loads. The
library's name carries a hash of the sources and flags, so an edited source
is never served by a stale build. The build directory is `build/` next to
this file (listed in `.gitignore`).

Every C entry point takes its tensors as raw pointers and PyTorch's current
stream, launches, and returns `cudaGetLastError()`; `check` raises if that
is not 0. A failed build raises too: nothing falls back to the plain
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("randk_mask.cu", "diana_shift.cu", "qsgd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false")

# One count per kernel: its wrapper adds 1 where it launches the kernel on
# the card, and nowhere else (a CPU tensor's plain version is not counted).
LAUNCHES = {"randk_mask": 0, "diana_shift_update": 0, "qsgd_quantize": 0}

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
# C signatures: (name, argtypes); every function returns the cudaError_t
SIGNATURES = {
    # x, starts, out, M, Dp, d, k, scale, is_bf16, stream
    "randk_mask_launch": (_P, _P, _P, _I64, _I64, _I64, _I64, _F32, _I32, _P),
    # h, q_own, mh, q_mean, dir, h_out, mh_out, n, alpha, beta, is_bf16, stream
    "diana_shift_launch": (_P, _P, _P, _P, _P, _P, _P, _I64, _F32, _F32, _I32,
                           _P),
    # x, u, out, n_tiles, levels, is_bf16, stream
    "qsgd_launch": (_P, _P, _P, _I64, _F32, _I32, _P),
}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
            "port's CUDA kernels are built at first use on the card's host")
    return found


def build_dir() -> Path:
    return Path(__file__).resolve().parent / "build"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return build_dir() / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources (in parallel) and link the library; return it.

    Skips work when the library for these exact sources already exists.
    `verbose` adds `-Xptxas -v` (registers, shared memory, spills) and
    prints what the compiler says.
    """
    lib = library_path()
    if lib.exists():
        return lib
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for name in SOURCES:
        obj = out / f"{Path(name).stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, _, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in SIGNATURES.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError_t {err}")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
