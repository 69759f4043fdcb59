#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Card: the GPU's name and power limit, as nvidia-smi reports them.
2. Build: compile the port's CUDA kernels from the sources in this checkout.
3. Kernel parity: each kernel against its plain PyTorch version on the card,
   bitwise (torch.equal), at the main path's shapes and at a large ragged
   shape; the median time of each (CUDA events after warm-up), the bytes it
   must move and its bound at the card's memory rate.
4. Main path: the paper's simulator round at the w8a shape (20 clients x
   2487 datapoints x 300 features, L/mu = 1e4): two epochs of each of the
   eight methods of experiments 1 and 2 with Rand-k (k/d = 0.02) at theory
   stepsizes, then one epoch of Q-RR with QSGD (8 levels). Every f - f*
   must be finite, each kernel must have launched in this run, and one more
   DIANA-RR epoch on the kernels must equal the same epoch on the plain
   versions (same state, order and draws), bitwise.
5. Profile: torch.profiler's device time per launch of each kernel at the
   path shapes, and the device's busy share over 200 DIANA-RR rounds at
   w8a. Informational: where the profiler sees no kernel it says so.

The last two lines are the kernels' JSON record and the run's verdict,
{"ok": true, "device": {"platform": "gpu", ...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
W8A_EPOCHS = 2


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, inner: int, samples: int = 15) -> float:
    """Median milliseconds of one call: CUDA events around `inner` calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_cases(torch, dev):
    """(kernel, case label, kernel call, plain call, bytes, ops, on_path)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.diana_shift import diana_shift_update
    from repro_torch.kernels.qsgd import qsgd_quantize
    from repro_torch.kernels.randk import randk_mask

    g = torch.Generator(device=dev).manual_seed(0)
    cases = []

    def randk(m, dp, d, k, dtype, on_path):
        x = torch.randn(m, dp, generator=g, device=dev).to(dtype)
        st = torch.randint(0, d, (m,), generator=g, device=dev, dtype=torch.int32)
        item = x.element_size()
        # the function needs only the k window values of each row of x: the
        # read is M*k elements (data-dependent), the write all M*Dp
        cases.append(("randk_mask", f"({m}, {dp}) d={d} k={k} {dtype}",
                      lambda: randk_mask(x, st, d=d, k=k),
                      lambda: ref.randk_mask_ref(x, st, d=d, k=k),
                      (m * k + m * dp) * item + 4 * m, m * dp, on_path))

    def diana(n, dtype, on_path):
        ins = [torch.randn(n, generator=g, device=dev).to(dtype) for _ in range(4)]
        alpha = 1.0 / 50.0  # 1/(1+omega) of Rand-k at k/d = 0.02
        cases.append(("diana_shift_update", f"N={n} {dtype}",
                      lambda: diana_shift_update(*ins, alpha=alpha),
                      lambda: ref.diana_shift_update_ref(*ins, alpha),
                      7 * n * ins[0].element_size(), 5 * n, on_path))

    def qsgd(n, dtype, on_path):
        x = (torch.randn(n, generator=g, device=dev) * 3).to(dtype)
        u = torch.rand(n, generator=g, device=dev)
        cases.append(("qsgd_quantize", f"N={n} {dtype}",
                      lambda: qsgd_quantize(x, u, levels=8),
                      lambda: ref.qsgd_quantize_ref(x, u, levels=8),
                      n * (2 * x.element_size() + 4), 10 * n, on_path))

    f32, bf16 = torch.float32, torch.bfloat16
    # the main path's shapes at w8a: Rand-k on the (20, 300) matrix of raveled
    # client gradients, k = 6; DIANA over 20*300 = 6000 (non-local rounds)
    # and 300 (DIANA-NASTYA's server update); QSGD over the 20 clients each
    # padded to one 1024-element tile
    randk(20, 300, 300, 6, f32, True)
    diana(6000, f32, True)
    diana(300, f32, False)
    qsgd(20 * 1024, f32, True)
    # large and ragged
    randk(20, 2**20, 2**20 - 77, int(0.02 * (2**20 - 77)), f32, False)
    randk(20, 2**20, 2**20 - 77, int(0.02 * (2**20 - 77)), bf16, False)
    diana(2**24 + 128, f32, False)
    diana(2**24 + 128, bf16, False)
    qsgd(2**24, f32, False)
    qsgd(2**24, bf16, False)
    return cases


def phase_kernels(torch, dev):
    records = {}
    for name, label, kern, plain, nbytes, ops, on_path in kernel_cases(torch, dev):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        inner = 200 if nbytes < 2**24 else 10
        ms = time_ms(torch, kern, inner)
        plain_ms = time_ms(torch, plain, inner)
        b_ms, b_by = bound_ms(nbytes, ops)
        print(f"kernel {name} [{label}]: bitwise={equal} max_abs_err={err} "
              f"time={ms * 1e3:.2f} us plain={plain_ms * 1e3:.2f} us "
              f"bytes={nbytes} bound={b_ms * 1e3:.3f} us ({b_by})", flush=True)
        check(equal, f"{name} [{label}] differs from its plain version "
                     f"(max abs err {err})")
        rec = records.setdefault(name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if on_path:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    return records


def phase_main_path(torch, dev):
    from repro_torch import experiments
    from repro_torch.compression.ops import QSGDQuantizer, RandK
    from repro_torch.core.algorithms import (
        init_algorithm,
        make_epoch_fn,
        theoretical_stepsizes,
    )
    from repro_torch.data.pipeline import run_epochs
    from repro_torch.data.reshuffle import ReshuffleSampler
    from repro_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    problem = experiments.make_problem("w8a", device=dev)
    print(f"w8a problem: a {tuple(problem.data['a'].shape)}, L_max="
          f"{problem.l_max:.6g}, mu={problem.mu:.6g}, f*={problem.f_star:.12g}, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    # warm-up (cuBLAS handles, first-call costs) so the first timed method
    # does not carry them
    warm = experiments.make_problem("paper", device=dev)
    for name in ("qsgd", "diana_nastya"):
        experiments.run_method(warm, name, RandK(fraction=0.02), 1)

    reset_launches()
    rows = (experiments.experiment1(W8A_EPOCHS, quick=True, problem=problem)
            + experiments.experiment2(W8A_EPOCHS, quick=True, problem=problem))
    sub, dt, _ = experiments.run_method(problem, "q_rr",
                                           QSGDQuantizer(levels=8), 1)
    rows.append(("q_rr/qsgd8", dt * 1e6, sub))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for name, us, sub in rows:
        print(f"main path {name}: {us / 1e6:.3f} s/epoch, f - f* = {sub!r}",
              flush=True)
        check(math.isfinite(sub), f"{name}: f - f* is not finite ({sub})")
    print(f"main path launches: {launches}", flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    # one DIANA-RR epoch, kernels vs plain versions, from a state with
    # non-zero shift tables (one epoch in), same order and draws
    comp = RandK(fraction=0.02)
    th = theoretical_stepsizes("diana_rr", l_max=problem.l_max, mu=problem.mu,
                               omega=comp.omega(problem.d), m=problem.m,
                               n=problem.n)
    loss = problem.loss_fn()
    spec, ep_cuda = make_epoch_fn("diana_rr", loss, comp, gamma=th["gamma"],
                                  alpha=th["alpha"], backend="cuda")
    _, ep_ref = make_epoch_fn("diana_rr", loss, comp, gamma=th["gamma"],
                              alpha=th["alpha"], backend="reference")
    sampler = ReshuffleSampler(problem.m, problem.n, mode="rr_once", seed=0)
    st = init_algorithm(spec, {"w": torch.zeros(problem.d, device=dev)},
                        problem.m, problem.n)
    st = run_epochs(ep_cuda, st, problem.data, sampler, epochs=1)
    g = torch.Generator(device=dev).manual_seed(1)
    draws = {"starts": torch.randint(0, problem.d, (problem.n, problem.m),
                                     generator=g, device=dev)}
    order = torch.from_numpy(sampler.epoch_order(1)).to(dev)
    a = ep_cuda(st, problem.data, g, order, draws)
    b = ep_ref(st, problem.data, g, order, draws)
    torch.cuda.synchronize()
    diff = max(float((a.params["w"] - b.params["w"]).abs().max()),
               float((a.shifts["w"] - b.shifts["w"]).abs().max()))
    same = (torch.equal(a.params["w"], b.params["w"])
            and torch.equal(a.shifts["w"], b.shifts["w"]))
    print(f"diana_rr epoch, cuda vs reference backend (tolerance: bitwise): "
          f"equal={same} max_abs_diff={diff}", flush=True)
    check(same, f"diana_rr: cuda and reference backends differ by {diff}")
    return launches, problem


def _device_us(torch, prof, names):
    """Summed device time (us) and count of the kernels whose name contains
    one of `names`, from a torch.profiler run (None if it saw no kernel)."""
    total, count = 0.0, 0
    for row in prof.key_averages():
        if row.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if names is None or any(n in row.key for n in names):
            total += row.self_device_time_total
            count += row.count
    return (total, count) if count else (None, 0)


def phase_profile(torch, dev, problem):
    """Device time of each kernel per launch at the path shapes, and the
    device's busy share over a window of DIANA-RR rounds at w8a."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.compression.ops import RandK
    from repro_torch.core.algorithms import (
        init_algorithm,
        make_round_fn,
        theoretical_stepsizes,
    )
    from repro_torch.data.reshuffle import ReshuffleSampler

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    kernel_names = {"randk_mask": "randk_mask_kernel",
                    "diana_shift_update": "diana_shift_kernel",
                    "qsgd_quantize": "qsgd_kernel"}
    device_us = {}
    for name, label, kern, _, _, _, on_path in kernel_cases(torch, dev):
        if not on_path:
            continue
        kern()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(50):
                kern()
            torch.cuda.synchronize()
        total, count = _device_us(torch, prof, [kernel_names[name]])
        device_us[name] = None if total is None else total / count
        print(f"profile {name} [{label}]: device time per launch = "
              f"{'not measured' if total is None else f'{total / count:.2f} us'}"
              f" ({count} launches seen)", flush=True)

    comp = RandK(fraction=0.02)
    th = theoretical_stepsizes("diana_rr", l_max=problem.l_max, mu=problem.mu,
                               omega=comp.omega(problem.d), m=problem.m,
                               n=problem.n)
    spec, round_fn = make_round_fn("diana_rr", problem.loss_fn(), comp,
                                   gamma=th["gamma"], alpha=th["alpha"])
    st = init_algorithm(spec, {"w": torch.zeros(problem.d, device=dev)},
                        problem.m, problem.n)
    order = torch.from_numpy(ReshuffleSampler(
        problem.m, problem.n, mode="rr_once").epoch_order(0)).to(dev).long()
    gen = torch.Generator(device=dev).manual_seed(0)
    params, shifts = st.params, st.shifts
    warm, rounds = min(20, problem.n // 2), min(200, problem.n // 2)
    for i in range(warm):
        params, shifts = round_fn(params, shifts, problem.data, order[:, i], gen)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(warm, warm + rounds):
            params, shifts = round_fn(params, shifts, problem.data, order[:, i],
                                      gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, kernels = _device_us(torch, prof, None)
    if busy is None:
        print("profile diana_rr rounds: device busy share not measured "
              "(the profiler saw no kernels)", flush=True)
    else:
        print(f"profile diana_rr rounds (w8a, {rounds} rounds, profiler on): "
              f"{wall_us / rounds:.1f} us/round wall, {busy / rounds:.1f} "
              f"us/round device busy ({kernels / rounds:.1f} kernels/round), "
              f"device idle share {1 - busy / wall_us:.3f}", flush=True)
        top = sorted((r for r in prof.key_averages()
                      if r.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda r: -r.self_device_time_total)[:8]
        for r in top:
            print(f"  {r.self_device_time_total / rounds:8.2f} us/round "
                  f"{r.count / rounds:5.2f}/round  {r.key[:90]}", flush=True)
    return device_us


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: FAIL: the port is not next to this script "
              f"({exc})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    try:
        card = card_line()
        print(card, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}", flush=True)

        t0 = time.perf_counter()
        _build.build(verbose=True)
        _build.library()
        print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path()}",
              flush=True)

        records = phase_kernels(torch, dev)
        launches, problem = phase_main_path(torch, dev)
        phase_profile(torch, dev, problem)
    except (SmokeFailure, RuntimeError, ValueError, OSError,
            subprocess.SubprocessError) as exc:
        print(f"chip_smoke: FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1

    sources = {"randk_mask": ("src/repro_torch/kernels/csrc/randk_mask.cu",
                              "src/repro/kernels/randk.py:158"),
               "diana_shift_update": ("src/repro_torch/kernels/csrc/diana_shift.cu",
                                      "src/repro/kernels/diana_shift.py:58"),
               "qsgd_quantize": ("src/repro_torch/kernels/csrc/qsgd.cu",
                                 "src/repro/kernels/qsgd.py:50")}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name],
                "max_abs_err": records[name]["max_abs_err"],
                "ms": records[name]["ms"], "plain_ms": records[name]["plain_ms"],
                "bound_ms": records[name]["bound_ms"],
                "bound_by": records[name]["bound_by"], "library_ms": None}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
