"""Quickstart: the paper's headline result in a few lines (port of
`examples/quickstart.py`).

DIANA-RR (Algorithm 3) vs the naive Q-RR (Algorithm 2) and the QSGD/DIANA
baselines on federated L2-regularized logistic regression (paper Sec. 3.1):
same Rand-k compressor, same communication budget — DIANA-RR converges to
the exact optimum, the others stall at their compression-variance floor.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu \\
        --epochs 100

Each epoch draws its batch order and Rand-k windows from
`epoch_generator(0, e)` on the device, as the reference's epoch draws
them from its key.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.compression.ops import RandK
from repro_torch.core.algorithms import (
    init_algorithm,
    make_epoch_fn,
    theoretical_stepsizes,
)
from repro_torch.data.logreg import make_federated_logreg
from repro_torch.data.pipeline import epoch_generator
from repro_torch.device import resolve_device

# stepsize = theory x tuned multiplier (the paper's protocol, App. A.1;
# the reference's tuned values)
MULT = {"qsgd": 8.0, "q_rr": 8.0, "diana": 32.0, "diana_rr": 128.0}


def main(argv=None) -> dict[str, float]:
    """Prints and returns each method's f(x) - f* after `--epochs`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    problem = make_federated_logreg(m=20, n_batches=10, batch=10, d=100,
                                    cond=100.0, seed=0, heterogeneous=True,
                                    device=dev)
    comp = RandK(fraction=0.02)  # the paper's k/d ~= 0.02
    loss = problem.loss_fn()
    out = {}
    print(f"{'method':>10s} | f(x)-f* after {args.epochs} epochs")
    for name in ("qsgd", "q_rr", "diana", "diana_rr"):
        th = theoretical_stepsizes(name, l_max=problem.l_max, mu=problem.mu,
                                   omega=comp.omega(problem.d), m=problem.m,
                                   n=problem.n)
        spec, epoch = make_epoch_fn(name, loss, comp,
                                    gamma=th["gamma"] * MULT[name],
                                    alpha=th.get("alpha"))
        state = init_algorithm(spec, {"w": torch.zeros(problem.d,
                                                       device=dev)},
                               problem.m, problem.n)
        for e in range(args.epochs):
            state = epoch(state, problem.data, epoch_generator(0, e, dev))
        out[name] = problem.suboptimality(state.params["w"])
        print(f"{name:>10s} | {out[name]:.3e}", flush=True)
    return out


if __name__ == "__main__":
    main()
