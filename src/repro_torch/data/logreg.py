"""Federated L2-regularized logistic regression problems (paper Sec. 3.1).

The port of `repro.data.logreg`. The paper's experiments use LibSVM datasets
(mushrooms/w8a/a9a) sorted by label and split equally among 20 clients — a
maximally heterogeneous split. The same construction runs on synthetic data:
draw a separable-ish binary classification task, sort by label, and split
contiguously so the first clients hold mostly class -1 and the rest class +1.

The numpy generator stream below is the dataset's identity: it is copied
draw for draw from the JAX package, so `a`, `y`, `lam`, `l_max`, `mu` and
`f_star` are byte-equal to the reference's. Only the device tensors and
`loss_fn` are torch.

Smoothness/strong-convexity constants follow paper App. A.1:
    L      = lambda_max( (1/4N) A^T A ) + 2*lam
    L_max  = max_{i,m} ||a_{mi}||^2 / 4 + 2*lam
    mu     = 2*lam
and lam is picked so that L/mu ~ cond.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class LogRegProblem:
    """A federated logreg instance in client-stacked layout."""

    data: Any  # {"a": (M, n, b, d), "y": (M, n, b)} float32 tensors
    lam: float
    l_smooth: float
    l_max: float
    mu: float
    f_star: float
    x_star: np.ndarray

    @property
    def m(self) -> int:
        return self.data["a"].shape[0]

    @property
    def n(self) -> int:
        return self.data["a"].shape[1]

    @property
    def d(self) -> int:
        return self.data["a"].shape[3]

    def loss_fn(self):
        lam = self.lam

        def loss(params, batch):
            logits = batch["a"] @ params["w"]
            # logaddexp(0, z), not softplus: softplus switches to the
            # identity branch at z > 20, the reference's logaddexp does not
            z = -batch["y"] * logits
            return torch.mean(torch.logaddexp(torch.zeros_like(z), z)) + \
                lam * torch.sum(params["w"] ** 2)

        return loss

    def full_objective(self, w) -> float:
        if isinstance(w, torch.Tensor):
            w = w.detach().cpu().numpy()
        a = self.data["a"].cpu().numpy().reshape(-1, self.d)
        y = self.data["y"].cpu().numpy().reshape(-1)
        return float(np.mean(np.logaddexp(0.0, -y * (a @ w))) + self.lam * np.sum(w**2))

    def suboptimality(self, w) -> float:
        return self.full_objective(w) - self.f_star


def logreg_constants(a: np.ndarray, lam: float) -> tuple[float, float, float]:
    """(L, L_max, mu) for f = mean logloss + lam||x||^2 over rows of `a`."""
    n_total = a.shape[0]
    gram = a.T @ a / (4.0 * n_total)
    l_smooth = float(np.linalg.eigvalsh(gram)[-1]) + 2.0 * lam
    l_max = float(np.max(np.sum(a * a, axis=1)) / 4.0) + 2.0 * lam
    mu = 2.0 * lam
    return l_smooth, l_max, mu


def _solve_logreg(a: np.ndarray, y: np.ndarray, lam: float,
                  tol: float = 1e-12, iters: int = 5000) -> np.ndarray:
    """Reference solution via Newton's method (the paper computes f(x*) to
    1e-16; Newton on this smooth strongly-convex objective reaches machine
    precision in a handful of iterations)."""
    d = a.shape[1]
    w = np.zeros(d)
    n = a.shape[0]
    for _ in range(iters):
        z = y * (a @ w)
        sig = 1.0 / (1.0 + np.exp(z))  # sigma(-z)
        grad = -(a.T @ (y * sig)) / n + 2.0 * lam * w
        s = sig * (1.0 - sig)
        hess = (a.T * s) @ a / n + 2.0 * lam * np.eye(d)
        step = np.linalg.solve(hess, grad)
        w = w - step
        if np.linalg.norm(grad) < tol:
            break
    return w


def make_federated_logreg(
    *,
    m: int = 20,
    n_batches: int = 10,
    batch: int = 8,
    d: int = 40,
    cond: float = 1e4,
    seed: int = 0,
    heterogeneous: bool = True,
    device: str | torch.device | None = None,
) -> LogRegProblem:
    """Synthetic analogue of the paper's LibSVM setup.

    cond: target condition number L/mu (paper uses ~1e4); fixes lam.
    heterogeneous: label-sorted contiguous split (paper App. A Tables 2-4).
    device: where the data tensors live (None -> "cuda").
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_total = m * n_batches * batch
    # anisotropic features so L_max >> mu like the LibSVM datasets
    scales = np.exp(rng.uniform(-1.0, 1.0, size=(d,)))
    a = rng.normal(size=(n_total, d)) * scales
    w_true = rng.normal(size=(d,))
    logits = a @ w_true + 0.5 * rng.normal(size=(n_total,))
    y = np.where(logits > 0, 1.0, -1.0)

    if heterogeneous:
        order = np.argsort(y, kind="stable")  # class -1 first, then +1
        a, y = a[order], y[order]
    else:
        order = rng.permutation(n_total)
        a, y = a[order], y[order]

    # lam from target condition number: L(lam)/ (2 lam) = cond
    gram_top = float(np.linalg.eigvalsh(a.T @ a / (4.0 * n_total))[-1])
    lam = gram_top / (2.0 * cond - 2.0)
    l_smooth, l_max, mu = logreg_constants(a, lam)

    x_star = _solve_logreg(a, y, lam)
    f_star = float(np.mean(np.logaddexp(0.0, -y * (a @ x_star))) + lam * np.sum(x_star**2))

    data = {
        "a": torch.from_numpy(
            a.reshape(m, n_batches, batch, d).astype(np.float32)).to(dev),
        "y": torch.from_numpy(
            y.reshape(m, n_batches, batch).astype(np.float32)).to(dev),
    }
    return LogRegProblem(
        data=data, lam=lam, l_smooth=l_smooth, l_max=l_max, mu=mu,
        f_star=f_star, x_star=x_star,
    )
