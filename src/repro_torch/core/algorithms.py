"""The paper's federated optimization algorithms and the baselines it compares
to (port of `repro.core.algorithms`).

Two families of epoch functions cover all fourteen methods:

Non-local (communicate every iteration; Sec. 2.1-2.2):
    sgd, qsgd, rr, q_rr (Algorithm 2), diana, diana_rr (Algorithm 3),
    ef_topk_rr (error feedback with Top-k, beyond the paper)
Local (communicate once per epoch of n local steps; Sec. 2.3-2.4):
    fedavg, fedrr, nastya, fedpaq, fedcom, q_nastya (Algorithm 4),
    diana_nastya (Algorithm 5)

Every epoch function is built by :func:`make_epoch_fn` and has the signature
``epoch(state, data, gen, order=None, draws=None) -> FedState``: `gen` is a
`torch.Generator` on the data's device, `order` the epoch's (M, n) batch
order from the host-side sampler (drawn from `gen` when omitted), and
`draws` optionally replaces the compressor's draws from `gen`:

    {"starts": (n, M) int}      Rand-k window starts, non-local epochs
    {"starts": (M,) int}        ... local epochs (one compression per epoch)
    {"u": (n, M, Dp) f32}       QSGD uniforms, non-local epochs
    {"u": (M, Dp) f32}          ... local epochs

JAX's threefry streams cannot be reproduced in torch, so the tests rebuild
the reference's draws from its key schedule and hand them in here: that is
what holds compressed trajectories to the reference.

What distinguishes the methods — the client memory and how it shapes the
wire message — lives in the shift-rule layer (`core.rules`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compression.backend import CompressionBackend, get_backend
from repro_torch.compression.ops import Identity, tree_compression_bits
from repro_torch.core.api import (
    FedState,
    LossFn,
    accumulate_bits,
    clients_grad,
    clients_grad_at,
    init_state,
    num_batches,
    num_clients,
    round_batches,
    sample_permutations,
    tree_leaves,
    tree_map,
    tree_mean_clients,
    tree_zeros_like,
)
from repro_torch.core.rules import get_rule


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    """Static description of a method in the paper's design space."""

    name: str
    family: str  # 'nonlocal' | 'local'
    sampling: str  # 'rr' (without replacement) | 'wr' (with replacement)
    shift_mode: str  # 'none' | 'single' | 'per_slot' | 'ef'
    server_stepsize: bool = False  # local family: eta != gamma*n
    default_compressed: bool = True  # identity-compressor methods set False


ALGORITHMS: dict[str, AlgoSpec] = {
    # non-local
    "sgd": AlgoSpec("sgd", "nonlocal", "wr", "none", default_compressed=False),
    "qsgd": AlgoSpec("qsgd", "nonlocal", "wr", "none"),
    "rr": AlgoSpec("rr", "nonlocal", "rr", "none", default_compressed=False),
    "q_rr": AlgoSpec("q_rr", "nonlocal", "rr", "none"),
    "diana": AlgoSpec("diana", "nonlocal", "wr", "single"),
    "diana_rr": AlgoSpec("diana_rr", "nonlocal", "rr", "per_slot"),
    "ef_topk_rr": AlgoSpec("ef_topk_rr", "nonlocal", "rr", "ef"),
    # local
    "fedavg": AlgoSpec("fedavg", "local", "wr", "none", default_compressed=False),
    "fedrr": AlgoSpec("fedrr", "local", "rr", "none", default_compressed=False),
    "nastya": AlgoSpec("nastya", "local", "rr", "none", server_stepsize=True,
                       default_compressed=False),
    "fedpaq": AlgoSpec("fedpaq", "local", "wr", "none"),
    "fedcom": AlgoSpec("fedcom", "local", "wr", "none", server_stepsize=True),
    "q_nastya": AlgoSpec("q_nastya", "local", "rr", "none", server_stepsize=True),
    "diana_nastya": AlgoSpec("diana_nastya", "local", "rr", "single",
                             server_stepsize=True),
}


def init_algorithm(spec: AlgoSpec, params, m: int, n: int) -> FedState:
    """Build the initial FedState with the right shift layout for `spec`."""
    rule = get_rule(spec.shift_mode)
    shifts = rule.init_shifts(params, m, n_slots=n)
    server_h = tree_zeros_like(params) if rule.needs_server_h else None
    return init_state(params, shifts=shifts, server_h=server_h)


def _sample_round_indices(spec: AlgoSpec, gen, m: int, n: int) -> torch.Tensor:
    """(M, n) matrix of batch indices for one epoch."""
    if spec.sampling == "rr":
        return sample_permutations(gen, m, n)
    return torch.randint(0, n, (m, n), generator=gen, device=gen.device)


def _epoch_order(spec, gen, order, m, n, device) -> torch.Tensor:
    if order is None:
        return _sample_round_indices(spec, gen, m, n).to(device)
    return torch.as_tensor(order, device=device).to(torch.int64)


def _draw(draws, i=None):
    """The compressor draws of round i (or of the whole local epoch)."""
    if draws is None:
        return None
    (value,) = draws.values()
    return value if i is None else value[i]


# ---------------------------------------------------------------------------
# non-local family: one compressed aggregation per iteration
# ---------------------------------------------------------------------------

def _make_round(rule, loss_fn: LossFn, comp, gamma: float, alpha: float,
                backend: CompressionBackend):
    """One non-local communication round on a client-stacked slice.

    round(params, shifts, data, col, gen, draws=None) -> (params, shifts):
    `data` leaves are (M, n, ...), `col` the (M,) batch index per client,
    `draws` this round's compressor draws (see the module docstring).
    """

    def round_fn(params, shifts, data, col, gen, draws=None):
        m = num_clients(data)
        idx = (torch.arange(m, device=col.device), col)
        batches = round_batches(data, col)
        g = clients_grad(loss_fn, params, batches)  # leaves (M, ...)

        # select the round's memory (per-slot tables index by (client,
        # batch)), build the payload, run every client through ONE backend
        # launch (independent randomness per client — the paper's 1/M
        # variance factor), apply the rule's fused update, write back
        h = rule.select(shifts, idx)
        p = rule.payload(g, h, gamma=gamma)
        q = backend.compress_clients(comp, gen, p, draws)
        ghat, h_new, _ = rule.update(h, q, h, q, alpha=alpha, gamma=gamma,
                                     backend=backend, payload=p)
        new_shifts = rule.scatter(shifts, idx, h_new)

        direction = tree_mean_clients(ghat)
        new_params = tree_map(lambda p, d: p - gamma * d, params, direction)
        return new_params, new_shifts

    return round_fn


def _nonlocal_epoch(spec: AlgoSpec, loss_fn: LossFn, comp, gamma: float,
                    alpha: float, backend: CompressionBackend,
                    state: FedState, data, gen, order=None,
                    draws=None) -> FedState:
    m, n = num_clients(data), num_batches(data)
    rule = get_rule(spec.shift_mode)
    device = state.rounds.device
    idx = _epoch_order(spec, gen, order, m, n, device)  # (M, n)
    round_fn = _make_round(rule, loss_fn, comp, gamma, alpha, backend)

    params, shifts = state.params, state.shifts
    if rule.slotted:  # the rounds write the slot tables in place
        shifts = tree_map(torch.clone, shifts)
    for i in range(n):
        params, shifts = round_fn(params, shifts, data, idx[:, i], gen,
                                  _draw(draws, i))

    bits_per_round = float(m * tree_compression_bits(comp, state.params))
    bits, bits_lo = accumulate_bits(state.bits, state.bits_lo,
                                    n * bits_per_round)
    return state._replace(params=params, shifts=shifts,
                          rounds=state.rounds + n, bits=bits, bits_lo=bits_lo)


# ---------------------------------------------------------------------------
# local family: n local steps, one compressed aggregation per epoch
# ---------------------------------------------------------------------------

def _local_epoch(spec: AlgoSpec, loss_fn: LossFn, comp, gamma: float, eta: float,
                 alpha: float, backend: CompressionBackend,
                 state: FedState, data, gen, order=None,
                 draws=None) -> FedState:
    m, n = num_clients(data), num_batches(data)
    rule = get_rule(spec.shift_mode)
    if not rule.supports_local:
        raise ValueError(
            f"shift rule {rule.name!r} has no local-family epoch (the "
            "local methods communicate one epoch gradient — there is no "
            "per-batch slot or residual stream to feed it)")
    device = state.rounds.device
    idx = _epoch_order(spec, gen, order, m, n, device)  # (M, n)

    # every client walks its own order from the server iterate, all M
    # clients stepping together (the reference's vmap over a scan)
    xs = tree_map(lambda p: p.expand((m,) + tuple(p.shape)), state.params)
    for i in range(n):
        g_i = clients_grad_at(loss_fn, xs, round_batches(data, idx[:, i]))
        xs = tree_map(lambda x, g: x - gamma * g, xs, g_i)
    # g_{t,m} = (x_t - x^n_{t,m}) / (gamma * n)   (Alg. 4/5 line 7)
    g = tree_map(lambda p, xn: (p - xn) / (gamma * n), state.params, xs)

    # rule chain (Alg. 5 lines 8-11 when shifts exist): compress the epoch
    # messages, combine the aggregate with the server memory (fused
    # direction + H-update in one pass), and axpy the client tables
    h = rule.select(state.shifts, None)
    p = rule.payload(g, h, gamma=gamma)
    qd = backend.compress_clients(comp, gen, p, _draw(draws))
    direction, server_h = rule.direction(
        state.server_h, tree_mean_clients(qd), alpha=alpha, gamma=gamma,
        backend=backend)
    shifts = rule.table_axpy(state.shifts, qd, alpha=alpha)

    step = eta if spec.server_stepsize else gamma * n
    params = tree_map(lambda p, d: p - step * d, state.params, direction)
    bits_per_round = float(m * tree_compression_bits(comp, state.params))
    bits, bits_lo = accumulate_bits(state.bits, state.bits_lo, bits_per_round)
    return state._replace(params=params, shifts=shifts, server_h=server_h,
                          rounds=state.rounds + 1, bits=bits, bits_lo=bits_lo)


# ---------------------------------------------------------------------------
# public factory
# ---------------------------------------------------------------------------

def _resolve_comp_alpha(compressor, alpha):
    comp = Identity() if compressor is None else compressor
    if alpha is None:
        # Theorems 2/4: alpha <= 1/(1+omega); identity => alpha=1
        om = max(comp.omega(1024), 0.0)
        alpha = 1.0 / (1.0 + (0.0 if om != om else om))  # NaN-safe (TopK)
    return comp, alpha


def make_epoch_fn(name: str, loss_fn: LossFn, compressor=None, *, gamma: float,
                  eta: float | None = None, alpha: float | None = None,
                  backend: str | CompressionBackend | None = None):
    """Return (spec, epoch_fn) for algorithm `name`.

    epoch_fn(state, data, gen, order=None, draws=None) -> FedState runs one
    full data epoch (n communication rounds for non-local methods, 1 for
    local methods); see the module docstring for `order` and `draws`.

    `backend` selects the compression path ("reference" | "cuda"); default
    follows $REPRO_TORCH_COMPRESSION_BACKEND, then "cuda".
    """
    spec = ALGORITHMS[name]
    be = get_backend(backend)
    comp, alpha = _resolve_comp_alpha(compressor, alpha)
    if eta is None:
        eta = gamma  # caller should set for server-stepsize methods

    if spec.family == "nonlocal":
        def epoch(state, data, gen, order=None, draws=None):
            return _nonlocal_epoch(spec, loss_fn, comp, gamma, alpha, be,
                                   state, data, gen, order, draws)
    else:
        def epoch(state, data, gen, order=None, draws=None):
            return _local_epoch(spec, loss_fn, comp, gamma, eta, alpha, be,
                                state, data, gen, order, draws)

    return spec, epoch


def make_round_fn(name: str, loss_fn: LossFn, compressor=None, *,
                  gamma: float, alpha: float | None = None,
                  backend: str | CompressionBackend | None = None):
    """Return (spec, round_fn) for non-local algorithm `name`.

    round_fn(params, shifts, data, col, gen, draws=None) -> (params, shifts)
    is ONE communication round on a client-stacked slice — the body
    `_nonlocal_epoch` loops over. Local-family methods have no per-round
    form (they communicate once per epoch) and raise. A per-slot table is
    written in place (see `PerSlotShift.scatter`).
    """
    spec = ALGORITHMS[name]
    if spec.family != "nonlocal":
        raise ValueError(
            f"{name!r} is a local-family method — it communicates one epoch "
            "gradient, not per-round messages; there is no round function")
    be = get_backend(backend)
    comp, alpha = _resolve_comp_alpha(compressor, alpha)
    rule = get_rule(spec.shift_mode)
    return spec, _make_round(rule, loss_fn, comp, gamma, alpha, be)


def run_fleet_rounds(name: str, loss_fn: LossFn, compressor=None, *,
                     gamma: float, alpha: float | None = None,
                     backend: str | CompressionBackend | None = None,
                     params, data, sampler, store, cohort_sampler,
                     rounds: int, seed: int = 0, start_round: int = 0,
                     draws=None):
    """Simulator fleet driver: partial participation at population scale.

    Each round t samples a cohort of client ids (`fleet.CohortSampler`,
    sorted — the canonical rank order), gathers the cohort's rows of the
    population `data` (leaves (C, n, ...)) and its persistent shifts from
    the host `store` (`fleet.ClientStateStore`), runs ONE paper round — the
    `_make_round` body `_nonlocal_epoch` loops over — on the gathered
    slice, and scatters the updated shifts back. Batch indices come from
    each client's OWN data cursor (the store's per-client micro-step
    counter) through the stateless `sampler`, so the walk is resumable
    from `(store, start_round)` alone.

    Round t draws from `epoch_generator(seed, t)` (the reference folds t
    into its key); `draws(t)`, when given, returns round t's compressor
    draws in its place (see the module docstring: one round's slice).
    With cohort == population under cohort-RR every round is one
    `_nonlocal_epoch` step. The store is updated in place; returns
    (params, info) with round/bit totals.
    """
    from repro_torch.data.pipeline import ClientOrderWalk, epoch_generator

    comp, alpha = _resolve_comp_alpha(compressor, alpha)
    _, round_fn = make_round_fn(name, loss_fn, comp, gamma=gamma,
                                alpha=alpha, backend=backend)
    if store.population != cohort_sampler.population or \
            store.population != sampler.m:
        raise ValueError(
            f"population mismatch: store {store.population}, cohort sampler "
            f"{cohort_sampler.population}, data sampler {sampler.m}")
    device = tree_leaves(data)[0].device
    walk = ClientOrderWalk(sampler)  # the same cursor walk CohortStream runs

    bits_per_client = float(tree_compression_bits(comp, params))
    for t in range(start_round, start_round + rounds):
        cohort = cohort_sampler.cohort_for_round(t)
        col = walk.cols_at(cohort, store.cursors(cohort))[:, 0]
        rows = torch.from_numpy(cohort).to(device)
        data_slice = tree_map(lambda l: l[rows], data)
        shifts = tree_map(lambda h: h.to(device), store.gather(cohort))
        params, new_shifts = round_fn(
            params, shifts, data_slice,
            torch.from_numpy(col.astype(np.int64)).to(device),
            epoch_generator(seed, t, device),
            None if draws is None else draws(t))
        if store.has_shifts:
            store.scatter(cohort, new_shifts)
        store.advance(cohort, 1)
        store.add_bits(cohort, bits_per_client)
    info = {"rounds": rounds,
            "bits": rounds * cohort_sampler.cohort_size * bits_per_client}
    return params, info


def theoretical_stepsizes(name: str, *, l_max: float, mu: float, omega: float,
                          m: int, n: int) -> dict[str, float]:
    """Largest stepsizes allowed by Theorems 1-4 (and the baselines' papers).

    The paper tunes a constant multiplier on top of these; this returns the
    raw theory values.
    """
    if name in ("q_rr", "rr"):
        return {"gamma": 1.0 / ((1.0 + 2.0 * omega / m) * l_max)}
    if name == "qsgd" or name == "sgd":
        return {"gamma": 1.0 / ((1.0 + 2.0 * omega / m) * l_max)}
    if name == "diana_rr":
        alpha = 1.0 / (1.0 + omega)
        gamma = min(alpha / (2.0 * n * mu), 1.0 / ((1.0 + 6.0 * omega / m) * l_max))
        return {"gamma": gamma, "alpha": alpha}
    if name == "diana":
        alpha = 1.0 / (1.0 + omega)
        gamma = 1.0 / ((1.0 + 6.0 * omega / m) * l_max)
        return {"gamma": gamma, "alpha": alpha}
    if name in ("q_nastya", "fedcom", "nastya"):
        eta = 1.0 / (16.0 * l_max * (1.0 + omega / m))
        gamma = 1.0 / (5.0 * n * l_max)
        return {"gamma": gamma, "eta": eta}
    if name == "diana_nastya":
        alpha = 1.0 / (1.0 + omega)
        eta = min(alpha / (2.0 * mu), 1.0 / (16.0 * l_max * (1.0 + 9.0 * omega / m)))
        gamma = min(1.0 / (16.0 * l_max * n), eta / n)
        return {"gamma": gamma, "eta": eta, "alpha": alpha}
    if name in ("fedavg", "fedrr", "fedpaq"):
        return {"gamma": 1.0 / (5.0 * n * l_max)}
    if name == "ef_topk_rr":
        # EF-SGD (Stich et al. 2018; Karimireddy et al. 2019): a CONTRACTIVE
        # compressor with contraction delta admits gamma = O(delta / L); map
        # omega onto delta via delta = 1/(1+omega), exact for k/d = delta
        delta = 1.0 / (1.0 + max(omega, 0.0))
        return {"gamma": delta / (2.0 * l_max)}
    raise ValueError(name)
