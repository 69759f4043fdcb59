"""Core API for federated optimization algorithms (port of `repro.core.api`).

The simulator treats the federated system exactly as the paper does: `M`
clients, each holding `n` minibatches; communication rounds alternate client
computation with (possibly compressed) aggregation. Parameters and client
data are dict pytrees of tensors (`{"w": tensor}`), and every method runs
as an `epoch(state, data, gen, order=None, draws=None) -> state` function.

Data layout: a *client-stacked* pytree whose leaves have shape
``(M, n, *batch_shape)`` — M clients, n minibatches each.

Trees here are nested dicts, lists and tuples of tensors, with `None` an
empty subtree, as in JAX. Dict leaves are visited in sorted key order, as
JAX does, so that a raveled tree has the reference's layout (the Rand-k
window of a round lands on the same coordinates on both sides).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

Params = Any
Batch = Any
LossFn = Callable[[Params, Batch], torch.Tensor]


class FedState(NamedTuple):
    """State carried across communication rounds.

    shifts:    DIANA-style control variates. Layout depends on the algorithm:
               - None                       (no variance reduction)
               - leaves (M, *param_shape)   (DIANA, DIANA-NASTYA: 1/worker)
               - leaves (M, n, *param_shape)(DIANA-RR: n shift vectors/worker)
    server_h:  running mean shift h_t = (1/M) sum_m h_{t,m} (DIANA-NASTYA
               server bookkeeping; None elsewhere).
    rounds:    communication rounds elapsed (int32 scalar tensor).
    bits:      cumulative uplink bits sent by all clients, as a compensated
               (Kahan) float32 pair with `bits_lo`, exactly as the reference
               keeps it: a plain f32 accumulator stops incrementing once the
               total passes ~2^24 x the per-round increment. Update via
               `accumulate_bits`.
    """

    params: Params
    shifts: Any
    server_h: Any
    rounds: torch.Tensor
    bits: torch.Tensor
    bits_lo: torch.Tensor


def init_state(params: Params, shifts: Any = None, server_h: Any = None) -> FedState:
    dev = tree_leaves(params)[0].device
    return FedState(
        params=params,
        shifts=shifts,
        server_h=server_h,
        rounds=torch.zeros((), dtype=torch.int32, device=dev),
        bits=torch.zeros((), dtype=torch.float32, device=dev),
        bits_lo=torch.zeros((), dtype=torch.float32, device=dev),
    )


def accumulate_bits(bits, bits_lo, inc):
    """Compensated (Kahan-Neumaier style) f32 add: (bits', bits_lo').

    The same operation order as the reference: the low word keeps whatever
    the high-word add rounded away. Eager torch does not reassociate float
    adds, so `(t - bits) - y` is not folded to zero.
    """
    y = inc - bits_lo
    t = bits + y
    return t, (t - bits) - y


# ---------------------------------------------------------------------------
# pytree helpers
# ---------------------------------------------------------------------------

def tree_flatten(tree) -> tuple[list, Callable[[list], Any]]:
    """(leaves, unflatten): leaves in JAX's order (dict keys sorted)."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(t) for t in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    counts = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]
    # unflatten keeps the structure only, never the leaves: a caller that
    # drops its leaves frees them while it holds unflatten
    unflattens = [p[1] for p in parts]
    kind = type(tree)

    def unflatten(new_leaves):
        out, pos = [], 0
        for unf, c in zip(unflattens, counts):
            out.append(unf(list(new_leaves[pos:pos + c])))
            pos += c
        if keys is not None:
            return dict(zip(keys, out))
        if hasattr(kind, "_fields"):  # NamedTuple
            return kind(*out)
        return kind(out)

    return leaves, unflatten


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_paths(tree) -> list[str]:
    """Each leaf's path, in `tree_flatten`'s order, spelled as the
    reference's checkpoint and state store spell JAX's key paths: a
    NamedTuple field as ".name", a dict key as itself, a list or tuple
    index as its number, joined by "/"."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [""]
    return [f"{name}/{p}" if p else name
            for name, sub in items for p in tree_paths(sub)]


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise across trees of the same structure."""
    leaves, unflatten = tree_flatten(tree)
    others = [tree_leaves(t) for t in rest]
    return unflatten([fn(*xs) for xs in zip(leaves, *others)])


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_mean_clients(tree):
    """Mean over the leading client axis of every leaf."""
    return tree_map(lambda x: torch.mean(x, dim=0), tree)


def round_batches(data, perm_column):
    """Batch `perm[m, i]` for every client m (one synchronous round).

    perm_column: (M,) integer tensor — the i-th column of this epoch's
    permutations. Returns leaves of shape (M, *batch_shape).
    """
    m = perm_column.shape[0]
    arange_m = torch.arange(m, device=perm_column.device)
    return tree_map(lambda leaf: leaf[arange_m, perm_column], data)


def num_clients(data) -> int:
    return tree_leaves(data)[0].shape[0]


def num_batches(data) -> int:
    return tree_leaves(data)[0].shape[1]


def sample_permutations(gen: torch.Generator, m: int, n: int) -> torch.Tensor:
    """Independent per-client permutations of [n] — the 'RR' in Q-RR."""
    return torch.stack([
        torch.randperm(n, generator=gen, device=gen.device) for _ in range(m)
    ])


def clients_grad(loss_fn: LossFn, params, batches):
    """Per-client gradients: vmap(grad) over stacked client batches.

    params are shared (the server iterate); batches leaves are (M, ...).
    Returns a pytree with leaves (M, *param_shape).
    """
    return torch.func.vmap(torch.func.grad(loss_fn), in_dims=(None, 0))(
        params, batches)


def clients_grad_at(loss_fn: LossFn, params_stacked, batches):
    """Per-client gradients at per-client iterates (local methods)."""
    return torch.func.vmap(torch.func.grad(loss_fn))(params_stacked, batches)
