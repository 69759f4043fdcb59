"""The port's production wire (`repro_torch.core.dist`) against the JAX
reference's `CompressedAggregation.aggregate`.

The reference runs inside a fully-manual shard_map on forced host devices,
on flat (4, 1) and two-pod (2, 2, 1) meshes (the meshes with 2-way tensor
parallelism are tests/test_torch_axis_wire.py's, on this file's harness).
The port runs the same four ranks stacked on one device, with the draws of
the reference's key schedule injected: per leaf i the window start
randint(fold_in(key, i), (), 0, nb) and the rounding uniforms from
fold_in(leaf key, WIRE_QUANT_SALT); the pod level folds POD_KEY_SALT into
the round key; the independent wire folds the rank's pod and data indices
into the leaf key. On a model mesh every draw is made from a shard's
geometry (nb and the uniforms' columns of the shard's row view) and every
shard of a leaf uses it, as the reference's shards draw from one key; its
gradients (MODEL_GRADS) are named so that every model-axis rule applies.
Gradients are fixed f32 arrays made with numpy.

The transports 'bf16', 'packed8' and 'packed4' and the elastic per-rank
weights (1, 0, 0.5, 1) are held the same way. XLA:CPU computes a bf16
pmean by summing the ranks' bf16 values in f32 in rank order and rounding
the sum to bf16 (found with this file's meshes, ROADMAP Queue C); the port's
`bf16_level_mean` does the same.

Tolerance: bitwise for 'q' and 'ef' on the unquantized f32 and bf16 wires,
whose arithmetic is the same operations in the same order on both sides.
The DIANA methods differ by XLA's fused multiply-add in h + alpha * q (the
reference's jitted update rounds once, the port twice; ROADMAP Queue C) and
the quantized and packed wires by XLA's reciprocal in the scale amax / L
(bytes equal, scales within one ulp): those are held to 8 ulps of the
leaf's largest value (measured worst: 2 ulps).

The rest holds the claims of the reference's tests/test_dist.py and
tests/test_pod_wire.py on the port with its own draws.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core.dist import CompressedAggregation as JaxAgg
from repro.core.salts import POD_KEY_SALT, WIRE_QUANT_SALT
from repro.launch import compat
from repro.launch import sharding as jax_sharding
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import configure_agg as jax_configure_agg
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_config
from repro_torch.core.api import tree_leaves
from repro_torch.core.dist import CompressedAggregation
from repro_torch.data.logreg import make_federated_logreg
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import split_axes
from repro_torch.launch.steps import configure_agg
from repro_torch.models import transformer

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 forced host devices")

RANKS, ROUNDS, SLOTS = 4, 3, 2
METHODS = ("q", "diana", "diana_rr", "ef")
WIRES = (("shared", None), ("shared", 7), ("independent", None))
MESHES = ((4, 1), (2, 2, 1))
# 2-way tensor parallelism: tests/test_torch_axis_wire.py runs them
MODEL_MESHES = ((4, 2), (2, 2, 2), (1, 4, 2))
_rng = np.random.default_rng(0)
GRADS = {"b": _rng.standard_normal((RANKS, 7)).astype(np.float32),
         "w": _rng.standard_normal((RANKS, 3, 4, 6)).astype(np.float32)}
# the model meshes' leaves: every rule of the model axis once (the window
# scales nb/kb of the whole leaves and of their shards are powers of two,
# so that error feedback's unscaling is exact on both sides)
MODEL_GRADS = {
    "wq": _rng.standard_normal((RANKS, 2, 16, 24)).astype(np.float32),
    "wo": _rng.standard_normal((RANKS, 2, 32, 16)).astype(np.float32),
    "embed": _rng.standard_normal((RANKS, 64, 8)).astype(np.float32),
    "u": _rng.standard_normal((RANKS, 5, 6)).astype(np.float32),
    "bq": _rng.standard_normal((RANKS, 12)).astype(np.float32),
    "scale": _rng.standard_normal((RANKS, 7)).astype(np.float32)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def grads_of(shape) -> dict:
    """The gradients a mesh's cases exchange: the named model-axis leaves
    on the meshes with tensor parallelism."""
    return MODEL_GRADS if shape[-1] > 1 else GRADS


def params_of(grads) -> dict:
    """One rank's parameter shapes (meta tensors) of a gradient dict."""
    return {k: torch.zeros(v.shape[1:], device="meta")
            for k, v in grads.items()}


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


WEIGHTS = np.array([1.0, 0.0, 0.5, 1.0], np.float32)


def _aggs(wire, levels, jax_side: bool, wire_dtype="f32"):
    kw = dict(wire=wire, fraction=0.3, n_slots=SLOTS, wire_levels=levels,
              wire_dtype=wire_dtype)
    if jax_side:
        return [JaxAgg(method=m, shift_dtype=jnp.float32, **kw) for m in METHODS]
    return [CompressedAggregation(method=m, shift_dtype=torch.float32, **kw)
            for m in METHODS]


_JAX_CACHE = {}


def _jax_directions(shape, wire, levels, wire_dtype="f32", weighted=False):
    """Rank 0's direction of each round, for the four methods, computed in
    one jitted shard_map program per (mesh, wire, levels, transport,
    weights)."""
    key = (shape, wire, levels, wire_dtype, weighted)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    grads = grads_of(shape)
    mesh = make_test_mesh(shape, _axes(shape))
    aggs = [jax_configure_agg(a, mesh)
            for a in _aggs(wire, levels, True, wire_dtype)]
    caxes = tuple(n for n in mesh.axis_names if n != "model")
    pspecs = jax_sharding.param_specs(
        {k: jax.ShapeDtypeStruct(v.shape[1:], jnp.float32)
         for k, v in grads.items()}, mesh=mesh)
    specs = {k: P(caxes, *pspecs[k]) for k in grads}

    def body(g, w):
        g = jax.tree.map(lambda x: x[0], g)
        outs = []
        for agg in aggs:
            def one(state, inp):
                t, slot = inp
                d, state = agg.aggregate(
                    g, state, jax.random.fold_in(jax.random.key(0), t),
                    slot=slot, weight=w[0] if weighted else None)
                return state, d

            _, ds = jax.lax.scan(one, agg.init(g), (
                jnp.arange(ROUNDS), jnp.arange(ROUNDS, dtype=jnp.int32) % SLOTS))
            outs.append(jax.tree.map(lambda x: x[None], ds))
        return outs

    out_specs = [{k: P(caxes, None, *pspecs[k]) for k in grads}] * len(aggs)
    fn = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(specs, P(caxes)),
                                  out_specs=out_specs,
                                  axis_names=set(mesh.axis_names),
                                  check_vma=False))
    out = fn({k: jnp.asarray(v) for k, v in grads.items()},
             jnp.asarray(WEIGHTS))
    _JAX_CACHE[key] = {m: {k: np.asarray(v)[0] for k, v in o.items()}
                       for m, o in zip(METHODS, out)}
    return _JAX_CACHE[key]


def _rows(shape):
    return (int(np.prod(shape[:-1])), shape[-1]) if len(shape) >= 2 else (
        int(np.prod(shape)), 1)


def _shard_shape(name, agg, grads):
    """A leaf's (one rank's) shape on one model shard."""
    shape = list(grads[name].shape[1:])
    if agg.model_size > 1:
        ax = agg.model_axes[sorted(grads).index(name)]
        if ax is not None:
            shape[ax] //= agg.model_size
    return tuple(shape)


def _reference_draws(agg, round_key, pods: int, grads=GRADS):
    """The draws the reference makes for one aggregate() call, from each
    leaf's shard geometry (`agg` configured for the mesh)."""
    per_pod = RANKS // pods
    out = {"inner": [], "outer": []}
    levels = (("inner", round_key, range(RANKS)),
              ("outer", jax.random.fold_in(round_key, POD_KEY_SALT),
               range(pods)))
    for level, key, ranks in levels:
        if level == "outer" and pods == 1:
            continue
        for i, name in enumerate(sorted(grads)):
            n, d = _rows(_shard_shape(name, agg, grads))
            leaf_key = jax.random.fold_in(key, i)
            if agg.wire == "shared":
                nb = (n + (-n) % 8) // 8
                kb = max(1, int(agg.fraction * nb))
                draw = {"start": int(jax.random.randint(leaf_key, (), 0, nb))}
                if agg._quant_levels is not None:
                    draw["quant_u"] = np.array(jax.random.uniform(
                        jax.random.fold_in(leaf_key, WIRE_QUANT_SALT),
                        (kb * 8, d)))
            else:  # fold the rank's axis indices, pod before data
                k = max(1, int(agg.fraction * n))
                idx = []
                for r in ranks:
                    rk = leaf_key
                    if level == "inner" and agg.pod_axes:
                        rk = jax.random.fold_in(rk, r // per_pod)
                    rk = jax.random.fold_in(
                        rk, r % per_pod if level == "inner" else r)
                    idx.append(np.asarray(jax.random.randint(rk, (k,), 0, n)))
                draw = {"idx": np.stack(idx)}
            out[level].append(draw)
    return out


def _port_directions(agg, shape, gen=None, inject=True, weight=None,
                     rounds=ROUNDS, with_state=False, arrays=None):
    pods = shape[0] if len(shape) == 3 else 1
    arrays = grads_of(shape) if arrays is None else arrays
    agg = configure_agg(agg, make_mesh(shape, _axes(shape)),
                        params=params_of(arrays))
    grads = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    state = agg.init({k: v[0] for k, v in grads.items()}, RANKS)
    out = []
    for t in range(rounds):
        draws = (_reference_draws(agg, jax.random.fold_in(jax.random.key(0), t),
                                  pods, arrays) if inject else None)
        d, state = agg.aggregate(grads, state, gen, slot=t % SLOTS,
                                 draws=draws, weight=weight)
        out.append(d)
    dirs = {k: torch.stack([d[k] for d in out]).numpy() for k in arrays}
    return (dirs, state) if with_state else dirs


CASES = [(shape, m, w, lv) for shape in MESHES for m in METHODS
         for w, lv in WIRES]


@pytest.mark.parametrize(
    "shape,method,wire,levels", CASES,
    ids=[f"{'x'.join(map(str, s))}-{m}-{w}{'-L' + str(lv) if lv else ''}"
         for s, m, w, lv in CASES])
def test_wire_matches_reference_aggregate(shape, method, wire, levels):
    want = _jax_directions(shape, wire, levels)[method]
    agg = _aggs(wire, levels, False)[METHODS.index(method)]
    got = _port_directions(dataclasses.replace(agg, backend="cuda"), shape)
    for k in want:
        if method in ("q", "ef") and levels is None:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            bound = 8 * np.spacing(np.float32(np.abs(want[k]).max()))
            assert np.abs(got[k] - want[k]).max() <= bound, k


def _hold_to_reference(got, want, exact: bool):
    for k in want:
        if exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            bound = 8 * np.spacing(np.float32(np.abs(want[k]).max()))
            assert np.abs(got[k] - want[k]).max() <= bound, k


TRANSPORT_CASES = [(shape, m, dt) for shape in MESHES for m in METHODS
                   for dt in ("bf16", "packed8", "packed4")]


@pytest.mark.parametrize(
    "shape,method,wire_dtype", TRANSPORT_CASES,
    ids=[f"{'x'.join(map(str, s))}-{m}-{dt}" for s, m, dt in TRANSPORT_CASES])
def test_transports_match_reference_aggregate(shape, method, wire_dtype):
    """The bf16 and packed transports against the reference's, three
    rounds: bitwise for the memory-free and error-feedback methods on bf16,
    else within the module's 8-ulp bound."""
    want = _jax_directions(shape, "shared", None, wire_dtype)[method]
    agg = _aggs("shared", None, False, wire_dtype)[METHODS.index(method)]
    got = _port_directions(agg, shape)
    _hold_to_reference(got, want,
                       exact=method in ("q", "ef") and wire_dtype == "bf16")


WEIGHTED_CASES = [((4, 1), "shared", "f32"), ((4, 1), "independent", "f32"),
                  ((4, 1), "shared", "packed8"), ((2, 2, 1), "shared", "bf16"),
                  ((2, 2, 1), "shared", "packed4")]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize(
    "shape,wire,wire_dtype", WEIGHTED_CASES,
    ids=[f"{'x'.join(map(str, s))}-{w}-{dt}" for s, w, dt in WEIGHTED_CASES])
def test_weighted_wire_matches_reference_aggregate(shape, wire, wire_dtype,
                                                   method):
    """The elastic weights (1, 0, 0.5, 1) against the reference's
    `aggregate(..., weight=)`: the weight folds into the f32 slab, the
    independent wire's reconstruction, the bf16 values and the packed
    scales at the points the reference folds it. Tolerance as the
    unweighted wires'."""
    want = _jax_directions(shape, wire, None, wire_dtype, weighted=True)[method]
    agg = _aggs(wire, None, False, wire_dtype)[METHODS.index(method)]
    got = _port_directions(agg, shape, weight=torch.from_numpy(WEIGHTS))
    _hold_to_reference(got, want, exact=method in ("q", "ef")
                       and wire_dtype in ("f32", "bf16"))


@pytest.mark.parametrize("wire_dtype", ["f32", "bf16", "packed8", "packed4"])
@pytest.mark.parametrize("shape", MESHES)
def test_unit_weights_are_the_unweighted_wire(shape, wire_dtype):
    """x * 1.0 is exact: all-ones weights give the unweighted wire bit for
    bit (the elastic step's promise for full participation)."""
    agg = CompressedAggregation(method="diana_rr", fraction=0.3,
                                n_slots=SLOTS, shift_dtype=torch.float32,
                                wire_dtype=wire_dtype)
    want, ws = _port_directions(agg, shape, torch.Generator().manual_seed(4),
                                inject=False, with_state=True)
    got, gs = _port_directions(agg, shape, torch.Generator().manual_seed(4),
                               inject=False, weight=torch.ones(RANKS),
                               with_state=True)
    _hold_to_reference(got, want, exact=True)
    for a, b in zip(tree_leaves(gs), tree_leaves(ws)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", METHODS)
def test_one_pod_two_level_bit_matches_flat(method):
    """A single pod has no inter-pod link: the outer exchange is the exact
    identity and the inner one draws what the flat wire draws."""
    agg = CompressedAggregation(method=method, fraction=0.25, n_slots=SLOTS,
                                shift_dtype=torch.float32)
    flat = _port_directions(agg, (4, 1), torch.Generator().manual_seed(3),
                            inject=False)
    two = _port_directions(agg, (1, 4, 1), torch.Generator().manual_seed(3),
                           inject=False)
    for k in flat:
        np.testing.assert_array_equal(flat[k], two[k], err_msg=k)


def test_two_pod_wire_differs_from_flat():
    agg = CompressedAggregation(method="q", fraction=0.25)
    flat = _port_directions(agg, (4, 1), torch.Generator().manual_seed(3),
                            inject=False)
    two = _port_directions(agg, (2, 2, 1), torch.Generator().manual_seed(3),
                           inject=False)
    assert any(not np.array_equal(flat[k], two[k]) for k in GRADS)


@pytest.mark.parametrize("method,wire,wire_dtype,pods", [
    ("diana", "shared", "f32", 1), ("q", "shared", "f32", 1),
    ("diana_rr", "shared", "f32", 2), ("ef", "shared", "f32", 2),
    ("diana", "independent", "f32", 2), ("dense", "shared", "f32", 1),
    ("diana", "shared", "packed8", 2), ("q", "shared", "packed4", 1),
    ("diana", "shared", "bf16", 1)])
def test_wire_bytes_per_round_match_reference(method, wire, wire_dtype, pods):
    """The accounting authority agrees with the reference's for the
    full-width stablelm-1.6b tree (bf16 leaves, shapes only)."""
    kw = dict(method=method, wire=wire, wire_dtype=wire_dtype,
              fraction=0.02, pod_fraction=0.05, n_slots=2)
    if pods > 1:
        kw.update(client_axes=("data",), pod_axes=("pod",), pod_size=pods)
    jparams = jax.eval_shape(lambda: jax_transformer.init_params(
        jax.random.key(0), jax_get_config("stablelm-1.6b")))
    want = JaxAgg(**kw).wire_bytes_per_round(jparams)
    params = transformer.init_params(0, get_config("stablelm-1.6b"), "meta")
    assert CompressedAggregation(**kw).wire_bytes_per_round(params) == want


def test_unported_transports_raise():
    """Every transport is ported; what the wire still refuses is what the
    reference refuses: a quantized or packed slab on the independent wire
    (it moves dense leaves), levels on bf16, levels past the lane's
    lattice, a transport on the dense method, and per-group slots that do
    not give each group one."""
    with pytest.raises(ValueError, match="shared wire"):
        CompressedAggregation(method="q", wire="independent", wire_levels=7)
    with pytest.raises(ValueError, match="shared wire"):
        CompressedAggregation(method="diana", wire="independent",
                              wire_dtype="packed8")
    with pytest.raises(ValueError, match="ambiguous"):
        CompressedAggregation(method="diana", wire_dtype="bf16",
                              wire_levels=7)
    with pytest.raises(ValueError, match="overflows"):
        CompressedAggregation(method="diana", wire_dtype="packed4",
                              wire_levels=8)
    with pytest.raises(ValueError, match="dense"):
        CompressedAggregation(method="dense", wire_dtype="packed8")
    agg = configure_agg(CompressedAggregation(method="diana_rr", n_slots=3,
                                              wire_dtype="packed8"),
                        make_mesh((2, 2, 1), _axes((2, 2, 1))))
    grads = {k: torch.from_numpy(v.copy()) for k, v in GRADS.items()}
    state = agg.init({k: v[0] for k, v in grads.items()}, RANKS)
    with pytest.raises(ValueError, match="one slot per group"):
        agg.aggregate(grads, state, torch.Generator(), slot=[0, 1, 2])


# ---------------------------------------------------------------------------
# the claims of tests/test_pod_wire.py on the transports, on the port
# ---------------------------------------------------------------------------

def _rounds_state(agg, shape, rounds, seed=0):
    return _port_directions(agg, shape, torch.Generator().manual_seed(seed),
                            inject=False, rounds=rounds, with_state=True)


def _bitwise(a, b):
    (da, sa), (db, sb) = a, b
    for k in GRADS:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    for x, y in zip(tree_leaves(sa), tree_leaves(sb)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("method", ["q", "diana", "diana_rr"])
def test_packed8_bit_matches_f32_wire(method):
    """The port's copy of tests/test_pod_wire.py::
    test_packed8_bit_matches_f32_wire: moving the byte lattice instead of
    the decoded f32 slab changes nothing, directions and shift tables
    bitwise, over five rounds (the same draws: both quantize at 127
    levels)."""
    base = CompressedAggregation(method=method, fraction=0.25, n_slots=3,
                                 shift_dtype=torch.float32, wire_levels=127)
    packed = dataclasses.replace(base, wire_dtype="packed8", wire_levels=None)
    _bitwise(_rounds_state(base, (4, 1), 5), _rounds_state(packed, (4, 1), 5))


def test_packed8_bit_matches_f32_wire_two_pod():
    """... and with both wire levels live (2 pods x 2 clients)."""
    base = CompressedAggregation(method="diana_rr", fraction=0.25, n_slots=2,
                                 shift_dtype=torch.float32, wire_levels=127)
    packed = dataclasses.replace(base, wire_dtype="packed8", wire_levels=None)
    _bitwise(_rounds_state(base, (2, 2, 1), 4),
             _rounds_state(packed, (2, 2, 1), 4))


def test_packed4_bit_matches_f32_wire():
    """The nibble lane at its cap L = 7, bitwise to the f32 wire at 7."""
    base = CompressedAggregation(method="diana", fraction=0.25,
                                 shift_dtype=torch.float32, wire_levels=7)
    packed = dataclasses.replace(base, wire_dtype="packed4", wire_levels=None)
    _bitwise(_rounds_state(base, (4, 1), 3), _rounds_state(packed, (4, 1), 3))


def test_bf16_wire_close_to_f32():
    """The port's copy of tests/test_pod_wire.py::
    test_bf16_wire_close_to_f32: bf16 is lossy, so one round's direction
    sits within 1e-2 of the f32 wire's largest entry (relative), and the
    rounding is real: somewhere the two differ."""
    base = CompressedAggregation(method="diana", fraction=0.25,
                                 shift_dtype=torch.float32)
    want, _ = _rounds_state(base, (4, 1), 1)
    got, _ = _rounds_state(dataclasses.replace(base, wire_dtype="bf16"),
                           (4, 1), 1)
    rel = {k: float(np.abs(got[k] - want[k]).max()
                    / (np.abs(want[k]).max() + 1e-12)) for k in GRADS}
    assert all(r < 1e-2 for r in rel.values()), rel
    assert max(rel.values()) > 0, rel


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_bf16_pmean_equals_level_mean(ranks):
    """The reference's `lax.pmean` of bf16 values over R ranks of forced
    host devices equals `bf16_level_mean` bitwise, R a power of two or not
    (R = 3: the sum's division by R is not exact), for values spanning
    1e-3 to 1e3."""
    from repro_torch.compression.backend import bf16_level_mean

    rng = np.random.default_rng(ranks)
    mags = 10.0 ** rng.uniform(-3, 3, (ranks, 4096))
    x = (rng.standard_normal((ranks, 4096)) * mags).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:ranks]), ("r",))
    fn = jax.jit(compat.shard_map(
        lambda v: jax.lax.pmean(v, "r"), mesh=mesh, in_specs=P("r"),
        out_specs=P("r"), axis_names={"r"}, check_vma=False))
    want = np.asarray(fn(xb)).view(np.uint16)  # every rank's row: the mean
    got = bf16_level_mean(torch.from_numpy(x).to(torch.bfloat16), dim=0)
    got = got.view(torch.int16).numpy().view(np.uint16)
    for r in range(ranks):
        assert np.array_equal(want[r], got)


# ---------------------------------------------------------------------------
# the claims of tests/test_dist.py, on the port
# ---------------------------------------------------------------------------

DIST_GRADS = {"w": torch.arange(4 * 64, dtype=torch.float32).reshape(4, 64)
              / 100.0, "b": torch.ones(4, 8)}
DIST_MEAN = {k: v.mean(0) for k, v in DIST_GRADS.items()}


def _rounds(agg, rounds, grads=None, reduce="last", seed=0):
    """The last direction ("last"), the mean of all ("mean"), or the
    running mean after every round ("trace": {t: running mean})."""
    grads = DIST_GRADS if grads is None else grads
    agg = configure_agg(agg, make_mesh((4, 1)))
    state = agg.init({k: v[0] for k, v in grads.items()}, 4)
    gen = torch.Generator().manual_seed(seed)
    acc = {k: torch.zeros_like(v[0]) for k, v in grads.items()}
    trace = {}
    for t in range(1, rounds + 1):
        d, state = agg.aggregate(grads, state, gen)
        acc = {k: acc[k] + d[k] for k in acc}
        trace[t] = {k: v / t for k, v in acc.items()}
    return {"last": d, "mean": trace[rounds], "trace": trace}[reduce]


def test_dense_is_exact_mean():
    got = _rounds(CompressedAggregation(method="dense"), 1)
    for k in DIST_GRADS:
        torch.testing.assert_close(got[k], DIST_MEAN[k], rtol=1e-6, atol=0)


def test_diana_shared_converges_to_exact_mean():
    """Fixed gradients: the shifts absorb them and the direction reaches the
    exact mean (Theorem 2's fixed point on the production wire)."""
    got = _rounds(CompressedAggregation(method="diana", fraction=0.25,
                                        shift_dtype=torch.float32), 200)
    for k in DIST_GRADS:
        torch.testing.assert_close(got[k], DIST_MEAN[k], rtol=0, atol=1e-5)


def test_diana_independent_converges():
    got = _rounds(CompressedAggregation(method="diana", wire="independent",
                                        fraction=0.5,
                                        shift_dtype=torch.float32), 300)
    for k in DIST_GRADS:
        torch.testing.assert_close(got[k], DIST_MEAN[k], rtol=0, atol=5e-2)


def test_q_shared_unbiased():
    """The mean of many Q-rounds approaches the true mean."""
    got = _rounds(CompressedAggregation(method="q", fraction=0.25), 2000,
                  reduce="mean")
    for k in DIST_GRADS:
        scale = float(DIST_MEAN[k].abs().max())
        assert float((got[k] - DIST_MEAN[k]).abs().max()) < 0.15 * scale + 0.05


def test_shift_lr_default_matches_theory():
    assert abs(CompressedAggregation(fraction=0.02).shift_lr - 0.02) < 1e-9
    assert CompressedAggregation(fraction=0.25, alpha=0.1).shift_lr == 0.1


def _logreg_grads():
    prob = make_federated_logreg(m=4, n_batches=2, batch=4, d=64, cond=50.0,
                                 seed=1, device="cpu")
    loss = prob.loss_fn()
    w0 = {"w": torch.zeros(prob.d)}
    a, y = prob.data["a"], prob.data["y"]
    grads = torch.stack([torch.func.grad(loss)(
        w0, {"a": a[m].reshape(-1, prob.d), "y": y[m].reshape(-1)})["w"]
        for m in range(4)])
    return {"w": grads}, grads.mean(0)


def test_ef_wire_running_mean_error_falls_like_one_over_t():
    """Error feedback: the residual memory telescopes, sum_t d_t = T * mean
    - e_T, so the running mean of the directions misses the exact mean by
    exactly ||e_T|| / T, and e_T is a bounded, stationary residual. Averaged
    over 16 independent wires (one draw of e_T says little: its size varies
    tenfold between seeds), four times the rounds cut the error at least
    threefold (1/T gives 4x; measured 4.1x-4.7x on three disjoint batches of
    16 seeds, where the memory-free 'q' wire's 1/sqrt(T) noise gave
    1.7x-2.6x)."""
    grads, mean = _logreg_grads()
    agg = CompressedAggregation(method="ef", fraction=0.25,
                                shift_dtype=torch.float32)
    err = {50: 0.0, 200: 0.0}
    for seed in range(16):
        d = _rounds(agg, 200, grads, reduce="trace", seed=seed)
        for t in err:
            err[t] += float((d[t]["w"] - mean).abs().max()) / 16
    assert err[200] * 3 <= err[50], err
