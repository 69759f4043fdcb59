"""The port's wire on the "model" axis (2-way tensor parallelism) against
the JAX reference's `CompressedAggregation.aggregate`, on the harness of
tests/test_torch_wire.py.

The reference runs inside a fully-manual shard_map on forced host devices
over its (4, 2), (2, 2, 2) and (1, 4, 2) meshes, the gradients split over
"model" by its `param_specs`: each model shard compresses its own block.
The port runs the four ranks stacked on one device and compresses each
split leaf shard by shard, with the reference's draws injected from a
shard's geometry (the window start and the rounding uniforms, or the
independent wire's indices, one draw a leaf, as the reference's shards
draw from one key). The gradients name every model-axis rule: a column
leaf (wq), a row leaf of stacked layers (wo, whose shard's rows
interleave), the vocab leaf (embed), a per-head leaf whose 5 heads fall
back to the last axis (u), a 1-D column leaf (bq) and a replicated one
(scale).

Every method (q, diana, diana_rr, ef) on the shared wire at f32, at 7
levels, bf16, packed8 and packed4, on the independent wire, and with the
elastic weights (1, 0, 0.5, 1), to tests/test_torch_wire.py's tolerances:
bitwise for q and ef on the unquantized f32 and bf16 wires, else 8 ulps of
each leaf's largest value. Then claims on the port alone: (1, 4, 2) gives
(4, 2)'s bits (the claim the reference's mesh_1x4x2 fixture makes), the
unit weights give the unweighted wire's bits, and the split leaves are
compressed per shard where the whole-leaf wire differs.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro_torch.core.api import tree_leaves
from repro_torch.core.dist import CompressedAggregation
from repro_torch.launch.sharding import split_axes

_spec = importlib.util.spec_from_file_location(
    "torch_wire_harness", Path(__file__).with_name("test_torch_wire.py"))
harness = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(harness)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 forced host devices")

METHODS, MODEL_GRADS, SLOTS = (harness.METHODS, harness.MODEL_GRADS,
                               harness.SLOTS)
MESHES = harness.MODEL_MESHES
CASES = [(shape, m, w, lv) for shape in MESHES for m in METHODS
         for w, lv in harness.WIRES]
TRANSPORT_CASES = [(shape, m, dt) for shape in MESHES for m in METHODS
                   for dt in ("bf16", "packed8", "packed4")]
WEIGHTED_CASES = [((4, 2), "shared", "f32"), ((4, 2), "independent", "f32"),
                  ((2, 2, 2), "shared", "packed8")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _id(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize(
    "shape,method,wire,levels", CASES,
    ids=[f"{_id(s)}-{m}-{w}{'-L' + str(lv) if lv else ''}"
         for s, m, w, lv in CASES])
def test_model_axis_wire_matches_reference_aggregate(shape, method, wire,
                                                     levels):
    want = harness._jax_directions(shape, wire, levels)[method]
    agg = harness._aggs(wire, levels, False)[METHODS.index(method)]
    got = harness._port_directions(dataclasses.replace(agg, backend="cuda"),
                                   shape)
    harness._hold_to_reference(got, want,
                               exact=method in ("q", "ef") and levels is None)


@pytest.mark.parametrize(
    "shape,method,wire_dtype", TRANSPORT_CASES,
    ids=[f"{_id(s)}-{m}-{dt}" for s, m, dt in TRANSPORT_CASES])
def test_model_axis_transports_match_reference_aggregate(shape, method,
                                                         wire_dtype):
    want = harness._jax_directions(shape, "shared", None, wire_dtype)[method]
    agg = harness._aggs("shared", None, False, wire_dtype)[
        METHODS.index(method)]
    got = harness._port_directions(agg, shape)
    harness._hold_to_reference(
        got, want, exact=method in ("q", "ef") and wire_dtype == "bf16")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize(
    "shape,wire,wire_dtype", WEIGHTED_CASES,
    ids=[f"{_id(s)}-{w}-{dt}" for s, w, dt in WEIGHTED_CASES])
def test_model_axis_weighted_wire_matches_reference_aggregate(
        shape, wire, wire_dtype, method):
    want = harness._jax_directions(shape, wire, None, wire_dtype,
                                   weighted=True)[method]
    agg = harness._aggs(wire, None, False, wire_dtype)[METHODS.index(method)]
    got = harness._port_directions(agg, shape,
                                   weight=torch.from_numpy(harness.WEIGHTS))
    harness._hold_to_reference(got, want, exact=method in ("q", "ef")
                               and wire_dtype in ("f32", "bf16"))


@pytest.mark.parametrize("wire_dtype", ["f32", "bf16", "packed8", "packed4"])
@pytest.mark.parametrize("shape", MESHES, ids=map(_id, MESHES))
def test_model_axis_unit_weights_are_the_unweighted_wire(shape, wire_dtype):
    """x * 1.0 is exact shard by shard too."""
    agg = CompressedAggregation(method="diana_rr", fraction=0.3,
                                n_slots=SLOTS, shift_dtype=torch.float32,
                                wire_dtype=wire_dtype)
    want, ws = harness._port_directions(
        agg, shape, torch.Generator().manual_seed(4), inject=False,
        with_state=True)
    got, gs = harness._port_directions(
        agg, shape, torch.Generator().manual_seed(4), inject=False,
        weight=torch.ones(harness.RANKS), with_state=True)
    harness._hold_to_reference(got, want, exact=True)
    for a, b in zip(tree_leaves(gs), tree_leaves(ws)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wire_dtype", ["f32", "packed8"])
@pytest.mark.parametrize("method", METHODS)
def test_one_pod_model_mesh_bit_matches_flat(method, wire_dtype):
    """The claim the reference's mesh_1x4x2 fixture makes, on the port:
    the (1, 4, 2) two-level wire gives the (4, 2) flat wire's directions
    and tables bit for bit, shard by shard."""
    agg = CompressedAggregation(method=method, fraction=0.25, n_slots=SLOTS,
                                shift_dtype=torch.float32,
                                wire_dtype=wire_dtype)
    flat = harness._port_directions(agg, (4, 2),
                                    torch.Generator().manual_seed(3),
                                    inject=False, with_state=True)
    two = harness._port_directions(agg, (1, 4, 2),
                                   torch.Generator().manual_seed(3),
                                   inject=False, with_state=True)
    for k in MODEL_GRADS:
        np.testing.assert_array_equal(flat[0][k], two[0][k], err_msg=k)
    fs, ts = flat[1], two[1]
    if fs is not None:
        for a, b in zip(tree_leaves((fs.shifts, fs.mean_shift)),
                        tree_leaves((ts.shifts, ts.mean_shift))):
            assert torch.equal(a, b.reshape(a.shape))


@pytest.mark.parametrize("wire_dtype", ["f32", "packed8"])
@pytest.mark.parametrize("method", ["q", "diana"])
def test_model_mesh_differs_from_whole_leaves(method, wire_dtype):
    """T = 2 compresses every split leaf shard by shard. On the f32 wire a
    column split (wq; u, whose 5 heads do not split in two, on its last
    axis) keeps the rows, so its windows and means are the whole leaf's,
    bit for bit, and so is the replicated scale's; a row split (wo, embed,
    the 1-D bq) changes each shard's rows and window. On the packed8 wire
    the scales are each shard's own and every split leaf differs."""
    agg = CompressedAggregation(method=method, fraction=0.3, n_slots=SLOTS,
                                shift_dtype=torch.float32,
                                wire_dtype=wire_dtype)
    whole = harness._port_directions(agg, (4, 1),
                                     torch.Generator().manual_seed(3),
                                     inject=False, arrays=MODEL_GRADS)
    split = harness._port_directions(agg, (4, 2),
                                     torch.Generator().manual_seed(3),
                                     inject=False)
    axes = dict(zip(sorted(MODEL_GRADS),
                    split_axes(harness.params_of(MODEL_GRADS), 2)))
    assert axes == {"bq": 0, "embed": 0, "scale": None, "u": 1, "wo": 1,
                    "wq": 2}
    same = ("wq", "u", "scale") if wire_dtype == "f32" else ()
    for k in MODEL_GRADS:
        if k in same:
            np.testing.assert_array_equal(whole[k], split[k], err_msg=k)
        elif axes[k] is not None:
            assert not np.array_equal(whole[k], split[k]), k
