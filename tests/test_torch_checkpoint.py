"""The port's checkpoints (`repro_torch.checkpoint`) against the reference's
`repro.checkpoint`: one file format, read by both packages.

A reduced TrainState (diana with f32 shift tables, diana_rr with bf16 ones
and its slot axis; bf16 parameters) filled with seeded random values is
saved by the reference and loaded by the port, and saved by the port and
loaded by the reference: every leaf comes back bitwise, bf16 included, the
port's file is byte-equal to the reference's, and `load_meta` gives the
same dict. The port has no msgpack package; its decoder raises
`CheckpointError` on a file cut at any depth, on non-msgpack bytes and on a
map without a manifest, as the reference's does. Tolerance: exact.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro import checkpoint as jck
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.dist import CompressedAggregation as JAgg
from repro.launch import steps as jsteps
from repro.launch.mesh import make_test_mesh
from repro_torch import checkpoint as ck
from repro_torch.configs import get_config, reduced
from repro_torch.convert import train_state_from_jax
from repro_torch.core.api import tree_leaves, tree_paths
from repro_torch.core.dist import CompressedAggregation
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh

CASES = [("diana", "float32"), ("diana_rr", "bfloat16")]
META = {"data_stream": {"train_step": 3, "epoch": 0, "step": 3,
                        "sampler": {"m": 4, "mode": "rr"}}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.asarray(x).tobytes()


def _random_like(tree, seed):
    """Every leaf of a numpy tree replaced by seeded values of its dtype."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype.kind in "iu":
            return rng.integers(0, 100, x.shape).astype(x.dtype)
        return rng.normal(size=x.shape).astype(np.float32).astype(x.dtype)

    return jax.tree.map(fill, tree)


def _states(method, shift_dtype):
    """(reference TrainState of numpy arrays, the port's meta `like`)."""
    n_slots = 2 if method == "diana_rr" else 1
    jcfg = jreduced(jget_config("stablelm-1.6b"), seq=16)
    jagg = JAgg(method=method, fraction=0.25, n_slots=n_slots,
                shift_dtype=jnp.dtype(shift_dtype))
    jstate = jsteps.init_train_state(
        jax.random.key(0), jcfg, jagg, 4,
        mesh=make_test_mesh((4, 1), ("data", "model")))
    ref = _random_like(jax.device_get(jstate), seed=n_slots)
    cfg = reduced(get_config("stablelm-1.6b"), seq=16)
    agg = CompressedAggregation(method=method, fraction=0.25,
                                n_slots=n_slots,
                                shift_dtype=getattr(torch, shift_dtype))
    like = steps.init_train_state(0, cfg, agg, 4, mesh=make_mesh((4, 1)),
                                  device="meta")
    return ref, like


@pytest.mark.parametrize("method,shift_dtype", CASES)
def test_files_cross_read_bitwise(tmp_path, method, shift_dtype):
    ref, like = _states(method, shift_dtype)
    assert tree_paths(like) == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    jpath, ppath = str(tmp_path / "ref.ckpt"), str(tmp_path / "port.ckpt")
    jck.save_pytree(jpath, ref, step=3, meta=META)

    got = ck.load_pytree(jpath, like, device="cpu")
    want = jax.tree.leaves(ref)
    assert len(tree_leaves(got)) == len(want)
    assert any(x.dtype == torch.bfloat16 for x in tree_leaves(got))
    for g, w in zip(tree_leaves(got), want):
        assert str(g.dtype).removeprefix("torch.") == np.asarray(w).dtype.name
        assert _bits(g) == _bits(w)

    ck.save_pytree(ppath, got, step=3, meta=META)
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    assert ck.load_meta(ppath) == jck.load_meta(jpath) == {
        "step": 3, "meta": META}
    back = jck.load_pytree(ppath, ref, device=False)
    for g, w in zip(jax.tree.leaves(back), want):
        assert g.dtype == np.asarray(w).dtype and _bits(g) == _bits(w)

    # the port's own state (the convert route) round-trips too
    port_state = train_state_from_jax(ref, device="cpu")
    ck.save_pytree(ppath, port_state, step=3, meta=META)
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    restored = ck.restore_train_state(ppath, port_state, "cpu")
    for g, w in zip(tree_leaves(restored), tree_leaves(port_state)):
        assert g.dtype == w.dtype and _bits(g) == _bits(w)


def test_mixed_tree_and_numpy_leaves_round_trip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16) * 1.5,
                  "d": torch.zeros((), dtype=torch.int32)},
            "e": [np.arange(3, dtype=np.int64), np.ones(2, np.float64)]}
    p = str(tmp_path / "ck.msgpack")
    ck.save_pytree(p, tree, step=7)
    got = ck.load_pytree(p, tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        assert type(a) is type(b) and a.dtype == b.dtype
        assert _bits(a) == _bits(b)
    # the reference reads numpy leaves and the bf16 one as ml_dtypes
    jtree = jck.load_pytree(p, {
        "a": np.zeros((3, 4), np.float32),
        "b": {"c": np.zeros(5, ml_dtypes.bfloat16),
              "d": np.zeros((), np.int32)},
        "e": [np.zeros(3, np.int64), np.zeros(2)]}, device=False)
    assert np.asarray(jtree["b"]["c"], np.float32).tolist() == [1.5] * 5


def test_missing_leaf_and_wrong_shape_raise(tmp_path):
    p = str(tmp_path / "ck.msgpack")
    ck.save_pytree(p, {"a": torch.ones(3)})
    with pytest.raises(KeyError):
        ck.load_pytree(p, {"a": torch.ones(3), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        ck.load_pytree(p, {"a": torch.ones(4)})


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_truncated_or_foreign_file_raises_checkpoint_error(tmp_path, writer):
    tree = {"a": torch.arange(64, dtype=torch.float32),
            "b": torch.ones((8, 8), dtype=torch.bfloat16)}
    p = str(tmp_path / "ck.msgpack")
    if writer == "port":
        ck.save_pytree(p, tree, step=3)
    else:
        jck.save_pytree(p, {"a": np.arange(64, dtype=np.float32),
                            "b": np.ones((8, 8), ml_dtypes.bfloat16)}, step=3)
    blob = open(p, "rb").read()
    # inside the buffers, inside the manifest, a nearly-empty file
    for frac in (0.6, 0.25, 0.02):
        with open(p, "wb") as f:
            f.write(blob[:max(1, int(len(blob) * frac))])
        with pytest.raises(ck.CheckpointError, match="truncated or corrupt"):
            ck.load_pytree(p, tree)
    with open(p, "wb") as f:
        f.write(blob + b"\x00")
    with pytest.raises(ck.CheckpointError, match="truncated or corrupt"):
        ck.load_pytree(p, tree)
    with open(p, "wb") as f:
        f.write(b"\x00not a checkpoint\xff" * 7)
    with pytest.raises(ck.CheckpointError):
        ck.load_meta(p)
    with open(p, "wb") as f:
        f.write(msgpack.packb({"something": "else"}))
    with pytest.raises(ck.CheckpointError, match="no manifest"):
        ck.load_meta(p)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_headers_match_msgpack(n):
    """Each str, bin and array header the encoder writes is msgpack's."""
    s = "x" * n
    assert ck.io._pack_str(s) == msgpack.packb(s)
    assert ck.io._bin_header(n) + b"y" * n == msgpack.packb(b"y" * n)
    assert ck.io._array_header(n) == msgpack.packb([0] * n)[:len(
        ck.io._array_header(n))]


def test_tree_paths_spell_the_reference_key_paths():
    """NamedTuple fields as ".name", dict keys, list indices; None and ()
    hold no leaves."""
    tree = steps.TrainState({"w": 1, "l": [2, {"z": 3}]}, None, None, 4)
    assert tree_paths(tree) == [".params/l/0", ".params/l/1/z", ".params/w",
                                ".step"]
