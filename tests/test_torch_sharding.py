"""The port's model-axis specs (`repro_torch.launch.sharding`) against the
reference's `launch/sharding.py`.

For every one of the ten configs' full-size parameter trees (the port's on
the "meta" device, the reference's from `jax.eval_shape`), at model sizes
1, 2 and 16, on a flat and a two-pod mesh: the axis of each leaf that the
port splits over "model" is the index of "model" in the reference's
PartitionSpec, for `param_specs`, `shifts_specs` (with and without a slot
axis), `podded_specs` and `slotted_specs`. The reference's rules read only
the mesh's "model" size, so a stand-in mesh of that size serves for 16
shards on 8 host devices. Exact: the specs are integers.

Then the rules' corners on named leaves: hymba's 25 heads fall back to
the last axis, a leaf that divides on no candidate axis is replicated, and
the replicated names stay whole whatever their shape.
"""
import types

import jax
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jax_sharding
from repro.models import transformer as jax_transformer
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.api import tree_leaves, tree_paths
from repro_torch.launch import sharding
from repro_torch.models import transformer

MODEL_SIZES = (1, 2, 16)
MESHES = {"flat": (("data",), ()), "2pod": (("pod", "data"), ("pod",))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _stand_in(model: int):
    return types.SimpleNamespace(shape={"model": model})


def _model_index(spec) -> int | None:
    """The axis of a PartitionSpec that "model" splits, or None."""
    hits = [i for i, e in enumerate(spec) if e == "model"]
    assert len(hits) <= 1, spec
    return hits[0] if hits else None


def _flat_specs(tree) -> list:
    return [_model_index(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


_TREES = {}


def _trees(name):
    if name not in _TREES:
        _TREES[name] = (
            transformer.init_params(0, get_config(name), "meta"),
            jax.eval_shape(lambda: jax_transformer.init_params(
                jax.random.key(0), jax_get_config(name))))
    return _TREES[name]


@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_specs_equal_reference(name, model):
    ours, theirs = _trees(name)
    mesh = _stand_in(model)
    paths = tree_paths(ours)
    assert len(paths) == len(jax.tree.leaves(theirs))
    got = sharding.param_specs(ours, mesh=mesh)
    assert list(got) == paths
    assert list(got.values()) == _flat_specs(
        jax_sharding.param_specs(theirs, mesh=mesh))
    for caxes, paxes in MESHES.values():
        for ns in (0, 2):
            for port, ref, lead in (
                    (sharding.shifts_specs, jax_sharding.shifts_specs, caxes),
                    (sharding.podded_specs, jax_sharding.podded_specs,
                     paxes or caxes)):
                assert list(port(ours, mesh=mesh, n_slots=ns).values()) == \
                    _flat_specs(ref(theirs, lead, mesh=mesh, n_slots=ns))
            assert list(sharding.slotted_specs(
                ours, mesh=mesh, n_slots=ns).values()) == _flat_specs(
                jax_sharding.slotted_specs(theirs, mesh=mesh, n_slots=ns))
    # the split axis in param coordinates, as the wire takes it
    axes = sharding.split_axes(ours, model)
    assert axes == tuple(got.values())
    for leaf, ax in zip(tree_leaves(ours), axes):
        if ax is not None:
            assert leaf.shape[ax] % model == 0


def test_production_mesh_splits_the_big_leaves():
    """At the production mesh's 16 shards (a mesh of None, as the
    reference's default) stablelm-1.6b's embedding splits its vocab, the
    attention's wq its heads' columns and w_down its rows; the norms stay
    whole."""
    ours, _ = _trees("stablelm-1.6b")
    specs = sharding.param_specs(ours)
    names = sharding.leaf_names(ours)
    by_name = {}
    for n, ax in zip(names, specs.values()):
        by_name.setdefault(n, set()).add(ax)
    assert by_name["embed"] == {0} and by_name["lm_head"] == {0}
    assert by_name["wq"] == {2} and by_name["w_down"] == {1}
    assert by_name["scale"] == {None}


@pytest.mark.parametrize("model", (2, 4))
def test_rule_corners_equal_reference(model):
    """hymba's per-head u (25 heads) falls back to its last axis; a
    per-head leaf whose axes both fail, a column leaf whose last axis does
    not divide, and a vocab leaf of odd rows are replicated; a replicated
    name stays whole though it divides; an unnamed leaf stays whole."""
    shapes = {"u": (2, 25, 64), "ln": (2, 25, 3), "wq": (2, 16, 15),
              "embed": (101, 8), "scale": (2, 64), "other": (8, 8),
              "bq": (64,)}
    ours = {k: torch.zeros(v, device="meta") for k, v in shapes.items()}
    theirs = {k: jax.ShapeDtypeStruct(v, np.float32)
              for k, v in shapes.items()}
    mesh = _stand_in(model)
    got = sharding.param_specs(ours, mesh=mesh)
    want = dict(zip(sorted(shapes), _flat_specs(
        jax_sharding.param_specs(theirs, mesh=mesh))))
    assert got == want
    assert got == {"bq": 0, "embed": None, "ln": None, "other": None,
                   "scale": None, "u": 2, "wq": None}


def test_leaf_names_read_the_last_dict_key():
    """A leaf's name is its last dict key: list indices and tuple members
    do not name it, a NamedTuple field does."""
    from repro_torch.optim.optimizers import AdamState

    tree = {"blocks": {"attn": {"wq": 1, "wo": 2}}, "layers": [3, {"u": 4}],
            "opt": AdamState(mu={"w": 5}, nu=6, count=7)}
    assert sharding.leaf_names(tree) == ["wo", "wq", "layers", "u", "w",
                                         "nu", "count"]


# a process's DIANA state on the production meshes at one cell a process
# (256 and 512 processes): its shards of the bf16 parameters and of its
# client's and the mean's f32 shift tables (on two pods also its pod's and
# the pods' mean tables) (bytes, from this test)
PRODUCTION_STATE = {"qwen2.5-32b": (20_483_614_724, 36_870_506_500),
                    "deepseek-67b": (42_155_294_724, 75_879_530_500),
                    "dbrx-132b": (82_302_197_764, 148_137_664_516)}


@pytest.mark.parametrize("name", sorted(PRODUCTION_STATE))
def test_production_mesh_state_a_process(name):
    """The three configurations no card has trained, on the reference's
    production meshes (16, 16) and (2, 16, 16) spread one (client, model
    shard) a process: each process holds 1/16 of every split leaf of the
    parameters and of its client's and the mean's shift tables. The
    compute-sharded step (dense and moe: `launch.train.reckon`) adds its
    client's gradient shards (1/16 of the parameters' bytes), the
    activations of its shards of one client's forward and backward and
    the wire's f32 transients (six f32 copies of its largest leaf shard);
    the whole parameters gathered and a whole gradient, twice the
    parameters' bytes, are gone.

    The verdicts on the H100's 80 GB (79.18 GiB usable), at the
    reference's production batch (train_4k: 256 sequences of 4,096 tokens,
    16 a client on (16, 16), 8 on (2, 16, 16)): state, gradient shards
    and wire transients fit a process for qwen2.5-32b on (16, 16) and
    (2, 16, 16) (38.17 and 54.56 GB) and for deepseek-67b on (16, 16)
    (76.29 GB), not for deepseek-67b on (2, 16, 16) (110.01 GB, the
    two-pod tables added) nor for any dbrx-132b layout (its state alone
    is 82.30 GB a process on (16, 16)); with the activations of one
    client none of the three fits either mesh. The remat stash of every
    block's input and the final norm's is split over the sequence
    (`seq_shard`, the trainer's default): 256 of the 4,096 rows a
    process, 2.73 GB for qwen2.5-32b on (16, 16) where the whole stash
    was 43.62 GB; what is left of the activations is mostly the head's
    logits over the process's vocab shard and one block's attention
    probabilities. A process's totals: qwen2.5-32b 121.58 and 96.26 GB,
    deepseek-67b 101.20 and 122.47 GB, dbrx-132b 179.94 and 236.90 GB
    on (16, 16) and (2, 16, 16), the H100 holding 85.02 GB."""
    from repro.configs.shapes import INPUT_SHAPES
    from repro_torch.launch import train

    cfg = get_config(name)
    shape = INPUT_SHAPES["train_4k"]
    card = int(79.18 * 2**30)
    params = sum(x.numel() * x.element_size()
                 for x in tree_leaves(transformer.init_params(0, cfg,
                                                              "meta")))
    fits = {}
    for i, multi in enumerate((False, True)):
        args = train.build_parser().parse_args([
            "--arch", name, "--multi-pod" if multi else "--production-mesh",
            "--batch", str(shape.global_batch), "--seq", str(shape.seq_len)])
        terms = train.reckon(cfg, train.train_mesh(args), args)
        assert terms["parameters"] + terms["tables"] == \
            PRODUCTION_STATE[name][i]
        # its one client's gradient: its shards of the split leaves, the
        # rest (norms, the router) whole
        assert terms["gradients"] == terms["parameters"] < params / 15
        assert "gathered weights" not in terms
        # the stash over the process's 256 rows of the sequence
        rows = shape.global_batch // (32 if multi else 16)
        split = train.stash_bytes(cfg, rows, shape.seq_len, 16, 1)
        assert split == (cfg.num_layers + 1) * rows * 256 * cfg.d_model * 2
        assert train.stash_bytes(cfg, rows, shape.seq_len, 16, 1,
                                 seq_shard=False) == 16 * split
        total = sum(terms.values())
        fits[multi] = (total - terms["activations"] < card, total < card)
    assert fits == {
        "qwen2.5-32b": {False: (True, False), True: (True, False)},
        "deepseek-67b": {False: (True, False), True: (False, False)},
        "dbrx-132b": {False: (False, False), True: (False, False)}}[name]
