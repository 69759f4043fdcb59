"""Helpers shared by the port's train-step tests against the reference
(tests/test_torch_steps.py, tests/test_torch_family_steps.py,
tests/test_torch_nastya.py)."""


def shard_shapes(params, model: int) -> list:
    """Each parameter leaf's shape on one of `model` shards (the port's
    split axes, which tests/test_torch_sharding.py holds to the
    reference's): the geometry the reference's wire draws from."""
    from repro_torch.core.api import tree_leaves
    from repro_torch.launch.sharding import split_axes

    axes = (split_axes(params, model) if model > 1
            else [None] * len(tree_leaves(params)))
    return [tuple(d // model if i == ax else d for i, d in enumerate(p.shape))
            for p, ax in zip(tree_leaves(params), axes)]
