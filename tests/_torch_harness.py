"""Helpers shared by the port's tests against the reference: the train
steps' (tests/test_torch_steps.py, tests/test_torch_family_steps.py,
tests/test_torch_nastya.py) and serving's (tests/test_torch_serving.py,
tests/test_torch_serve_tp.py; the former explains the tolerances)."""
import numpy as np


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


def prompt(inputs, n, framework):
    """The first n tokens of `inputs` (and its patches or frames) as the
    framework's tensors."""
    if framework == "torch":
        import torch

        conv = torch.from_numpy
    else:
        import jax.numpy as jnp

        conv = jnp.asarray
    return {k: conv(v[:, :n] if k == "tokens" else v)
            for k, v in inputs.items()}


def close(got, want, what, tol=1e-2):
    """got within tol of want's largest entry; returns the relative error."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + 1e-7, (
        f"{what}: worst error {err:.3e} against {tol} x {scale:.3e}")
    return err / max(scale, 1e-30)


def close_cache(got, want, what):
    """Every leaf of the port's cache, layer by layer, against the
    reference's; layer 0's attention k and v at rtol 1e-5."""
    import jax

    from repro_torch.core.api import tree_leaves

    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    mine = tree_leaves(got)
    assert len(mine) == len(leaves)
    worst = 0.0
    for g, (path, w) in zip(mine, leaves):
        key = jax.tree_util.keystr(path)
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and \
            str(g.dtype).split(".")[-1] == str(w.dtype), key
        for layer in range(w.shape[0]):
            worst = max(worst, close(g[layer], w[layer],
                                     f"{what} {key} layer {layer}"))
        if key in ("['mixer'].k", "['mixer'].v", "['mixer'].attn.k",
                   "['mixer'].attn.v"):
            np.testing.assert_allclose(
                g[0].numpy(), w[0], rtol=1e-5,
                atol=1e-6 * float(np.abs(w[0]).max()), err_msg=key)
    return worst


def one_intra_op_thread():
    """One intra-op thread while a module's tests run (the body of an
    autouse module fixture): their ops are small, several test processes
    share the host, and more threads only contend (with 5 of 8 cores busy,
    one trainer test took 41 s on 8 threads, 7.5 s on one). The thread
    count leaves no mark on these tests' results: they hold the port to
    the reference within tolerances, or two computations in one process,
    or processes that run on one thread each, to each other."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
