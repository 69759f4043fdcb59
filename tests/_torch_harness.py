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


KV_KEYS = ("['mixer'].k", "['mixer'].v", "['mixer'].attn.k",
           "['mixer'].attn.v")
U = 2.0 ** -24  # the f32 unit roundoff


def layer0_kv_bounds(cfg, params, inputs, writes, cache):
    """{cache path: bound} for layer 0's attention k and v of the port's
    `cache` after it took `writes`, (position, input column) in the order
    written (a ring's slot pos % window, else pos clamped to the last):
    element by element, what two f32 implementations of the same
    projection may differ by,

        |dk| <= u (4 K + 3 p + 4) R(|h| @ |wk| + |bk|),
        |dv| <= u 4 K (|h| @ |wv| + |bv|),

    u = 2^-24, K = d_model (the projection's summation length), h the
    layer's normed input, p the largest rotary angle written (position
    times the highest frequency, 1), R the rotation's mixing of each
    element with its pair (a_i + a_pair; the identity without RoPE).
    c = 4 of K: each side's dot product lies within gamma_K ~ K u of
    sum |h w| (either summation order, blocked or not, with or without
    FMA), and each side's h within about (K / 2 + 4) u of |h| (the norm's
    mean over K, its rsqrt, two products), which |w| carries into the
    sum. RoPE adds its angle's rounding (3 u p: the frequency's power
    and reciprocal, the product by the position) and its sin, cos and
    rotation roundings (4 u) on R(|k|) <= R(A)."""
    import torch

    from repro_torch.core.api import tree_paths
    from repro_torch.models import layers as tl
    from repro_torch.models import transformer as tt

    def f64(x):
        return x.detach().to(torch.float64)

    blocks = params["blocks"]
    mixer = blocks["mixer"]["attn"] if "attn" in blocks["mixer"] \
        else blocks["mixer"]
    n = max(col for _, col in writes) + 1
    batch = {k: torch.from_numpy(np.asarray(v[:, :n] if k == "tokens"
                                            else v))
             for k, v in inputs.items()}
    tokens = batch["tokens"].long()
    table = params.get("pos_embed")
    if table is not None:  # the learned rows, clamped past the table
        x0 = torch.stack([params["embed"][tokens[:, col]]
                          + table[min(pos, table.shape[0] - 1)]
                          for pos, col in writes], 1)
    else:
        x0 = tt._embed_inputs(params, batch, cfg, tokens)[
            :, [col for _, col in writes]]
    h = f64(tl.norm(x0, {k: v[0] for k, v in blocks["ln1"].items()},
                    cfg.norm)).abs()
    rotary = cfg.mrope_sections is not None or cfg.rope_theta > 0
    angle = max(pos for pos, _ in writes) + (
        tt.mrope_grid(cfg) if cfg.mrope_sections is not None else 0)
    k_dim = cfg.d_model
    out = {}
    # "mixer/.attn/.k" -> "['mixer'].attn.k", as jax's keystr spells it
    paths = ["['{}']{}".format(*p.split("/", 1)).replace("/", "")
             for p in tree_paths(cache)]
    for path, leaf in zip(paths, tt.tree_leaves(cache)):
        if path not in KV_KEYS:
            continue
        w = "wk" if path.endswith("k") else "wv"
        bias = mixer.get("b" + w[1:])
        a = tl.linear(h, f64(mixer[w][0]).abs(),
                      None if bias is None else f64(bias[0]).abs())
        a = a.reshape(a.shape[0], a.shape[1], cfg.num_kv_heads, -1)
        c = 4 * k_dim
        if w == "wk" and rotary:
            half = a.shape[-1] // 2
            a = a + torch.cat([a[..., half:], a[..., :half]], -1)
            c += 3 * angle + 4
        cap = leaf.shape[2]
        window = cfg.sliding_window
        bound = torch.zeros(leaf.shape[1:], dtype=torch.float64)
        for j, (pos, _) in enumerate(writes):
            slot = pos % cap if window is not None else min(pos, cap - 1)
            bound[:, slot] = U * c * a[:, j]
        out[path] = bound.numpy()
    return out


def close_cache(got, want, what, bounds):
    """Every leaf of the port's cache, layer by layer, against the
    reference's; layer 0's attention k and v element by element within
    `bounds` (`layer0_kv_bounds`)."""
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
        if key in KV_KEYS:
            diff = np.abs(g[0].numpy().astype(np.float64) - w[0])
            over = diff > bounds[key]
            assert not over.any(), (
                f"{what} {key} layer 0: {int(over.sum())} elements past "
                f"the bound, worst {diff[over].max():.3e} against "
                f"{bounds[key][over][np.argmax(diff[over])]:.3e}")
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
