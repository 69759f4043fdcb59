"""The port's kernels and compression backend against the JAX reference.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs both its plain versions (`repro.kernels.ref`) and its Pallas
kernels (interpret mode on the CPU); the port's side runs the wrappers on
CPU tensors, which take the plain versions (`repro_torch.kernels.ref`).

The comparisons are bitwise: the three kernels are element-wise or take an
exact max, and the port keeps the reference's float operation order (f32
scale d/k, separate multiply and add, |x|/scale*s then (sign*q)*(scale/s)).
One exception, with its bound: XLA:CPU contracts `h + alpha * q` into a
fused multiply-add inside a jitted computation, so the reference's Pallas
DIANA update (jitted, interpret mode) rounds once where its own plain
version (op by op) and the port round twice. Against the Pallas side h' and
H' agree within 1 ulp of |h| + |alpha * q| in their dtype (see
`_close_to_fma`); against the plain side, bitwise.

The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression.backend import CompressionBackend as JaxBackend
from repro.compression.ops import QSGDQuantizer as JaxQSGD
from repro.compression.ops import RandK as JaxRandK
from repro.kernels import ref as jref
from repro.kernels.diana_shift import diana_shift_update as jax_diana_shift
from repro.kernels.qsgd import qsgd_quantize as jax_qsgd
from repro.kernels.randk import randk_mask as jax_randk_mask
from repro_torch.compression.backend import (
    CompressionBackend,
    get_backend,
    tree_ravel_clients,
)
from repro_torch.compression.ops import QSGDQuantizer, RandK, TopK
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.diana_shift import diana_shift_update
from repro_torch.kernels.qsgd import TILE, qsgd_quantize
from repro_torch.kernels.randk import randk_mask

JAX_BACKENDS = {"reference": JaxBackend("reference"),
                "pallas": JaxBackend("pallas")}
PORT_BACKENDS = ("reference", "cuda")


def _np(t):
    """A tensor or JAX array as an f32 numpy array (bf16 widens exactly)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.asarray(t, np.float32)


def _same(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def _close_to_fma(got, want, x, y, bf16: bool):
    """got = x + y rounded twice (product, then sum), want = the fused
    multiply-add rounded once: they differ by at most the rounding error of
    the product plus one rounding of the sum, both below 1 ulp of |x| + |y|
    (in the output dtype: bf16's ulp is 2^16 f32 ulps)."""
    g, w = _np(got), _np(want)
    bound = np.spacing(np.abs(_np(x)) + np.abs(_np(y))) * (2.0**16 if bf16 else 1.0)
    assert np.all(np.abs(g - w) <= bound), np.max(np.abs(g - w) / bound)


def _diana_close_to_pallas(got, want, h, qo, mh, qm, alpha, beta, bf16):
    """Direction (no product) bitwise; h' and H' within the FMA bound."""
    beta = alpha if beta is None else beta
    _same(got[0], want[0])
    _close_to_fma(got[1], want[1], h, alpha * _np(qo), bf16)
    _close_to_fma(got[2], want[2], mh, beta * _np(qm), bf16)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a), dtype)


# ---------------------------------------------------------------------------
# randk_mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,dp", [(1024, 1024), (2500, 3072), (130, 1024)])
@pytest.mark.parametrize("k", [1, 13, 100])
def test_randk_mask_matches_reference(d, dp, k):
    k = min(k, d)
    rng = np.random.default_rng(d * 1000 + k)
    x = rng.normal(size=(3, dp)).astype(np.float32)
    x[:, d:] = 0.0  # padding region zero, as callers guarantee
    starts = np.array([0, d - 1, d // 2], np.int32)
    got = randk_mask(_t(x), _t(starts, torch.int32), d=d, k=k)
    _same(got, jref.randk_mask_ref(_j(x), _j(starts, jnp.int32), d=d, k=k))
    _same(got, jax_randk_mask(_j(x), _j(starts, jnp.int32), d=d, k=k))
    nnz = np.count_nonzero(_np(got)[:, :d], axis=1)
    assert np.all(nnz == k)


def test_randk_mask_bf16_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 2048)).astype(np.float32)
    starts = np.array([0, 7, 1999, 1500], np.int32)
    got = randk_mask(_t(x, torch.bfloat16), _t(starts, torch.int32), d=2000,
                     k=37)
    want = jref.randk_mask_ref(_j(x, jnp.bfloat16), _j(starts, jnp.int32),
                               d=2000, k=37)
    assert got.dtype == torch.bfloat16
    _same(got, want)


# ---------------------------------------------------------------------------
# diana_shift_update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [128, 128 * 600, 128 * 600 + 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("beta", [None, 0.0625], ids=["beta_default", "beta"])
def test_diana_shift_matches_reference(n, dtype, beta):
    rng = np.random.default_rng(n)
    arrs = [rng.normal(size=(n,)).astype(np.float32) for _ in range(4)]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = diana_shift_update(*(_t(a, tdt) for a in arrs), alpha=0.11, beta=beta)
    jins = [_j(a, jdt) for a in arrs]
    want_ref = jref.diana_shift_update_ref(*jins, 0.11, beta)
    want_pal = jax_diana_shift(*jins, alpha=0.11, beta=beta)
    for g, wr in zip(got, want_ref):
        assert g.dtype == tdt
        _same(g, wr)
    _diana_close_to_pallas(got, want_pal, *jins, 0.11, beta,
                           dtype == "bfloat16")


@pytest.mark.parametrize("n", [1, 91, 6000])
def test_diana_shift_takes_any_length(n):
    """The update is element-wise: the wrapper takes any N, no padding to
    the reference's 128 lanes (6000 = the w8a round's 20 x 300)."""
    rng = np.random.default_rng(n)
    arrs = [rng.normal(size=(n,)).astype(np.float32) for _ in range(4)]
    got = diana_shift_update(*(_t(a) for a in arrs), alpha=0.3)
    want = jref.diana_shift_update_ref(*(_j(a) for a in arrs), 0.3)
    for g, w in zip(got, want):
        assert g.shape == (n,)
        _same(g, w)


# ---------------------------------------------------------------------------
# qsgd_quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tiles", [1, 3, 16])
@pytest.mark.parametrize("levels", [4, 8, 16])
def test_qsgd_matches_reference(n_tiles, levels):
    rng = np.random.default_rng(n_tiles * levels)
    x = (rng.normal(size=(n_tiles * TILE,)) * 3).astype(np.float32)
    x[:5] = 0.0  # sign(0) = 0
    u = rng.uniform(size=x.shape).astype(np.float32)
    got = qsgd_quantize(_t(x), _t(u), levels=levels)
    _same(got, jref.qsgd_quantize_ref(_j(x), _j(u), levels=levels, tile=TILE))
    _same(got, jax_qsgd(_j(x), _j(u), levels=levels))


def test_qsgd_bf16_matches_reference():
    rng = np.random.default_rng(17)
    x = (rng.normal(size=(3 * TILE,)) * 3).astype(np.float32)
    u = rng.uniform(size=x.shape).astype(np.float32)
    got = qsgd_quantize(_t(x, torch.bfloat16), _t(u), levels=8)
    assert got.dtype == torch.bfloat16
    _same(got, jref.qsgd_quantize_ref(_j(x, jnp.bfloat16), _j(u), levels=8,
                                      tile=TILE))


@pytest.mark.parametrize("d", [300, TILE + 13])
def test_randk_mask_takes_unpadded_rows(d):
    """The simulator passes the unpadded (M, d) matrix: it equals the
    reference's mask over the 1024-padded matrix, trimmed."""
    rng = np.random.default_rng(d)
    dp = -(-d // TILE) * TILE
    x = np.zeros((20, dp), np.float32)
    x[:, :d] = rng.normal(size=(20, d))
    starts = rng.integers(0, d, size=20).astype(np.int32)
    k = max(1, int(0.02 * d))
    got = randk_mask(_t(x[:, :d]), _t(starts, torch.int32), d=d, k=k)
    want = jref.randk_mask_ref(_j(x), _j(starts, jnp.int32), d=d, k=k)
    assert got.shape == (20, d)
    _same(got, np.asarray(want)[:, :d])


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take():
    f, b = torch.zeros(256), torch.zeros(256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):
        diana_shift_update(f, f, b, f, alpha=0.5)
    with pytest.raises(ValueError, match=r"\(N,\)"):
        diana_shift_update(f, f, f, torch.zeros(128), alpha=0.5)
    with pytest.raises(ValueError, match="one dtype"):
        diana_shift_update(*(torch.zeros(128, dtype=torch.float64),) * 4,
                           alpha=0.5)
    with pytest.raises(ValueError, match="N % 1024"):
        qsgd_quantize(torch.zeros(1000), torch.zeros(1000))
    with pytest.raises(ValueError, match="u"):
        qsgd_quantize(torch.zeros(1024), torch.zeros(1024, dtype=torch.float64))
    with pytest.raises(ValueError, match="starts"):
        randk_mask(torch.zeros(2, 1024), torch.zeros(2, dtype=torch.int64),
                   d=1000, k=10)
    with pytest.raises(ValueError, match="k <= d <= Dp"):
        randk_mask(torch.zeros(2, 1024), torch.zeros(2, dtype=torch.int32),
                   d=2000, k=10)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    reset_launches()
    randk_mask(torch.ones(2, 1024), torch.zeros(2, dtype=torch.int32), d=900,
               k=9)
    diana_shift_update(*(torch.ones(128),) * 4, alpha=0.5)
    qsgd_quantize(torch.ones(1024), torch.zeros(1024))
    assert LAUNCHES == {"randk_mask": 0, "diana_shift_update": 0,
                        "qsgd_quantize": 0}


# ---------------------------------------------------------------------------
# the backend's pytree entry points
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 37, 13)).astype(np.float32),
            "b": rng.normal(size=(4, 129)).astype(np.float32)}


def _jax_draws(comp, key, m, d):
    """The draws the reference's compress_clients takes from `key`."""
    if isinstance(comp, JaxRandK):
        return np.array(jax.random.randint(key, (m,), 0, d))
    dp = -(-d // TILE) * TILE
    return np.array(jax.random.uniform(key, (m, dp)))


@pytest.mark.parametrize("comps", [
    (JaxRandK(fraction=0.1), RandK(fraction=0.1)),
    (JaxRandK(k=7), RandK(k=7)),
    (JaxQSGD(levels=8), QSGDQuantizer(levels=8)),
], ids=["randk_frac", "randk_k", "qsgd"])
@pytest.mark.parametrize("jax_be", sorted(JAX_BACKENDS))
@pytest.mark.parametrize("port_be", PORT_BACKENDS)
def test_compress_clients_matches_reference(comps, jax_be, port_be):
    jcomp, tcomp = comps
    tree = _tree(3)
    key = jax.random.key(3)
    want = JAX_BACKENDS[jax_be].compress_clients(
        jcomp, key, {k: jnp.asarray(v) for k, v in tree.items()})
    draws = _jax_draws(jcomp, key, 4, 37 * 13 + 129)
    got = CompressionBackend(port_be).compress_clients(
        tcomp, None, {k: _t(v) for k, v in tree.items()}, torch.from_numpy(draws))
    for name in tree:
        assert got[name].shape == tree[name].shape
        _same(got[name], want[name])


def test_compress_clients_generic_operator_runs_per_client():
    tree = {k: _t(v) for k, v in _tree(4).items()}
    got = CompressionBackend("cuda").compress_clients(TopK(k=5), None, tree)
    mat, _ = tree_ravel_clients(got)
    assert (torch.count_nonzero(mat, dim=1) == 5).all()


@pytest.mark.parametrize("beta", [None, 0.03])
@pytest.mark.parametrize("jax_be", sorted(JAX_BACKENDS))
@pytest.mark.parametrize("port_be", PORT_BACKENDS)
def test_tree_diana_shift_matches_reference(beta, jax_be, port_be):
    trees = [_tree(20 + i) for i in range(4)]
    want = JAX_BACKENDS[jax_be].tree_diana_shift(
        *({k: jnp.asarray(v) for k, v in t.items()} for t in trees),
        alpha=0.17, beta=beta)
    got = CompressionBackend(port_be).tree_diana_shift(
        *({k: _t(v) for k, v in t.items()} for t in trees), alpha=0.17,
        beta=beta)
    for name in ("w", "b"):
        if jax_be == "pallas":  # jitted: XLA:CPU's FMA, see the docstring
            _diana_close_to_pallas([t[name] for t in got],
                                   [t[name] for t in want],
                                   *(t[name] for t in trees), 0.17, beta, False)
        else:
            for g, w in zip(got, want):
                _same(g[name], w[name])


def test_backend_selection(monkeypatch):
    with pytest.raises(ValueError, match="unknown backend"):
        CompressionBackend("pallas")
    monkeypatch.delenv("REPRO_TORCH_COMPRESSION_BACKEND", raising=False)
    assert get_backend().name == "cuda"
    monkeypatch.setenv("REPRO_TORCH_COMPRESSION_BACKEND", "reference")
    assert get_backend().name == "reference"
    assert get_backend("cuda").name == "cuda"


def test_sortfree_randk_window_is_circularly_contiguous():
    """The support is one circular window of k coordinates (wrapping past
    d - 1 back to 0 included) — measured as offsets from the window start,
    which is what makes a wrapped window pass."""
    gen = torch.Generator().manual_seed(0)
    comp = RandK(k=5)
    for _ in range(40):
        q = comp.compress(gen, torch.ones(12))
        (nz,) = np.nonzero(q.numpy())
        assert len(nz) == 5
        start = next(i for i in nz if (i - 1) % 12 not in nz)
        assert sorted((i - start) % 12 for i in nz) == list(range(5))
