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

The wire's five kernels (randk_compress, randk_decompress, pack_slab,
unpack_slab, unpack_reduce) are compared the same way: bitwise against both
of the reference's sides, except one rounding inside the reference's jitted
Pallas pack_slab, where XLA:CPU divides amax by L as a multiply by 1/L
(ROADMAP Queue C): its scales are held within one ulp, its bytes bitwise.
unpack_reduce divides by the rank count R: at R = 2 and 4, the counts the
tests use, that division is exact whichever way it is computed.

The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro.compression.backend import CompressionBackend as JaxBackend
from repro.compression.ops import QSGDQuantizer as JaxQSGD
from repro.compression.ops import RandK as JaxRandK
from repro.kernels import ref as jref
from repro.kernels.diana_shift import diana_shift_update as jax_diana_shift
from repro.kernels.qsgd import qsgd_quantize as jax_qsgd
from repro.kernels.pack import pack_slab as jax_pack_slab
from repro.kernels.pack import unpack_reduce as jax_unpack_reduce
from repro.kernels.pack import unpack_slab as jax_unpack_slab
from repro.kernels.randk import randk_compress as jax_randk_compress
from repro.kernels.randk import randk_decompress as jax_randk_decompress
from repro.kernels.randk import randk_mask as jax_randk_mask
from repro_torch.compression.backend import (
    CompressionBackend,
    get_backend,
    tree_ravel_clients,
)
from repro_torch.compression.ops import QSGDQuantizer, RandK, TopK
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.diana_shift import diana_shift_update
from repro_torch.kernels.pack import pack_slab, unpack_reduce, unpack_slab
from repro_torch.kernels.qsgd import TILE, qsgd_quantize
from repro_torch.kernels.randk import randk_compress, randk_decompress, randk_mask

JAX_BACKENDS = {"reference": JaxBackend("reference"),
                "pallas": JaxBackend("pallas")}
PORT_BACKENDS = ("reference", "cuda")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


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


def _edge_starts(m, d, k):
    """Starts spread over [0, d) (every start when m == d), led by a window
    that ends at d, one that wraps by one column, and d - 1."""
    starts = (np.arange(m) * max(1, d // m)) % d
    if m < d:
        starts[:3] = [d - k, (d - k + 1) % d, d - 1]
    return starts.astype(np.int32)


# the edges of the kernel's lanes (dp, d, k, offset of the view): odd Dp, a
# view off the 16-byte grid, every start of a short row (one value a lane),
# windows wrapping across 16-byte lanes, k == d, windows ending at d
MASK_EDGES = [(1001, 1001, 20, 0), (1024, 1024, 37, 1), (64, 61, 13, 0),
              (1024, 1021, 13, 0), (1024, 1024, 1024, 0),
              (1024, 1001, 1001, 0), (1024, 1001, 9, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dp,d,k,offset", MASK_EDGES)
def test_randk_mask_lane_edges_match_reference(dtype, dp, d, k, offset):
    """Against the reference's plain version and its Pallas kernel (on the
    rows padded to its 128-lane tiling)."""
    m = min(d, 64)
    x = np.random.default_rng(dp + k).standard_normal(m * dp + offset)
    x = x.astype(np.float32)
    starts = _edge_starts(m, d, k)
    xt = _t(x).to(getattr(torch, dtype))[offset:].view(m, dp)
    got = randk_mask(xt, _t(starts, torch.int32), d=d, k=k)
    jx = _j(x[offset:].reshape(m, dp), getattr(jnp, dtype))
    js = _j(starts, jnp.int32)
    _same(got, jref.randk_mask_ref(jx, js, d=d, k=k))
    padded = jnp.pad(jx, ((0, 0), (0, -dp % 128)))
    _same(got, np.asarray(jax_randk_mask(padded, js, d=d, k=k)
                          .astype(jnp.float32))[:, :dp])


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
    start = torch.tensor(1, dtype=torch.int32)
    vals = randk_compress(torch.ones(4, 16, 3), start, k_blocks=1)
    randk_decompress(vals, start, n_rows=16)
    packed, scales = pack_slab(vals, torch.zeros(8, 3), levels=7)
    unpack_slab(packed, scales, levels=7, n_rows=8)
    unpack_reduce(packed, scales, levels=7, n_rows=8)
    assert set(LAUNCHES) == {"randk_mask", "diana_shift_update",
                             "qsgd_quantize", "randk_compress",
                             "randk_decompress", "pack_slab", "unpack_slab",
                             "unpack_reduce"}
    assert not any(LAUNCHES.values())


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
    """The `backend=` argument is the only selector: an environment variable
    of the old name (or the reference's) changes nothing."""
    with pytest.raises(ValueError, match="unknown backend"):
        CompressionBackend("pallas")
    monkeypatch.setenv("REPRO_TORCH_COMPRESSION_BACKEND", "reference")
    monkeypatch.setenv("REPRO_COMPRESSION_BACKEND", "reference")
    assert get_backend().name == "cuda"
    assert get_backend(None).name == "cuda"
    assert get_backend("reference").name == "reference"
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


# ---------------------------------------------------------------------------
# the wire's kernels
# ---------------------------------------------------------------------------

WIRE_ROWS = [(64, 33, 3, 7), (8, 5, 1, 0), (96, 16, 12, 5), (40, 128, 5, 4),
             (64, 25, 3, 7), (32, 60, 4, 1)]  # hymba's wdt and the router's D


@pytest.mark.parametrize("n,d,kb,start", WIRE_ROWS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_randk_compress_decompress_match_reference(n, d, kb, start, dtype):
    """Windows that wrap (start + kb > nb), one block (kb == nb), odd D;
    f32 against both reference sides, bf16 against the Pallas kernel (its
    plain version multiplies in bf16, the kernel in f32 as the port does)."""
    x = np.random.default_rng(n + d).standard_normal((n, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    rows = _t(x).to(tdt)
    jrows = jnp.asarray(x).astype(getattr(jnp, dtype))
    s = torch.tensor(start, dtype=torch.int32)
    js = jnp.int32(start)
    vals = randk_compress(rows, s, k_blocks=kb)
    dense = randk_decompress(vals, s, n_rows=n)
    jvals = jax_randk_compress(jrows, js, k_blocks=kb, interpret=True)
    _same(vals, jvals)
    _same(dense, jax_randk_decompress(jvals, js, n_rows=n, interpret=True))
    if dtype == "float32":
        _same(vals, jref.randk_compress_ref(jrows, js, k_blocks=kb,
                                            block_rows=8))
        _same(dense, jref.randk_decompress_ref(jvals, js, n_rows=n,
                                               block_rows=8))
    # a stack of ranks shares the window: one call, each slab as alone
    stack = torch.stack([rows, 2 * rows])
    torch.testing.assert_close(randk_compress(stack, s, k_blocks=kb)[1],
                               randk_compress(2 * rows, s, k_blocks=kb),
                               rtol=0, atol=0)


@pytest.mark.parametrize("k,d,levels,nibble", [
    (16, 33, 127, False), (13, 40, 127, False), (13, 40, 7, True),
    (24, 5, 7, False), (6, 9, 3, True)])
def test_pack_unpack_match_reference(k, d, levels, nibble):
    """Bytes bitwise against both sides (padding rows included); scales
    bitwise against the plain version and within one ulp of the jitted
    Pallas kernel; the decode bitwise on the same bytes and scales."""
    rng = np.random.default_rng(k * d)
    x = (rng.standard_normal((k, d)) * 3).astype(np.float32)
    x[1] = 0.0  # an all-zero row
    u = rng.random((k, d)).astype(np.float32)
    packed, scales = pack_slab(_t(x), _t(u), levels=levels, nibble=nibble)
    jp, js = jax_pack_slab(jnp.asarray(x), jnp.asarray(u), levels=levels,
                           nibble=nibble, interpret=True)
    rp, rs = jref.pack_slab_ref(jnp.asarray(x), jnp.asarray(u), levels=levels,
                                nibble=nibble)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(rp))
    _same(scales, rs)
    ulps = np.abs(scales.numpy().view(np.int32) - np.asarray(js).view(np.int32))
    assert ulps.max() <= 1
    got = unpack_slab(torch.from_numpy(np.array(jp)), _t(np.array(js)),
                      levels=levels, n_rows=k, nibble=nibble)
    _same(got, jax_unpack_slab(jp, js, levels=levels, n_rows=k, nibble=nibble,
                               interpret=True))
    _same(got, jref.unpack_slab_ref(jp, js, levels=levels, n_rows=k,
                                    nibble=nibble))
    # ranks stacked on a leading dim pack as each would alone
    sp, ss = pack_slab(torch.stack([_t(x), -_t(x)]), _t(u), levels=levels,
                       nibble=nibble)
    one_p, one_s = pack_slab(-_t(x), _t(u), levels=levels, nibble=nibble)
    assert torch.equal(sp[1], one_p) and torch.equal(ss[1], one_s)


# pack_slab's variants and rank counts: (ranks, or None for one slab; k, d,
# levels, nibble, dtype, offset of the view)
PACK_EDGES = [
    (4, 64, 2048, 127, False, "bfloat16", 0),
    (4, 64, 2048, 7, True, "bfloat16", 0),
    (None, 24, 2048, 127, False, "float32", 0),
    (1, 24, 5632, 127, False, "float32", 0),
    (8, 40, 2048, 127, False, "float32", 0),
    (8, 37, 2048, 7, True, "float32", 0),  # odd K, nibble
    (4, 13, 1002, 127, False, "float32", 0),  # D % 4 != 0
    (4, 16, 2048, 127, False, "float32", 1),  # a view off the 16-byte grid
    (4, 16, 2048, 7, True, "bfloat16", 3),
    (2, 10, 20000, 127, False, "float32", 0),  # past the register variant
    (2, 10, 20000, 7, True, "float32", 0),
    (2, 10, 16384, 127, False, "float32", 0),  # the register variant's widest
    (2, 10, 8192, 7, True, "float32", 0),
    (2, 9, 5632, 7, True, "bfloat16", 0),
]


@pytest.mark.parametrize("ranks,k,d,levels,nibble,dtype,offset", PACK_EDGES)
def test_pack_slab_edges_match_reference(ranks, k, d, levels, nibble, dtype,
                                         offset):
    """Each rank of the stack packs as the reference packs its one slab:
    bytes bitwise against its plain version and its Pallas kernel, scales
    bitwise against the plain version and within one ulp of the kernel
    (XLA:CPU's 1/L, see the module note)."""
    lead = () if ranks is None else (ranks,)
    rng = np.random.default_rng(k * d + levels)
    x = (rng.standard_normal(k * d * (ranks or 1) + offset) * 3)
    x = x.astype(np.float32)
    u = rng.random((k, d)).astype(np.float32)
    vals = _t(x).to(getattr(torch, dtype))[offset:].view(*lead, k, d)
    vals[..., 1, :] = 0.0  # an all-zero row
    packed, scales = pack_slab(vals, _t(u), levels=levels, nibble=nibble)
    slabs = vals.reshape(-1, k, d)
    packed, scales = packed.reshape(len(slabs), -1, d), scales.reshape(
        len(slabs), -1, 1)
    for r, slab in enumerate(slabs):
        jv = jnp.asarray(slab.float().numpy()).astype(getattr(jnp, dtype))
        rp, rs = jref.pack_slab_ref(jv, jnp.asarray(u), levels=levels,
                                    nibble=nibble)
        jp, js = jax_pack_slab(jv, jnp.asarray(u), levels=levels,
                               nibble=nibble, interpret=True)
        np.testing.assert_array_equal(packed[r].numpy(), np.asarray(rp))
        np.testing.assert_array_equal(packed[r].numpy(), np.asarray(jp))
        _same(scales[r], rs)
        ulps = np.abs(scales[r].numpy().view(np.int32)
                      - np.asarray(js).view(np.int32))
        assert ulps.max() <= 1


def test_wrappers_pick_the_kernels_variants():
    """The wrappers choose each kernel's variant from shape and alignment
    alone: 16-byte lanes or units where rows and pointers allow (for
    diana_shift_update 16 bytes on the wider side of each dtype pair),
    registers or the wide rows for pack_slab."""
    from repro_torch.kernels.pack import _pack_plan
    from repro_torch.kernels.randk import _mask_lane_values

    def mask(m, dp, dtype, offset=0):
        x = torch.empty(m * dp + offset, dtype=dtype)[offset:].view(m, dp)
        return _mask_lane_values(x, torch.empty_like(x))

    f32, bf16 = torch.float32, torch.bfloat16
    assert mask(20, 300, f32) == 1  # w8a: a short row, one value a lane
    assert mask(20, 512, f32) == 1
    assert mask(20, 516, f32) == 4
    assert mask(20, 1024, bf16) == 8
    assert mask(20, 1001, f32) == 1  # rows off the 16-byte grid
    assert mask(20, 1024, f32, offset=1) == 1

    def plan(d, dtype=f32, nibble=False, offset=0):
        flat = torch.empty(4 * 8 * d + offset, dtype=dtype)
        vals = flat[offset:].view(4, 8, d)
        packed = torch.empty(4, 4 if nibble else 8, d, dtype=torch.uint8)
        return _pack_plan(vals, torch.empty(8, d), packed, nibble)

    # (vec, units a thread, threads); 0 units = the wide variant
    assert plan(2048) == (1, 2, 256)  # the wire's widths
    assert plan(2048, nibble=True) == (1, 2, 256)
    assert plan(5632) == (1, 4, 352)
    assert plan(2048, bf16) == (1, 1, 256)
    assert plan(2048, offset=1) == (0, 8, 256)  # unaligned: one value a unit
    assert plan(1002) == (0, 4, 256)  # D % 4 != 0
    assert plan(16384) == (1, 8, 512)
    assert plan(16384, nibble=True) == (1, 0, 512)
    assert plan(20000) == (1, 0, 512)
    assert plan(20000, nibble=True) == (1, 0, 512)
    assert plan(8192, nibble=True) == (1, 4, 512)
    assert plan(4100, bf16) == (0, 0, 512)

    from repro_torch.kernels.pack import _reduce_unit
    from repro_torch.kernels.randk import _block_lane_values

    def lanes(d, dtype=f32, offset=0, block_rows=8):
        flat = torch.empty(2 * 16 * d + offset, dtype=dtype)
        vals = flat[offset:].view(2, 16, d)
        return _block_lane_values(vals, torch.empty(2, 64, d, dtype=dtype),
                                       block_rows)

    # 16-byte lanes over whole 8-row blocks: 8 * D * itemsize is a multiple
    # of 16 for every D, odd D included
    for d in (2048, 1408, 25, 60, 33, 5, 1):
        assert lanes(d) == 4 and lanes(d, bf16) == 8
    assert lanes(25, offset=1) == 1  # vals off the 16-byte grid
    assert lanes(2048, bf16, offset=3) == 1
    assert lanes(2048, offset=4) == 4  # 16 bytes on: back on the grid
    assert lanes(25, block_rows=2) == 1  # 2 * 25 * 4 bytes: no whole lane
    assert lanes(25, bf16, block_rows=4) == 1
    assert lanes(26, block_rows=2) == 4
    # randk_compress moves the rows into the slab on the same lanes: (N, D)
    # and stacked rows, odd D, rows off the grid
    for lead in ((), (3,)):
        for d in (2048, 25, 60, 33, 5, 1):
            for dtype, v in ((f32, 4), (bf16, 8)):
                rows = torch.empty(*lead, 64, d, dtype=dtype)
                slab = torch.empty(*lead, 24, d, dtype=dtype)
                assert _block_lane_values(rows, slab, 8) == v
    rows = torch.empty(3 * 64 * 25 + 1)[1:].view(3, 64, 25)
    assert _block_lane_values(rows, torch.empty(3, 24, 25), 8) == 1

    from repro_torch.kernels.diana_shift import _shift_lane_values

    def shift(h_shape, hd=f32, qd=f32, offset=0, off=None):
        """diana_shift_update's lane values; `off` names the one input
        `offset` elements off the 16-byte grid (all four when None)."""
        m_shape = h_shape if len(h_shape) == 1 else (h_shape[0], h_shape[2])
        ins = []
        for i, (shape, dtype) in enumerate(((h_shape, hd), (h_shape, qd),
                                             (m_shape, hd), (m_shape, qd))):
            o = offset if off in (None, i) else 0
            n = int(np.prod(shape))
            ins.append(torch.empty(n + o, dtype=dtype)[o:].view(shape))
        return _shift_lane_values(ins, [torch.empty_like(t) for t in ins],
                                  h_shape[-1])

    # 16 bytes on the wider side: 4 values when either side is f32, 8 when
    # both are bf16, wherever n and every pointer allow
    for hd, qd, v in ((f32, f32, 4), (bf16, f32, 4), (f32, bf16, 4),
                      (bf16, bf16, 8)):
        assert shift((6000,), hd, qd) == v
        assert shift((1, 4, 100352 * 8), hd, qd) == v  # the train leaves
        assert shift((2, 2, 1000), hd, qd) == v
        assert shift((1,), hd, qd) == 1  # n = 1
        assert shift((1001,), hd, qd) == 1  # n % 4 != 0
        assert shift((1, 3, 1003), hd, qd) == 1
        assert shift((4096,), hd, qd, offset=1) == 1  # off the 16-byte grid
        for i in range(4):  # any one input off the grid
            assert shift((1, 4, 4096), hd, qd, offset=1, off=i) == 1
    assert shift((1004,), bf16, bf16) == 1  # n % 8 != 0
    assert shift((1004,), bf16, f32) == 4
    assert shift((4096,), offset=4) == 4  # 16 bytes on: back on the grid
    assert shift((4096,), bf16, bf16, offset=4) == 1  # 8 bytes on

    def unit(d, offset=0):
        flat = torch.empty(4 * 16 * d + offset, dtype=torch.uint8)
        packed = flat[offset:].view(4, 16, d)
        return _reduce_unit(packed, torch.empty(16, d))

    # (packed bytes a thread takes): 8 on the 8-byte grid, 4 on the 4-byte
    # grid, else 1
    assert [unit(d) for d in (2048, 1408, 5632, 64, 60, 25, 1003, 8)] == [
        8, 8, 8, 8, 4, 1, 1, 8]
    assert unit(2048, offset=8) == 8
    assert unit(2048, offset=4) == 4 and unit(60, offset=4) == 4
    assert unit(2048, offset=1) == 1 and unit(60, offset=2) == 1


def test_wire_wrappers_reject_what_the_kernels_do_not_take():
    x, s = torch.zeros(16, 4), torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="rows % 8"):
        randk_compress(torch.zeros(12, 4), s, k_blocks=1)
    with pytest.raises(ValueError, match="k_blocks"):
        randk_compress(x, s, k_blocks=3)
    with pytest.raises(ValueError, match="int32"):
        randk_compress(x, torch.tensor(0), k_blocks=1)
    with pytest.raises(ValueError, match="n_rows"):
        randk_decompress(x, s, n_rows=12)
    with pytest.raises(ValueError, match="levels"):
        pack_slab(x, torch.zeros(16, 4), levels=8, nibble=True)
    with pytest.raises(ValueError, match="u"):
        pack_slab(x, torch.zeros(16, 5), levels=7)
    with pytest.raises(ValueError, match="scales"):
        unpack_slab(torch.zeros(8, 4, dtype=torch.uint8), torch.zeros(16, 1),
                    levels=7, n_rows=8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        randk_compress(x.to("meta"), s.to("meta"), k_blocks=1)


def test_diana_shift_groups_match_per_rank_reference():
    """The wire's layout: a group's C ranks beside the group's one mean
    table, bf16 tables beside f32 messages: each rank's h' is the
    reference's plain update of that rank, the direction and H' the
    group's."""
    rng = np.random.default_rng(7)
    h, qo = (rng.standard_normal((2, 3, 50)).astype(np.float32) for _ in range(2))
    mh, qm = (rng.standard_normal((2, 50)).astype(np.float32) for _ in range(2))
    got = diana_shift_update(_t(h).to(torch.bfloat16), _t(qo),
                             _t(mh).to(torch.bfloat16), _t(qm), alpha=0.3,
                             beta=0.1)
    jb = jnp.bfloat16
    for g in range(2):
        for c in range(3):
            want = jref.diana_shift_update_ref(
                jnp.asarray(h[g, c]).astype(jb), jnp.asarray(qo[g, c]),
                jnp.asarray(mh[g]).astype(jb), jnp.asarray(qm[g]), 0.3, 0.1)
            _same(got[1][g, c], want[1])
            _same(got[0][g], want[0])
            _same(got[2][g], want[2])
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# unpack_reduce: the receive half of the packed collective
# ---------------------------------------------------------------------------

def _packed_stack(ranks, k, d, levels, nibble, seed, groups=None):
    """Real packed slabs and scales of `ranks` ranks (times `groups`), made
    from numpy values through the port's pack (bitwise the reference's)."""
    rng = np.random.default_rng(seed)
    lead = (ranks,) if groups is None else (groups, ranks)
    x = (rng.standard_normal((*lead, k, d)) * 3).astype(np.float32)
    u = rng.random((k, d)).astype(np.float32)
    packed, scales = pack_slab(_t(x).reshape(-1, k, d), _t(u), levels=levels,
                               nibble=nibble)
    return (packed.reshape(*lead, *packed.shape[1:]),
            scales.reshape(*lead, *scales.shape[1:]))


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("levels,nibble", [(127, False), (7, True)])
@pytest.mark.parametrize("groups", [None, 2])
@pytest.mark.parametrize("d", [40, 25, 60])
def test_unpack_reduce_matches_reference(ranks, levels, nibble, groups, d):
    """Bitwise against the reference's Pallas unpack_reduce (interpret
    mode) and its plain unpack_reduce_ref, per group; K = 13 pads to 16, so
    the trim of the padding rows is covered too (in nibble mode an odd
    row count whose last stored row holds one output row). D = 25 and 60
    are hymba's wdt and qwen2-moe's router rows."""
    k = 13
    packed, scales = _packed_stack(ranks, k, d, levels, nibble, seed=ranks,
                                   groups=groups)
    got = unpack_reduce(packed, scales, levels=levels, n_rows=k,
                        nibble=nibble)
    assert got.shape == ((k, d) if groups is None else (groups, k, d))
    for g in range(groups or 1):
        p = packed if groups is None else packed[g]
        s = scales if groups is None else scales[g]
        jp, js = jnp.asarray(p.numpy()), jnp.asarray(s.numpy())
        mine = got if groups is None else got[g]
        _same(mine, jax_unpack_reduce(jp, js, levels=levels, n_rows=k,
                                      nibble=nibble, interpret=True))
        _same(mine, jref.unpack_reduce_ref(jp, js, levels=levels, n_rows=k,
                                           nibble=nibble))


def test_unpack_reduce_is_mean_of_decodes():
    """The port's copy of tests/test_pack.py::
    test_unpack_reduce_is_mean_of_decodes: the fused reduce equals the
    rank-order sum of the individually decoded slabs divided by R,
    bitwise."""
    ranks, rows, d, levels = 4, 16, 32, 127
    packed, scales = _packed_stack(ranks, rows, d, levels, False, seed=200)
    fused = unpack_reduce(packed, scales, levels=levels, n_rows=rows)
    acc = unpack_slab(packed[0], scales[0], levels=levels, n_rows=rows)
    for r in range(1, ranks):
        acc = acc + unpack_slab(packed[r], scales[r], levels=levels,
                                n_rows=rows)
    assert torch.equal(fused, acc / ranks)


def test_unpack_reduce_weighted_scales_fold():
    """The port's copy of tests/test_pack.py::
    test_unpack_reduce_weighted_scales_fold: reducing with scales w_r * s_r
    equals the weighted mean of decodes for exact (0/1) weights, a dropped
    rank contributing exact zeros."""
    ranks, rows, d, levels = 4, 8, 16, 127
    weights = torch.tensor([1.0, 0.0, 1.0, 1.0])
    packed, scales = _packed_stack(ranks, rows, d, levels, False, seed=300)
    fused = unpack_reduce(packed, scales * weights.reshape(4, 1, 1),
                          levels=levels, n_rows=rows)
    acc = torch.zeros(rows, d)
    for r in (0, 2, 3):
        acc = acc + unpack_slab(packed[r], scales[r], levels=levels,
                                n_rows=rows)
    assert torch.equal(fused, acc / ranks)


def test_unpack_reduce_rejects_what_the_kernel_does_not_take():
    p = torch.zeros(4, 8, 16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="scales"):
        unpack_reduce(p, torch.zeros(4, 16, 1), levels=7, n_rows=8)
    with pytest.raises(ValueError, match="n_rows"):
        unpack_reduce(p, torch.zeros(4, 8, 1), levels=7, n_rows=9)
    with pytest.raises(ValueError, match="levels"):
        unpack_reduce(p, torch.zeros(4, 16, 1), levels=8, n_rows=8,
                      nibble=True)
    with pytest.raises(ValueError, match="uint8"):
        unpack_reduce(p.float(), torch.zeros(4, 8, 1), levels=7, n_rows=8)


def test_unpack_reduce_odd_rank_count():
    """R = 3: bitwise against the reference's plain unpack_reduce_ref (an
    IEEE division, as the port and its kernel divide); the reference's
    jitted Pallas kernel divides by 3 as a multiply by 1/3 (XLA:CPU, ROADMAP
    Queue C), so it is held within one ulp."""
    packed, scales = _packed_stack(3, 13, 40, 127, False, seed=3)
    got = unpack_reduce(packed, scales, levels=127, n_rows=13)
    jp, js = jnp.asarray(packed.numpy()), jnp.asarray(scales.numpy())
    _same(got, jref.unpack_reduce_ref(jp, js, levels=127, n_rows=13))
    pallas = np.asarray(jax_unpack_reduce(jp, js, levels=127, n_rows=13,
                                          interpret=True))
    ulps = np.abs(got.numpy().view(np.int32) - pallas.view(np.int32))
    assert ulps.max() <= 1


# ---------------------------------------------------------------------------
# the redesigned unpack_slab (unpack_reduce's flat units at one rank a
# group) and qsgd_quantize (16-byte lanes, every load before the max-abs)
# ---------------------------------------------------------------------------

def test_wrappers_plan_unpack_slab_units_and_qsgd_lanes():
    """unpack_slab takes unpack_reduce's unit plan on its (R, Kp[/2], D) or
    (Kp[/2], D) stack, capped at 4 packed bytes; qsgd_quantize takes 4
    values a thread in one load where x and out lie on the grid of 4 of
    their values and u on the 16-byte grid, else the scalar-lane variant."""
    from repro_torch.kernels.pack import _slab_unit
    from repro_torch.kernels.qsgd import _qsgd_lane_values

    def unit(lead, d, offset=0, nibble=False):
        kp = 16
        n = int(np.prod(lead, dtype=np.int64)) * (kp // 2 if nibble else kp) * d
        flat = torch.empty(n + offset, dtype=torch.uint8)
        packed = flat[offset:].view(*lead, kp // 2 if nibble else kp, d)
        return _slab_unit(packed, torch.empty(*lead, 13, d))

    # the wire's widths, stacked and alone, in both lanes
    for lead in ((), (1,), (3,), (4,)):
        for nibble in (False, True):
            assert [unit(lead, d, nibble=nibble)
                    for d in (2048, 1408, 5632, 64, 60, 25, 1003)] == [
                        4, 4, 4, 4, 4, 1, 1]
    assert unit((4,), 2048, offset=8) == 4  # 8 bytes on: still 4
    assert unit((4,), 2048, offset=4) == 4 and unit((4,), 1408, offset=4) == 4
    assert unit((4,), 2048, offset=1) == 1 and unit((4,), 60, offset=2) == 1
    # an out off the 16-byte grid takes one byte a unit (the wrapper's out
    # is always fresh, so on the grid)
    packed = torch.empty(4, 16, 2048, dtype=torch.uint8)
    out = torch.empty(4 * 13 * 2048 + 1)[1:].view(4, 13, 2048)
    assert _slab_unit(packed, out) == 1

    f32, bf16 = torch.float32, torch.bfloat16

    def lanes(n, dtype=f32, x_off=0, u_off=0, out_off=0):
        def view(dt, off):
            return torch.empty(n + off, dtype=dt)[off:]
        return _qsgd_lane_values(view(dtype, x_off), view(f32, u_off),
                                 view(dtype, out_off))

    for dtype in (f32, bf16):
        assert lanes(20 * TILE, dtype) == 4  # w8a: 20 clients of one tile
        assert lanes(TILE, dtype) == 4
        assert lanes(2**24, dtype) == 4
        for x_off, u_off, out_off in ((1, 0, 0), (0, 1, 0), (0, 0, 1),
                                      (2, 3, 0), (0, 2, 0)):
            assert lanes(20 * TILE, dtype, x_off, u_off, out_off) == 1
        assert lanes(20 * TILE, dtype, 4, 4, 4) == 4  # 4 values on: the grid
    assert lanes(20 * TILE, f32, 2) == 1  # 8 bytes of f32: off the 16
    assert lanes(20 * TILE, bf16, 2) == 1  # 4 bytes of bf16: off the 8
    assert lanes(20 * TILE, bf16, 8, 4, 12) == 4


def test_redesigned_wrappers_reject_what_the_kernels_do_not_take():
    """The shapes, dtypes and ranges the new lanes and units must never
    see are refused before any launch (on a CPU tensor too)."""
    f = torch.zeros(2048)
    for bad_x in (torch.zeros(2, 1024), torch.zeros(1024, dtype=torch.int32),
                  torch.zeros(1024, dtype=torch.float64)):
        with pytest.raises(ValueError, match="x"):
            qsgd_quantize(bad_x, torch.zeros(bad_x.shape))
    with pytest.raises(ValueError, match="u"):
        qsgd_quantize(f, torch.zeros(1024))
    with pytest.raises(ValueError, match="u"):
        qsgd_quantize(f, torch.zeros(2048, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="N % 1024"):
        qsgd_quantize(torch.zeros(1024 + 8), torch.zeros(1024 + 8))
    with pytest.raises(ValueError, match="levels >= 1"):
        qsgd_quantize(f, f, levels=0)
    p, s = torch.zeros(4, 8, 16, dtype=torch.uint8), torch.zeros(4, 8, 1)
    with pytest.raises(ValueError, match="uint8"):
        unpack_slab(torch.zeros(2, 4, 8, 16, dtype=torch.uint8),
                    torch.zeros(2, 4, 8, 1), levels=7, n_rows=8)
    with pytest.raises(ValueError, match="uint8"):
        unpack_slab(p.float(), s, levels=7, n_rows=8)
    with pytest.raises(ValueError, match="scales"):
        unpack_slab(p, s.double(), levels=7, n_rows=8)
    with pytest.raises(ValueError, match="scales"):
        unpack_slab(p, s, levels=7, n_rows=8, nibble=True)  # Kp = 16 there
    for n_rows in (-1, 9):
        with pytest.raises(ValueError, match="n_rows"):
            unpack_slab(p, s, levels=7, n_rows=n_rows)
    for levels, nibble in ((0, False), (128, False), (8, True)):
        with pytest.raises(ValueError, match="levels"):
            unpack_slab(p[:, :4] if nibble else p, s, levels=levels,
                        n_rows=8, nibble=nibble)
    with pytest.raises(ValueError, match="different devices"):
        unpack_slab(p, s.to("meta"), levels=7, n_rows=8)


@pytest.mark.parametrize("ranks", [None, 1, 3, 4])
@pytest.mark.parametrize("d", [25, 60, 64, 1003])
@pytest.mark.parametrize("levels,nibble", [(127, False), (7, True)])
def test_unpack_slab_stack_matches_reference(ranks, d, levels, nibble):
    """Each rank of a stack decodes as the reference's Pallas unpack_slab
    (interpret mode) and its plain version decode its one slab, bitwise:
    K = 13 (odd n_rows < Kp), an all-zero row, n_rows below K too."""
    lead = () if ranks is None else (ranks,)
    rng = np.random.default_rng(d * levels + (ranks or 0))
    x = (rng.standard_normal((*lead, 13, d)) * 3).astype(np.float32)
    x[..., 1, :] = 0.0
    u = rng.random((13, d)).astype(np.float32)
    packed, scales = pack_slab(_t(x), _t(u), levels=levels, nibble=nibble)
    for n_rows in (13, 5):
        got = unpack_slab(packed, scales, levels=levels, n_rows=n_rows,
                          nibble=nibble)
        assert got.shape == (*lead, n_rows, d)
        assert not got[..., 1, :].any()
        slabs = packed.reshape(-1, *packed.shape[-2:])
        sc = scales.reshape(-1, *scales.shape[-2:])
        for r, mine in enumerate(got.reshape(-1, n_rows, d)):
            jp, js = jnp.asarray(slabs[r].numpy()), jnp.asarray(sc[r].numpy())
            _same(mine, jax_unpack_slab(jp, js, levels=levels, n_rows=n_rows,
                                        nibble=nibble, interpret=True))
            _same(mine, jref.unpack_slab_ref(jp, js, levels=levels,
                                             n_rows=n_rows, nibble=nibble))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels,edit", [(8, "zero"), (8, "nan"), (1, None),
                                         (127, None), (8, None)])
def test_qsgd_edges_match_reference(dtype, levels, edit):
    """The card's lane edges on the plain version, against the reference's
    plain version and its Pallas kernel (interpret mode): an all-zero tile
    (zeros), a NaN (its tile all NaN on both sides, the others equal),
    levels 1 and 127, one tile."""
    rng = np.random.default_rng(levels)
    x = (rng.normal(size=(3 * TILE,)) * 3).astype(np.float32)
    if edit == "zero":
        x[:TILE] = 0.0
    if edit == "nan":
        x[7] = np.nan
    u = rng.uniform(size=x.shape).astype(np.float32)
    jd = getattr(jnp, dtype)
    got = _np(qsgd_quantize(_t(x, getattr(torch, dtype)), _t(u),
                            levels=levels))
    for want in (jref.qsgd_quantize_ref(_j(x, jd), _j(u), levels=levels,
                                        tile=TILE),
                 jax_qsgd(_j(x, jd), _j(u), levels=levels)):
        want = _np(want)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))
    if edit == "zero":
        assert not got[:TILE].any()
    if edit == "nan":
        assert np.isnan(got[:TILE]).all() and not np.isnan(got[TILE:]).any()
    one = _np(qsgd_quantize(_t(x[:TILE], getattr(torch, dtype)),
                            _t(u[:TILE]), levels=levels))
    np.testing.assert_array_equal(one, got[:TILE])
