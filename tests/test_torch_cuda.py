"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine with only PyTorch and CUDA (the serving
path, which has no kernel of the port, is held to the same run on the
host instead):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Comparisons are bitwise (`torch.equal`): each kernel keeps its plain
version's float operation order (see `repro_torch/kernels/ref.py`).
"""
import math

import pytest
import torch

from repro_torch.compression.ops import QSGDQuantizer, RandK
from repro_torch.core.algorithms import init_algorithm, make_epoch_fn
from repro_torch.data.logreg import make_federated_logreg
from repro_torch.kernels import LAUNCHES, ref, reset_launches
from repro_torch.kernels.diana_shift import diana_shift_update
from repro_torch.kernels.qsgd import TILE, qsgd_quantize
from repro_torch.kernels.randk import randk_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


@pytest.fixture
def gen(cuda):
    return torch.Generator(device=cuda).manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,dp,d,k", [(20, 300, 300, 6), (20, 1024, 300, 6),
                                      (3, 2**16, 2**16 - 77, 1310),
                                      (5, 4096, 4000, 4000)])
def test_randk_mask_kernel(cuda, gen, dtype, m, dp, d, k):
    x = torch.randn(m, dp, generator=gen, device=cuda).to(dtype)
    starts = torch.randint(0, d, (m,), generator=gen, device=cuda,
                           dtype=torch.int32)
    starts[0] = d - 1  # a window that wraps
    starts[1] = -5  # starts outside [0, d) follow torch.remainder
    starts[2] = d + 3
    reset_launches()
    got = randk_mask(x, starts, d=d, k=k)
    assert LAUNCHES["randk_mask"] == 1
    assert got.dtype == dtype
    assert torch.equal(got, ref.randk_mask_ref(x, starts, d=d, k=k))
    assert (torch.count_nonzero(got[:, :d], dim=1) <= k).all()


def _edge_starts(cuda, m, d, k):
    """Starts spread over [0, d) (every start when m == d), led by a window
    that ends at d, one that wraps by one column, and d - 1."""
    starts = (torch.arange(m, device=cuda) * max(1, d // m)) % d
    if m < d:
        starts[:3] = torch.tensor([d - k, (d - k + 1) % d, d - 1])
    return starts.to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dp,d,k,offset", [
    (1001, 1001, 20, 0),  # odd Dp: one value a lane in both dtypes
    (1024, 1024, 37, 1),  # a view one element off the 16-byte grid
    (64, 61, 13, 0),  # every start of a short row (one value a lane)
    (1024, 1021, 13, 0),  # windows wrapping across 16-byte lanes
    (1024, 1024, 1024, 0),  # k == d == Dp
    (1024, 1001, 1001, 0),  # k == d < Dp
    (1024, 1001, 9, 0),  # windows ending at d, in a lane that runs past it
])
def test_randk_mask_kernel_lane_edges(cuda, gen, dtype, dp, d, k, offset):
    """The 16-byte lanes' edges: lanes that straddle the window's end, the
    wrap point or d, and the scalar variant for odd rows and unaligned
    views; bitwise, one launch."""
    m = min(d, 64)
    flat = torch.randn(m * dp + offset, generator=gen, device=cuda).to(dtype)
    x = flat[offset:].view(m, dp)
    starts = _edge_starts(cuda, m, d, k)
    reset_launches()
    got = randk_mask(x, starts, d=d, k=k)
    assert LAUNCHES["randk_mask"] == 1
    assert torch.equal(got, ref.randk_mask_ref(x, starts, d=d, k=k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [300, 6000, 2**20 + 128, 1000])
@pytest.mark.parametrize("beta", [None, 0.0625])
def test_diana_shift_kernel(cuda, gen, dtype, n, beta):
    ins = [torch.randn(n, generator=gen, device=cuda).to(dtype) for _ in range(4)]
    reset_launches()
    got = diana_shift_update(*ins, alpha=0.0196, beta=beta)
    assert LAUNCHES["diana_shift_update"] == 1
    for g, w in zip(got, ref.diana_shift_update_ref(*ins, 0.0196, beta)):
        assert g.dtype == dtype and torch.equal(g, w)


def test_diana_shift_kernel_aliased_inputs(cuda, gen):
    """The non-local round passes h as both h and H, q as both Q_own and
    Q_mean: read-only inputs may alias."""
    h = torch.randn(6000, generator=gen, device=cuda)
    q = torch.randn(6000, generator=gen, device=cuda)
    got = diana_shift_update(h, q, h, q, alpha=0.3)
    for g, w in zip(got, ref.diana_shift_update_ref(h, q, h, q, 0.3)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_tiles", [1, 20, 4096])
@pytest.mark.parametrize("levels", [3, 8])
def test_qsgd_kernel(cuda, gen, dtype, n_tiles, levels):
    x = (torch.randn(n_tiles * TILE, generator=gen, device=cuda) * 3).to(dtype)
    x[:7] = 0.0
    u = torch.rand(n_tiles * TILE, generator=gen, device=cuda)
    reset_launches()
    got = qsgd_quantize(x, u, levels=levels)
    assert LAUNCHES["qsgd_quantize"] == 1
    assert got.dtype == dtype
    assert torch.equal(got, ref.qsgd_quantize_ref(x, u, levels=levels))


def test_wrappers_reject_mixed_devices_and_strides(cuda):
    x = torch.zeros(2, 2048, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        randk_mask(x, torch.zeros(2, dtype=torch.int32), d=2000, k=5)
    with pytest.raises(ValueError, match="contiguous"):
        randk_mask(x[:, ::2], torch.zeros(2, dtype=torch.int32, device=cuda),
                   d=1000, k=5)
    with pytest.raises(ValueError, match="different devices"):
        diana_shift_update(torch.zeros(128), *(torch.zeros(128, device=cuda),) * 3,
                           alpha=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        qsgd_quantize(torch.zeros(2048, device=cuda)[::2],
                      torch.zeros(1024, device=cuda))


@pytest.mark.parametrize("name,comp", [("diana_rr", RandK(fraction=0.25)),
                                       ("q_rr", QSGDQuantizer(levels=8)),
                                       ("diana_nastya", RandK(fraction=0.25))])
def test_cuda_backend_epoch_matches_reference_backend(cuda, gen, name, comp):
    """The whole epoch on the kernels equals the epoch on the plain versions,
    same draws, same order: every other operation is the same torch code."""
    problem = make_federated_logreg(m=8, n_batches=6, batch=6, d=16, cond=20.0,
                                    seed=3)
    loss = problem.loss_fn()
    outs = []
    for backend in ("cuda", "reference"):
        spec, epoch = make_epoch_fn(name, loss, comp, gamma=0.01, eta=0.05,
                                    backend=backend)
        st = init_algorithm(spec, {"w": torch.zeros(16, device=cuda)}, 8, 6)
        for e in range(3):
            st = epoch(st, problem.data,
                       torch.Generator(device=cuda).manual_seed(e))
        outs.append(st)
    a, b = outs
    assert torch.equal(a.params["w"], b.params["w"])
    if a.shifts is not None:
        assert torch.equal(a.shifts["w"], b.shifts["w"])


# ---------------------------------------------------------------------------
# the wire's kernels
# ---------------------------------------------------------------------------

_F32, _BF16 = torch.float32, torch.bfloat16
# (h and H, Q_own and Q_mean): the simulator's f32, the wire's bf16 tables
# beside f32 messages, and the two others
_SHIFT_PAIRS = [(_F32, _F32), (_BF16, _F32), (_F32, _BF16), (_BF16, _BF16)]


def _shift_inputs(cuda, gen, h_shape, hd, qd, offset=0):
    """h, Q_own of h_shape and H, Q_mean of the matching mean shape, each a
    view `offset` elements off the 16-byte grid."""
    m_shape = h_shape if len(h_shape) == 1 else (h_shape[0], h_shape[2])

    def one(shape, dtype):
        flat = torch.randn(math.prod(shape) + offset, generator=gen,
                           device=cuda).to(dtype)
        return flat[offset:].view(shape)
    return one(h_shape, hd), one(h_shape, qd), one(m_shape, hd), one(m_shape, qd)


def _assert_shift_kernel(ins, alpha=0.02, beta=0.03):
    reset_launches()
    got = diana_shift_update(*ins, alpha=alpha, beta=beta)
    assert LAUNCHES["diana_shift_update"] == 1
    for g, w in zip(got, ref.diana_shift_update_ref(*ins, alpha, beta)):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("hd,qd", _SHIFT_PAIRS)
@pytest.mark.parametrize("h_shape", [
    (1,), (1001,), (1004,), (6000,),  # n = 1, n % 4 != 0, n % 8 != 0
    (1, 3, 1000), (2, 2, 1000),  # 3 ranks; 2 groups of 2
    (2, 2, 1003), (1, 4, 4096), (2, 5, 1000)])
def test_diana_shift_kernel_lane_edges(cuda, gen, hd, qd, h_shape):
    """Flat lanes of 16 bytes on the wider side (4 values, 8 when both
    sides are bf16), one value where n is off that grid; the h side's
    range and the H side's meeting inside a warp; every dtype pair;
    bitwise, one launch."""
    from repro_torch.kernels.diana_shift import _shift_lane_values

    ins = _shift_inputs(cuda, gen, h_shape, hd, qd)
    v = 8 if hd == qd == _BF16 else 4
    n = h_shape[-1]
    assert _shift_lane_values(ins, [torch.empty_like(t) for t in ins],
                              n) == (v if n % v == 0 else 1)
    _assert_shift_kernel(ins)


@pytest.mark.parametrize("hd,qd", _SHIFT_PAIRS)
@pytest.mark.parametrize("h_shape", [(4096,), (1, 4, 4096)])
@pytest.mark.parametrize("offset", [1, 2])
def test_diana_shift_kernel_off_grid(cuda, gen, hd, qd, h_shape, offset):
    """Contiguous views 1 or 2 values off the 16-byte grid (2 to 8 bytes)
    take one value a lane; bitwise, one launch."""
    from repro_torch.kernels.diana_shift import _shift_lane_values

    ins = _shift_inputs(cuda, gen, h_shape, hd, qd, offset=offset)
    assert _shift_lane_values(ins, [torch.empty_like(t) for t in ins],
                              h_shape[-1]) == 1
    _assert_shift_kernel(ins)


@pytest.mark.parametrize("hd,qd", _SHIFT_PAIRS)
@pytest.mark.parametrize("n", [300, 1001, 6000])
def test_diana_shift_kernel_aliased_lanes(cuda, gen, hd, qd, n):
    """h passed as H and Q_own as Q_mean, in lanes and in single values;
    bitwise, one launch."""
    h, q, _, _ = _shift_inputs(cuda, gen, (n,), hd, qd)
    _assert_shift_kernel((h, q, h, q), alpha=0.3, beta=None)


def test_diana_shift_kernel_wide_index(cuda, gen):
    """2 ranks of 2^30 + 1 bf16 values (one value a lane, 2^31 + 2 lanes on
    the h side): the kernel indexes in 64 bits there. Each rank is held to
    the plain version on its own, to bound the plain version's memory."""
    n = 2**30 + 1
    h = torch.randn(1, 2, n, generator=gen, device=cuda).to(_BF16)
    qo = torch.randn(1, 2, n, generator=gen, device=cuda).to(_BF16)
    mh = torch.randn(1, n, generator=gen, device=cuda).to(_BF16)
    qm = torch.randn(1, n, generator=gen, device=cuda).to(_BF16)
    reset_launches()
    d, h_new, mh_new = diana_shift_update(h, qo, mh, qm, alpha=0.02, beta=0.03)
    assert LAUNCHES["diana_shift_update"] == 1
    for c in range(2):
        want = ref.diana_shift_update_ref(h[:, c], qo[:, c], mh, qm, 0.02, 0.03)
        assert torch.equal(h_new[:, c], want[1])
        if c == 0:
            assert torch.equal(d, want[0]) and torch.equal(mh_new, want[2])
        del want


def _start(cuda, value):
    return torch.tensor(value, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("lead", [(), (1,), (3,)])
@pytest.mark.parametrize("d", [25, 60, 5, 33, 1])
@pytest.mark.parametrize("n,kb,start", [
    (64, 3, 7),  # the window wraps past the last block
    (64, 8, 5),  # kb == nb, rotated
    (96, 5, -2),  # a start below 0 follows torch.remainder
])
def test_randk_compress_kernel_lane_edges(cuda, gen, dtype, lead, d, n, kb,
                                          start):
    """Flat 16-byte lanes over whole 8-row window blocks: narrow and odd D,
    (N, D) rows and 1 and 3 ranks, lanes that straddle rows and the
    window's ends; bitwise, one launch."""
    from repro_torch.kernels.randk import _block_lane_values, randk_compress

    rows = torch.randn(*lead, n, d, generator=gen, device=cuda).to(dtype)
    s = _start(cuda, start)
    assert _block_lane_values(rows, torch.empty(1, 8, d, dtype=dtype,
                                                device=cuda), 8) == (
        16 // rows.element_size())
    reset_launches()
    got = randk_compress(rows, s, k_blocks=kb)
    assert LAUNCHES["randk_compress"] == 1
    assert got.dtype == dtype and got.shape == (*lead, kb * 8, d)
    assert torch.equal(got, ref.randk_compress_ref(rows, s, k_blocks=kb))


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("d,offset", [(25, 1), (60, 3), (2048, 1), (64, 2)])
def test_randk_compress_kernel_off_grid(cuda, gen, dtype, d, offset):
    """A rows view off the 16-byte grid takes one element a lane, still
    flat; bitwise, one launch."""
    from repro_torch.kernels.randk import _block_lane_values, randk_compress

    flat = torch.randn(3 * 64 * d + offset, generator=gen, device=cuda).to(dtype)
    rows = flat[offset:].view(3, 64, d)
    s = _start(cuda, 7)
    assert _block_lane_values(rows, torch.empty(3, 24, d, dtype=dtype,
                                                device=cuda), 8) == 1
    reset_launches()
    got = randk_compress(rows, s, k_blocks=3)
    assert LAUNCHES["randk_compress"] == 1
    assert torch.equal(got, ref.randk_compress_ref(rows, s, k_blocks=3))


def test_randk_compress_kernel_wide_index(cuda, gen):
    """Rows of 2^31 one-element lanes (bf16 off the 16-byte grid): the
    kernel indexes in 64 bits past 2^31 lanes of the rows."""
    from repro_torch.kernels.randk import randk_compress

    n, d, kb = 2**19, 2**12, 3
    flat = torch.randn(n * d + 1, generator=gen, device=cuda).to(_BF16)
    rows = flat[1:].view(n, d)
    s = _start(cuda, n // 8 - 1)  # the window wraps
    reset_launches()
    got = randk_compress(rows, s, k_blocks=kb)
    assert LAUNCHES["randk_compress"] == 1
    assert torch.equal(got, ref.randk_compress_ref(rows, s, k_blocks=kb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,n,d,kb,start", [
    ((), 64, 33, 3, 7),  # the window wraps past the last block
    ((4,), 8, 5, 1, 0),  # one block: kb == nb
    ((4,), 2048, 256, 40, 30),
    ((2,), 1024, 1003, 128, 100),  # D not a multiple of 4, kb == nb
])
def test_randk_compress_decompress_kernels(cuda, gen, dtype, lead, n, d, kb,
                                           start):
    from repro_torch.kernels.randk import randk_compress, randk_decompress

    rows = torch.randn(*lead, n, d, generator=gen, device=cuda).to(dtype)
    s = _start(cuda, start)
    reset_launches()
    vals = randk_compress(rows, s, k_blocks=kb)
    dense = randk_decompress(vals, s, n_rows=n)
    assert LAUNCHES["randk_compress"] == 1 and LAUNCHES["randk_decompress"] == 1
    assert vals.dtype == dtype and dense.dtype == dtype
    assert torch.equal(vals, ref.randk_compress_ref(rows, s, k_blocks=kb))
    assert torch.equal(dense, ref.randk_decompress_ref(vals, s, n_rows=n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead", [(1,), (4,)])
@pytest.mark.parametrize("d", [25, 60, 64, 5, 33])
@pytest.mark.parametrize("n,kb,start", [
    (64, 3, 7),  # the window wraps past the last block
    (64, 8, 5),  # kb == nb, rotated
    (96, 5, -2),  # a start below 0 follows torch.remainder
])
def test_randk_decompress_kernel_lane_edges(cuda, gen, dtype, lead, d, n, kb,
                                            start):
    """Flat 16-byte lanes over whole 8-row blocks: narrow and odd D (8 * D *
    itemsize is a multiple of 16 for every D), one group and four, lanes
    that straddle rows and the window's ends; bitwise, one launch."""
    from repro_torch.kernels.randk import randk_decompress

    vals = torch.randn(*lead, kb * 8, d, generator=gen, device=cuda).to(dtype)
    s = _start(cuda, start)
    reset_launches()
    got = randk_decompress(vals, s, n_rows=n)
    assert LAUNCHES["randk_decompress"] == 1
    assert got.dtype == dtype
    assert torch.equal(got, ref.randk_decompress_ref(vals, s, n_rows=n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [25, 64, 2048])
def test_randk_decompress_kernel_off_grid(cuda, gen, dtype, d):
    """A slab view one element off the 16-byte grid takes one element a
    lane, still flat; bitwise, one launch."""
    from repro_torch.kernels.randk import _block_lane_values, randk_decompress

    flat = torch.randn(4 * 24 * d + 1, generator=gen, device=cuda).to(dtype)
    vals = flat[1:].view(4, 24, d)
    s = _start(cuda, 6)
    assert _block_lane_values(vals, torch.empty_like(vals), 8) == 1
    reset_launches()
    got = randk_decompress(vals, s, n_rows=64)
    assert LAUNCHES["randk_decompress"] == 1
    assert torch.equal(got, ref.randk_decompress_ref(vals, s, n_rows=64))


def test_randk_decompress_kernel_grid_stride(cuda, gen):
    """More lanes than the capped grid holds at once: the grid-stride loop
    covers the rest."""
    from repro_torch.kernels.randk import randk_decompress

    vals = torch.randn(4, 40 * 8, 512, generator=gen, device=cuda)
    s = _start(cuda, 2040)
    reset_launches()
    got = randk_decompress(vals, s, n_rows=16384)
    assert LAUNCHES["randk_decompress"] == 1
    assert torch.equal(got, ref.randk_decompress_ref(vals, s, n_rows=16384))


@pytest.mark.parametrize("lead,k,d,levels,nibble", [
    ((), 16, 64, 127, False), ((4,), 13, 40, 127, False),
    ((4,), 13, 40, 7, True), ((2,), 24, 1003, 7, True),
    ((4,), 2000, 512, 127, False),
])
def test_pack_unpack_kernels(cuda, gen, lead, k, d, levels, nibble):
    from repro_torch.kernels.pack import pack_slab, unpack_slab

    vals = torch.randn(*lead, k, d, generator=gen, device=cuda) * 3
    vals[..., 0, :] = 0.0  # an all-zero row
    u = torch.rand(k, d, generator=gen, device=cuda)
    reset_launches()
    packed, scales = pack_slab(vals, u, levels=levels, nibble=nibble)
    out = unpack_slab(packed, scales, levels=levels, n_rows=k, nibble=nibble)
    assert LAUNCHES["pack_slab"] == 1 and LAUNCHES["unpack_slab"] == 1
    want_p, want_s = ref.pack_slab_ref(vals, u, levels=levels, nibble=nibble)
    assert torch.equal(packed, want_p) and torch.equal(scales, want_s)
    assert torch.equal(out, ref.unpack_slab_ref(packed, scales, levels=levels,
                                                n_rows=k, nibble=nibble))


@pytest.mark.parametrize("lead,k,d,levels,nibble,dtype,offset", [
    ((4,), 64, 2048, 127, False, torch.bfloat16, 0),
    ((4,), 64, 2048, 7, True, torch.bfloat16, 0),
    ((), 24, 2048, 127, False, torch.float32, 0),  # one slab
    ((1,), 24, 5632, 127, False, torch.float32, 0),  # R = 1
    ((8,), 40, 2048, 127, False, torch.float32, 0),  # R = 8
    ((8,), 37, 2048, 7, True, torch.float32, 0),  # odd K, nibble
    ((4,), 13, 1002, 127, False, torch.float32, 0),  # D % 4 != 0
    ((4,), 16, 2048, 127, False, torch.float32, 1),  # a view off the grid
    ((4,), 16, 2048, 7, True, torch.bfloat16, 3),
    ((2,), 10, 20000, 127, False, torch.float32, 0),  # past the registers
    ((2,), 10, 20000, 7, True, torch.float32, 0),
    ((2,), 10, 16384, 127, False, torch.float32, 0),  # the widest in them
    ((2,), 10, 8192, 7, True, torch.float32, 0),
    ((2,), 9, 5632, 7, True, torch.bfloat16, 0),
])
def test_pack_slab_kernel_edges(cuda, gen, lead, k, d, levels, nibble, dtype,
                                offset):
    """pack_slab's variants (16-byte or one-value units, registers or the
    wide two-pass rows) and rank counts, bitwise, one launch."""
    from repro_torch.kernels.pack import pack_slab

    n = k * d * (lead[0] if lead else 1)
    flat = (torch.randn(n + offset, generator=gen, device=cuda) * 3).to(dtype)
    vals = flat[offset:].view(*lead, k, d)
    vals[..., 1, :] = 0.0  # an all-zero row
    u = torch.rand(k, d, generator=gen, device=cuda)
    reset_launches()
    packed, scales = pack_slab(vals, u, levels=levels, nibble=nibble)
    assert LAUNCHES["pack_slab"] == 1
    want_p, want_s = ref.pack_slab_ref(vals, u, levels=levels, nibble=nibble)
    assert torch.equal(packed, want_p) and torch.equal(scales, want_s)


@pytest.mark.parametrize("groups,ranks,k,d,levels,nibble", [
    (None, 4, 16, 64, 127, False), (2, 2, 13, 40, 127, False),
    (None, 3, 13, 1003, 127, False), (2, 4, 13, 40, 7, True),
    (1, 3, 24, 1003, 7, True), (1, 4, 2000, 512, 127, False),
])
def test_unpack_reduce_kernel(cuda, gen, groups, ranks, k, d, levels, nibble):
    """Bitwise against the plain version: byte and nibble lanes, D with and
    without 4-byte loads, an odd rank count, weighted scales, and a view
    whose storage does not start on a 4-byte boundary."""
    from repro_torch.kernels.pack import pack_slab, unpack_reduce

    lead = (ranks,) if groups is None else (groups, ranks)
    vals = torch.randn(*lead, k, d, generator=gen, device=cuda) * 3
    u = torch.rand(k, d, generator=gen, device=cuda)
    packed, scales = pack_slab(vals.reshape(-1, k, d), u, levels=levels,
                               nibble=nibble)
    packed = packed.reshape(*lead, *packed.shape[1:])
    scales = scales.reshape(*lead, *scales.shape[1:])
    weights = torch.rand(ranks, generator=gen, device=cuda)
    weights[0] = 0.0
    for s in (scales, scales * weights.reshape(ranks, 1, 1)):
        reset_launches()
        got = unpack_reduce(packed, s, levels=levels, n_rows=k, nibble=nibble)
        assert LAUNCHES["unpack_reduce"] == 1
        assert torch.equal(got, ref.unpack_reduce_ref(
            packed, s, levels=levels, n_rows=k, nibble=nibble))
    flat = torch.zeros(packed.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = flat[1:].view(packed.shape)
    shifted.copy_(packed)
    assert torch.equal(
        unpack_reduce(shifted, scales, levels=levels, n_rows=k, nibble=nibble),
        ref.unpack_reduce_ref(packed, scales, levels=levels, n_rows=k,
                              nibble=nibble))


def test_randk_decompress_kernel_wide_index(cuda, gen):
    """A canvas of 2^31 one-element lanes (a bf16 slab off the 16-byte
    grid): the kernel indexes in 64 bits past 2^31 lanes."""
    from repro_torch.kernels.randk import randk_decompress

    n, d, kb = 2**19, 2**12, 3
    flat = torch.randn(kb * 8 * d + 1, generator=gen, device=cuda)
    vals = flat.to(torch.bfloat16)[1:].view(kb * 8, d)
    s = _start(cuda, n // 8 - 1)  # the window wraps
    reset_launches()
    got = randk_decompress(vals, s, n_rows=n)
    assert LAUNCHES["randk_decompress"] == 1
    assert torch.equal(got, ref.randk_decompress_ref(vals, s, n_rows=n))
    del got


def _reduce_inputs(cuda, gen, lead, k, d, levels, nibble):
    """Packed slabs and scales of the ranks in `lead` from seeded values."""
    from repro_torch.kernels.pack import pack_slab

    vals = torch.randn(*lead, k, d, generator=gen, device=cuda) * 3
    u = torch.rand(k, d, generator=gen, device=cuda)
    packed, scales = pack_slab(vals.reshape(-1, k, d), u, levels=levels,
                               nibble=nibble)
    return (packed.reshape(*lead, *packed.shape[1:]),
            scales.reshape(*lead, *scales.shape[1:]))


@pytest.mark.parametrize("d", [25, 60, 1408, 1003, 2048])
@pytest.mark.parametrize("ranks", [1, 3, 4, 9, 64])
@pytest.mark.parametrize("levels,nibble", [(127, False), (7, True)])
def test_unpack_reduce_kernel_unit_edges(cuda, gen, d, ranks, levels, nibble):
    """The flat units (8, 4 and 1 packed bytes) at narrow, odd and wide D;
    one rank, odd rank counts, the compile-time rank chunk and 64 ranks
    past it; K = 13 (odd n_rows < Kp, so in nibble mode the last stored row
    holds one output row); plain and weighted scales with a zero weight;
    bitwise, one launch."""
    from repro_torch.kernels.pack import unpack_reduce

    lead = (2, ranks) if ranks <= 9 else (ranks,)
    packed, scales = _reduce_inputs(cuda, gen, lead, 13, d, levels, nibble)
    weights = torch.rand(ranks, generator=gen, device=cuda)
    weights[ranks // 2] = 0.0
    for s in (scales, scales * weights.reshape(ranks, 1, 1)):
        reset_launches()
        got = unpack_reduce(packed, s, levels=levels, n_rows=13, nibble=nibble)
        assert LAUNCHES["unpack_reduce"] == 1
        assert torch.equal(got, ref.unpack_reduce_ref(
            packed, s, levels=levels, n_rows=13, nibble=nibble))


@pytest.mark.parametrize("d,offset,unit", [
    (2048, 4, 4), (2048, 1, 1), (1408, 4, 4), (1408, 2, 1), (60, 4, 4),
    (60, 3, 1), (2048, 8, 8)])
@pytest.mark.parametrize("levels,nibble", [(127, False), (7, True)])
def test_unpack_reduce_kernel_off_grid(cuda, gen, d, offset, unit, levels,
                                       nibble):
    """A packed view off the 8-byte grid takes 4-byte units, one off the
    4-byte grid 1-byte units; bitwise, one launch."""
    from repro_torch.kernels.pack import _reduce_unit, unpack_reduce

    packed, scales = _reduce_inputs(cuda, gen, (4,), 13, d, levels, nibble)
    flat = torch.zeros(packed.numel() + offset, dtype=torch.uint8, device=cuda)
    shifted = flat[offset:].view(packed.shape)
    shifted.copy_(packed)
    assert _reduce_unit(shifted, torch.empty(13, d, device=cuda)) == unit
    reset_launches()
    got = unpack_reduce(shifted, scales, levels=levels, n_rows=13,
                        nibble=nibble)
    assert LAUNCHES["unpack_reduce"] == 1
    assert torch.equal(got, ref.unpack_reduce_ref(
        packed, scales, levels=levels, n_rows=13, nibble=nibble))


def test_unpack_reduce_kernel_wide_index(cuda, gen):
    """A packed stack of 2^31 bytes (64 ranks x 8 rows x 2^22): the kernel
    indexes in 64 bits there."""
    from repro_torch.kernels.pack import unpack_reduce

    ranks, kp, d = 64, 8, 2**22
    packed = torch.randint(0, 255, (ranks, kp, d), generator=gen, device=cuda,
                           dtype=torch.uint8)
    scales = torch.rand(ranks, kp, 1, generator=gen, device=cuda)
    reset_launches()
    got = unpack_reduce(packed, scales, levels=127, n_rows=kp)
    assert LAUNCHES["unpack_reduce"] == 1
    assert torch.equal(got, ref.unpack_reduce_ref(packed, scales, levels=127,
                                                  n_rows=kp))


def _equal_with_nan(got, want) -> bool:
    """torch.equal, with NaN in the same places equal (torch.equal fails on
    any NaN)."""
    nan = want.isnan()
    return (got.dtype == want.dtype and torch.equal(got.isnan(), nan)
            and torch.equal(got.masked_fill(nan, 0.0),
                            want.masked_fill(nan, 0.0)))


# qsgd_quantize's lanes: (tiles, x offset, u offset, levels, zero tile, NaN)
QSGD_EDGES = [
    (1, 0, 0, 8, False, False),  # one tile
    (20, 1, 0, 8, False, False),  # x off the 16-byte grid: scalar lanes
    (20, 0, 1, 8, False, False),  # u off the grid
    (20, 2, 3, 8, False, False),
    (3, 0, 0, 8, True, False),  # an all-zero tile: 0 * (1e-30 / L)
    (3, 0, 0, 8, False, True),  # a NaN: its tile is NaN, the others not
    (3, 1, 0, 8, False, True),
    (20, 0, 0, 1, False, False),  # levels 1 and 127
    (20, 0, 0, 127, False, False),
    (20, 4, 4, 8, False, False),  # 16 bytes on (f32): back on the grid
]


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("tiles,x_off,u_off,levels,zero,nan", QSGD_EDGES)
def test_qsgd_kernel_lane_edges(cuda, gen, dtype, tiles, x_off, u_off,
                                levels, zero, nan):
    """The 16-byte lanes and the scalar-lane variant for views off the
    grid, an all-zero tile, NaN, levels 1 and 127: bitwise (NaN where the
    plain version has NaN), one launch."""
    from repro_torch.kernels.qsgd import _qsgd_lane_values

    n = tiles * TILE
    flat = (torch.randn(n + x_off, generator=gen, device=cuda) * 3).to(dtype)
    x = flat[x_off:]
    if zero:
        x[:TILE] = 0.0
    if nan:
        x[7] = float("nan")
    u = torch.rand(n + u_off, generator=gen, device=cuda)[u_off:]
    grid = all(t.data_ptr() % 16 == 0 for t in (x, u)) or (
        dtype == _BF16 and x.data_ptr() % 8 == 0 and u.data_ptr() % 16 == 0)
    assert _qsgd_lane_values(x, u, torch.empty_like(x)) == (4 if grid else 1)
    reset_launches()
    got = qsgd_quantize(x, u, levels=levels)
    assert LAUNCHES["qsgd_quantize"] == 1
    want = ref.qsgd_quantize_ref(x, u, levels=levels)
    assert _equal_with_nan(got, want)
    if nan:
        assert got[:TILE].isnan().all() and not got[TILE:].isnan().any()


def _slab_inputs(cuda, gen, lead, k, d, levels, nibble, offset=0):
    """Packed slabs and scales from seeded values with an all-zero row 1;
    the packed bytes as a view `offset` bytes off the grid."""
    from repro_torch.kernels.pack import pack_slab

    vals = torch.randn(*lead, k, d, generator=gen, device=cuda) * 3
    vals[..., 1, :] = 0.0
    u = torch.rand(k, d, generator=gen, device=cuda)
    packed, scales = pack_slab(vals, u, levels=levels, nibble=nibble)
    if offset:
        flat = torch.zeros(packed.numel() + offset, dtype=torch.uint8,
                           device=cuda)
        packed = flat[offset:].view(packed.shape).copy_(packed)
    return packed, scales


def _assert_unpack_slab(packed, scales, levels, n_rows, nibble):
    from repro_torch.kernels.pack import unpack_slab

    reset_launches()
    got = unpack_slab(packed, scales, levels=levels, n_rows=n_rows,
                      nibble=nibble)
    assert LAUNCHES["unpack_slab"] == 1
    want = ref.unpack_slab_ref(packed, scales, levels=levels, n_rows=n_rows,
                               nibble=nibble)
    assert got.shape == want.shape and _equal_with_nan(got, want)
    return got


@pytest.mark.parametrize("d", [25, 60, 64, 1408, 5632, 1003])
@pytest.mark.parametrize("lead", [(), (1,), (3,), (4,)])
@pytest.mark.parametrize("levels,nibble", [(127, False), (7, True)])
def test_unpack_slab_kernel_unit_edges(cuda, gen, d, lead, levels, nibble):
    """unpack_reduce's flat units at one rank a group (4 and 1 packed
    bytes) at narrow, odd and wide D; one slab and R = 1, 3 and 4; K = 13
    (odd n_rows < Kp: in nibble mode the last stored row holds one output
    row); an all-zero row decodes to zeros; bitwise, one launch."""
    from repro_torch.kernels.pack import _slab_unit

    packed, scales = _slab_inputs(cuda, gen, lead, 13, d, levels, nibble)
    assert _slab_unit(packed, torch.empty(13, d, device=cuda)) == (
        4 if d % 4 == 0 else 1)
    got = _assert_unpack_slab(packed, scales, levels, 13, nibble)
    assert not got[..., 1, :].any()


@pytest.mark.parametrize("d,offset,unit", [
    (2048, 4, 4), (2048, 1, 1), (1408, 4, 4), (1408, 2, 1), (60, 4, 4),
    (60, 3, 1), (2048, 8, 4)])
@pytest.mark.parametrize("levels,nibble", [(127, False), (7, True)])
def test_unpack_slab_kernel_off_grid(cuda, gen, d, offset, unit, levels,
                                     nibble):
    """A packed view off the 8-byte grid still takes 4-byte units, one off
    the 4-byte grid 1-byte units; bitwise, one launch."""
    from repro_torch.kernels.pack import _slab_unit

    packed, scales = _slab_inputs(cuda, gen, (4,), 13, d, levels, nibble,
                                  offset)
    assert _slab_unit(packed, torch.empty(13, d, device=cuda)) == unit
    _assert_unpack_slab(packed, scales, levels, 13, nibble)


@pytest.mark.parametrize("n_rows", [0, 1, 7, 16])
@pytest.mark.parametrize("levels,nibble", [(127, False), (7, True)])
def test_unpack_slab_kernel_rows_and_nan(cuda, gen, n_rows, levels, nibble):
    """Any n_rows <= Kp (only those rows are written), and a NaN scale,
    whose row decodes to NaN on both sides; bitwise, one launch (none for
    an empty result)."""
    from repro_torch.kernels.pack import unpack_slab

    packed, scales = _slab_inputs(cuda, gen, (3,), 13, 2048, levels, nibble)
    scales[:, 0] = float("nan")
    if n_rows == 0:
        reset_launches()
        got = unpack_slab(packed, scales, levels=levels, n_rows=0,
                          nibble=nibble)
        assert got.shape == (3, 0, 2048) and LAUNCHES["unpack_slab"] == 0
        return
    got = _assert_unpack_slab(packed, scales, levels, n_rows, nibble)
    assert got[:, 0].isnan().all() and not got[:, 1:].isnan().any()


def test_unpack_slab_kernel_wide_index(cuda, gen):
    """A packed slab of more than 2^31 bytes (8 rows of 2^28 + 8): the
    kernel indexes in 64 bits there."""
    kp, d = 8, 2**28 + 8
    packed = torch.randint(0, 255, (kp, d), generator=gen, device=cuda,
                           dtype=torch.uint8)
    scales = torch.rand(kp, 1, generator=gen, device=cuda)
    got = _assert_unpack_slab(packed, scales, 127, kp - 1, False)
    del got


@pytest.mark.parametrize("hd,qd", [(torch.bfloat16, torch.float32),
                                   (torch.float32, torch.float32),
                                   (torch.float32, torch.bfloat16)])
def test_diana_shift_kernel_rank_groups(cuda, gen, hd, qd):
    """The wire's layout: a group's C ranks beside the group's one mean,
    bf16 tables beside f32 messages."""
    h = torch.randn(2, 3, 1000, generator=gen, device=cuda).to(hd)
    qo = torch.randn(2, 3, 1000, generator=gen, device=cuda).to(qd)
    mh = torch.randn(2, 1000, generator=gen, device=cuda).to(hd)
    qm = torch.randn(2, 1000, generator=gen, device=cuda).to(qd)
    got = diana_shift_update(h, qo, mh, qm, alpha=0.02, beta=0.03)
    want = ref.diana_shift_update_ref(h, qo, mh, qm, 0.02, 0.03)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("method,levels,mesh_shape,extra", [
    ("diana_rr", None, (4, 1), {}), ("diana", 127, (4, 1), {}),
    ("q", None, (2, 2, 1), {}), ("ef", None, (4, 1), {}),
    ("diana_rr", None, (4, 1), {"wire_dtype": "packed8"}),
    ("diana", None, (2, 2, 1), {"wire_dtype": "packed4"}),
    ("diana", None, (4, 1), {"wire_dtype": "bf16"}),
    ("diana", None, (4, 1), {"local_steps": 2}),
    ("diana_rr", None, (2, 2, 1), {"local_steps": 2,
                                   "wire_dtype": "packed8"}),
    ("diana", None, (4, 1), {"weights": (1.0, 0.0, 0.5, 1.0),
                             "wire_dtype": "packed8"}),
])
def test_cuda_train_step_matches_reference_backend(cuda, method, levels,
                                                   mesh_shape, extra):
    """A reduced stablelm train step on the kernels equals the same step on
    the plain versions, same state, batch and draws: the f32, bf16 and
    packed transports, NASTYA (two local steps) and the elastic weights."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step

    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b"), seq=16),
                              dtype=torch.float32)
    mesh = make_mesh(mesh_shape, ("pod", "data", "model")[-len(mesh_shape):])
    ls = extra.get("local_steps", 1)
    weights = extra.get("weights")
    tokens = torch.randint(0, cfg.vocab, (8 * ls, 17), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    slots = [1, 0][:ls] if method == "diana_rr" else None
    outs = []
    for backend in ("cuda", "reference"):
        agg = CompressedAggregation(method=method, fraction=0.25, n_slots=2,
                                    wire_levels=levels, backend=backend,
                                    wire_dtype=extra.get("wire_dtype", "f32"))
        state = init_train_state(0, cfg, agg, 4, mesh=mesh, local_steps=ls,
                                 device=cuda)
        step = make_train_step(cfg, mesh, agg=agg, lr=0.05, remat=False,
                               local_steps=ls, eta=0.1 if ls > 1 else None,
                               elastic=weights is not None)
        w = None if weights is None else torch.tensor(weights, device=cuda)
        for _ in range(2):
            state, _ = step(state, {"tokens": tokens},
                            torch.Generator(device=cuda).manual_seed(3), slots,
                            w)
        outs.append(state)
    torch.use_deterministic_algorithms(False)
    from repro_torch.core.api import tree_leaves

    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "dbrx-132b", "rwkv6-7b",
                                  "hymba-1.5b", "qwen2-vl-2b",
                                  "whisper-medium", "starcoder2-15b"])
@pytest.mark.parametrize("wire_dtype", ["f32", "packed8"])
def test_cuda_family_train_step_matches_reference_backend(cuda, name,
                                                          wire_dtype):
    """Each new model family's reduced train step (bf16, with its f32
    leaves, stub patches and frames) on the kernels equals the same step on
    the plain versions: DIANA-RR, same state, batch and draws."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.api import tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step

    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = reduced(get_config(name), seq=32)
    mesh = make_mesh((4, 1))
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (8, 33), device=cuda,
                                     generator=g)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(8, cfg.vision_patches, cfg.d_model,
                                       device=cuda, generator=g).to(cfg.dtype)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(8, cfg.encoder_seq, cfg.d_model,
                                      device=cuda, generator=g).to(cfg.dtype)
    outs = []
    for backend in ("cuda", "reference"):
        agg = CompressedAggregation(method="diana_rr", fraction=0.25,
                                    n_slots=2, wire_dtype=wire_dtype,
                                    backend=backend)
        state = init_train_state(0, cfg, agg, 4, mesh=mesh, device=cuda)
        step = make_train_step(cfg, mesh, agg=agg, lr=0.05, remat=False)
        for slot in (1, 0):
            state, metrics = step(state, batch,
                                  torch.Generator(device=cuda).manual_seed(3),
                                  [slot])
        assert torch.isfinite(metrics["loss"])
        outs.append(state)
    torch.use_deterministic_algorithms(False)
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# serving (no kernel of the port on this path: the card against the host)
# ---------------------------------------------------------------------------

def _close_to_host(got, want, what):
    """got (on the card) within 1e-2 of the host run's largest entry: the
    bf16 rounding of the attention's operands turns a last-bit difference
    between the two devices' f32 sums into 2^-8 of an element (the bound
    tests/test_torch_serving.py holds the port to the reference at)."""
    got, want = got.float().cpu(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= 1e-2 * scale + 1e-7, f"{what}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("name", ["stablelm-1.6b", "qwen2-moe-a2.7b",
                                  "rwkv6-7b", "hymba-1.5b", "qwen2-vl-2b",
                                  "whisper-medium", "starcoder2-15b"])
def test_cuda_prefill_decode_matches_host(cuda, name):
    """Each reduced family at f32: a prefill of 16 tokens and 40 decode
    tokens teacher-forced (past the window of 16 where there is one) on the
    card, against the same on the host: the logits (true vocab) after every
    call and every cache leaf at the end, per layer."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.api import tree_leaves, tree_map
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(reduced(get_config(name), seq=32),
                              dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 56), generator=g)
    batch = {"tokens": toks[:, :16]}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(2, cfg.vision_patches, cfg.d_model,
                                       generator=g)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                      generator=g)
    prefill = make_prefill_step(cfg, cache_len=60)
    serve = make_serve_step(cfg)
    runs = []
    for dev in ("cpu", cuda):
        params = tree_map(lambda t: t.to(dev), init_params(0, cfg, "cpu"))
        logits, cache = prefill(params, {k: v.to(dev)
                                         for k, v in batch.items()})
        out = [logits[..., :cfg.vocab]]
        for i in range(16, 56):
            logits, cache = serve(params, cache, toks[:, i:i + 1].to(dev), i)
            out.append(logits[..., :cfg.vocab])
        runs.append((out, tree_leaves(cache)))
    (host, host_cache), (card, card_cache) = runs
    for i, (a, b) in enumerate(zip(card, host)):
        assert a.device.type == "cuda"
        _close_to_host(a, b, f"{name} logits {i}")
    for a, b in zip(card_cache, host_cache):
        assert a.dtype == b.dtype and a.shape == b.shape
        for layer in range(a.shape[0]):
            _close_to_host(a[layer], b[layer], f"{name} cache layer {layer}")


def _serve_cli(*args, env=None):
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), **(env or {})}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, env=env,
                          cwd=root, timeout=600)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_cuda_serve_cli_reduced(cuda, device):
    """The serve front end refuses nothing at --reduced on either device."""
    out = _serve_cli("--device", device, "--reduced", "--arch",
                     "qwen2-moe-a2.7b", "--batch", "8", "--tokens", "4")
    assert out.returncode == 0, out.stderr
    assert f"device={device}" in out.stdout and "ms/token" in out.stdout


def test_cuda_serve_cli_refuses_when_the_card_is_hidden(cuda):
    """With the card hidden the default (the card) exits non-zero and does
    not fall back to the host."""
    out = _serve_cli("--tokens", "2", env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert "ms/token" not in out.stdout


# ---------------------------------------------------------------------------
# serving by model shard: a spread process's arithmetic against the
# one-process run's
# ---------------------------------------------------------------------------

class _Record:
    """The one-process run's collective: every "model" gather's stack of
    the T shards' parts, in order."""

    def __init__(self):
        self.stacks = []

    def gather(self, x, level, pods, *, key=None, to_first=False):
        self.stacks.append(x.clone())
        return x


class _Replay:
    """A process holding shard j alone: each gather hands over its part,
    which must be the one-process run's part of shard j bitwise, and gets
    the one-process run's stack back."""

    def __init__(self, stacks, j):
        self.stacks, self.j, self.i = stacks, j, 0

    def gather(self, x, level, pods, *, key=None, to_first=False):
        want = self.stacks[self.i]
        assert torch.equal(x[0], want[self.j]), (
            f"shard {self.j}: exchange {self.i} ({tuple(x.shape)}) differs "
            "from the one-process run's")
        self.i += 1
        return want


# (config, layers, requests (one client), prompt tokens, model shards)
SERVE_SHARD_SHAPES = [("stablelm-1.6b", 2, 2, 128, 2),
                      ("qwen2.5-32b", 1, 8, 128, 8)]


@pytest.mark.parametrize("name,layers,rows,prompt,t", SERVE_SHARD_SHAPES,
                         ids=[c[0] for c in SERVE_SHARD_SHAPES])
def test_serving_by_shard_is_each_shards_own_bits(cuda, monkeypatch, name,
                                                  layers, rows, prompt, t):
    """At full width (bf16, as served), one client of T shards: the
    by-shard prefill and two tokens of the split-KV decode in one process
    (the shards' weights views of the whole leaves, side by side) against
    each shard computed as a process that holds it alone does (its own
    contiguous copies of its weights and cache slice), every exchange
    replayed: each shard's part of every gather, the logits and its cache
    slice equal bitwise."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.api import tree_leaves
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import tp, transformer

    def gather(self, parts):  # every process's "model" gather, spread or not
        return self.comm.gather(parts.contiguous(), "model", self.pods)

    monkeypatch.setattr(tp.ModelShards, "gather", gather)
    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    cache_len = prompt + 8
    whole = transformer.init_params(0, cfg, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (rows, prompt + 2), generator=g,
                         device=cuda)
    base = steps.serve_shards(cfg, make_mesh((1, t)), cache_len)
    assert base.cache_axes[0] == 2  # the slots: the split-KV decode

    def run(ms, params):
        logits, cache = transformer.prefill(
            params, {"tokens": toks[:, :prompt]}, cfg, cache_len=cache_len,
            ms=ms)
        out = [logits]
        for i in (prompt, prompt + 1):
            logits, cache = transformer.decode_step(
                params, cache, toks[:, i:i + 1], i, cfg, ms=ms)
            out.append(logits)
        return out, tree_leaves(cache)

    record = _Record()
    want, want_cache = run(dataclasses.replace(base, comm=record), whole)
    for j in range(t):
        ms = dataclasses.replace(base, start=j, count=1,
                                 comm=_Replay(record.stacks, j))
        own = sharding.take_model_shards(whole, base.axes, slice(j, j + 1),
                                         t)
        got, cache = run(ms, own)
        assert ms.comm.i == len(record.stacks)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for a, b, ax in zip(cache, want_cache, base.cache_axes):
            n = b.shape[ax] // t
            assert torch.equal(a, b.narrow(ax, j * n, n))
        del own, cache, got
    torch.cuda.empty_cache()


class _RecordLevels:
    """The one-process run's collective: every gather's level and stack
    of every part, in order."""

    def __init__(self):
        self.stacks = []

    def gather(self, x, level, pods, *, key=None, to_first=False):
        self.stacks.append((level, x.clone()))
        return x


class _ReplayCell:
    """A process holding one (client c, shard j) cell of a T-shard mesh:
    each gather hands over its part (shard j over "model", part c T + j
    over "joint"), which must be the one-process run's bitwise, and gets
    the one-process run's stack back."""

    def __init__(self, stacks, c, j, t):
        self.stacks, self.c, self.j, self.t, self.i = stacks, c, j, t, 0

    def gather(self, x, level, pods, *, key=None, to_first=False):
        want_level, want = self.stacks[self.i]
        part = self.j if level == "model" else self.c * self.t + self.j
        assert level == want_level and torch.equal(x[0], want[part]), (
            f"cell ({self.c}, {self.j}): exchange {self.i} ({level}, "
            f"{tuple(x.shape)}) differs from the one-process run's")
        self.i += 1
        return want


# (config, layers, prompt tokens): long_500k's three configs (one
# request over 524,288 slots) at full width, cut to a layer or two, each
# prompt past its window; 8 tokens decoded
SERVE_JOINT_SHAPES = [("rwkv6-7b", 2, 128), ("hymba-1.5b", 2, 1152),
                      ("starcoder2-15b", 1, 4160)]


@pytest.mark.parametrize("name,layers,prompt", SERVE_JOINT_SHAPES,
                         ids=[c[0] for c in SERVE_JOINT_SHAPES])
def test_serving_joint_is_each_cells_own_bits(cuda, monkeypatch, name,
                                              layers, prompt):
    """long_500k's one request on the (4, 2) mesh (fewer than its 4 client
    ranks): every cache leaf split over the clients and the model shards
    jointly, prefill and decode by shard in one process (each shard's
    dense work once, a loop over the 8 joint parts wherever the cache is
    touched). At the config's bf16, against each (client, shard) cell
    computed as a process holding it alone does (its own copies of its
    weights and cache parts), every exchange replayed: each cell's part
    of every gather, every logit and its cache parts equal bitwise. At
    f32, the logits within tests/test_torch_serving.py's bound (1e-2 of
    the largest) of the whole layers' on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import INPUT_SHAPES
    from repro_torch.core.api import tree_leaves
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import tp, transformer

    def model_gather(self, parts):  # every gather, spread or not
        return self.comm.gather(parts.contiguous(), "model", self.pods)

    def parts_gather(self, parts):
        if self.comm is None:  # a whole leaf
            return parts
        return self.comm.gather(parts.contiguous(), self.level, self.pods)

    monkeypatch.setattr(tp.ModelShards, "gather", model_gather)
    monkeypatch.setattr(tp.Parts, "gather", parts_gather)
    long = INPUT_SHAPES["long_500k"]
    cache_len, n, (m, t) = long.seq_len, 8, (4, 2)
    mesh = make_mesh((m, t))
    g = torch.Generator(device=cuda).manual_seed(1)
    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    toks = torch.randint(0, cfg.vocab, (long.global_batch, prompt + n),
                         generator=g, device=cuda)
    base = steps.serve_shards(cfg, mesh, cache_len, batch=1)
    assert all(base.cache_joint)

    def run(cfg, ms, params):
        logits, cache = transformer.prefill(
            params, {"tokens": toks[:, :prompt]}, cfg, cache_len=cache_len,
            ms=ms)
        out = [logits]
        for i in range(prompt, prompt + n):
            logits, cache = transformer.decode_step(
                params, cache, toks[:, i:i + 1], i, cfg, ms=ms)
            out.append(logits)
        return out, cache

    record = _RecordLevels()
    stacked = dataclasses.replace(
        base, comm=record, joint=dataclasses.replace(base.joint,
                                                     comm=record))
    whole = transformer.init_params(0, cfg, cuda)
    want, want_cache = run(cfg, stacked, whole)
    for c in range(m):
        for j in range(t):
            replay = _ReplayCell(record.stacks, c, j, t)
            ms = dataclasses.replace(
                base, start=j, count=1, comm=replay,
                joint=tp.Parts(m * t, (c * t + j,), replay, 1, "joint"))
            own = sharding.take_model_shards(whole, base.axes,
                                             slice(j, j + 1), t)
            got, cache = run(cfg, ms, own)
            assert replay.i == len(record.stacks)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            for a, b in zip(tree_leaves(cache),
                            tree_leaves(transformer.cache_slice(want_cache,
                                                                ms))):
                assert torch.equal(a, b)
            del own, cache, got
    del whole, want, want_cache, record
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    whole = transformer.init_params(0, f32, cuda)
    by_shard, _ = run(f32, base, whole)
    plain, _ = run(f32, None, whole)
    for a, b in zip(by_shard, plain):
        a, b = a[..., :cfg.vocab], b[..., :cfg.vocab]
        assert float((a - b).abs().max()) <= 1e-2 * float(b.abs().max())
    del whole
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the trainer's layers on the card: the stream's device put, staged
# telemetry, checkpoints, the fleet's host round trip
# ---------------------------------------------------------------------------

def _same_states(a, b) -> bool:
    from repro_torch.core.api import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_cuda_prefetched_batches_equal_unprefetched(cuda):
    """DevicePut's side-stream copies, landed on the consuming stream, give
    the batches a synchronous stream gives, on the card."""
    import numpy as np

    from repro_torch.data.pipeline import DevicePut, make_batch_stream
    from repro_torch.data.reshuffle import ReshuffleSampler

    rng = np.random.default_rng(0)
    data = {"tokens": rng.integers(0, 500, (4, 5, 2, 9)).astype(np.int32),
            "x": rng.standard_normal((4, 5, 2, 3)).astype(np.float32)}
    streams = [make_batch_stream(data, ReshuffleSampler(4, 5, seed=1),
                                 local_steps=2, put=DevicePut(cuda),
                                 prefetch=p) for p in (True, False)]
    with streams[0] as a, streams[1] as b:
        for _ in range(7):
            got, want = next(a), next(b)
            assert got["tokens"].is_cuda
            for k in want:
                torch.cuda.synchronize()
                assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("extra", [[], ["--clients", "4"]],
                         ids=["loop", "fleet"])
def test_cuda_trainer_prefetch_and_telemetry_leave_the_state(cuda, tmp_path,
                                                            extra):
    """The reduced trainer on the card: prefetch and telemetry on give the
    state of both off, bitwise, and the fleet at cohort == population the
    state of the full-participation loop."""
    from repro_torch.launch import train

    base = ["--reduced", "--seq", "16", "--steps", "4", "--log-every", "10",
            "--agg", "diana", "--wire-dtype", "packed8"]
    on = train.main(base + extra + ["--telemetry",
                                    str(tmp_path / "t.jsonl")])
    off = train.main(base + ["--no-prefetch"])
    assert tuple(on.step.shape) == () and on.step.is_cuda
    assert _same_states(on, off)


def test_cuda_staged_scalars_equal_item(cuda, tmp_path):
    from repro_torch import telemetry

    x = torch.randn(5, device=cuda)
    loss = (x * x).sum()
    vec = x[:3]
    staged = telemetry.stage({"loss": loss, "vec": vec, "n": 3})
    assert isinstance(staged["loss"], telemetry.Staged)
    assert staged["n"] == 3
    assert staged["loss"].value() == loss.item()
    assert float(staged["loss"]) == loss.item()
    assert staged["vec"].value() == vec.tolist()
    path = str(tmp_path / "m.jsonl")
    with telemetry.MetricsSink(path) as sink:
        sink.round_metrics(0, {"loss": loss, "vec": vec})
        sink.counter("c", loss, round=0)
    ev = telemetry.read_events(path)
    assert ev[0]["metrics"] == {"loss": loss.item(), "vec": vec.tolist()}
    assert ev[1]["value"] == loss.item()


def test_cuda_train_state_checkpoint_round_trips(cuda, tmp_path):
    """A TrainState on the card (bf16 parameters, f32 slot tables) saved
    and restored onto the card, bitwise, dtypes and all."""
    from repro_torch.checkpoint import load_meta, restore_train_state, save_pytree
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.api import tree_leaves, tree_map
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import init_train_state

    cfg = reduced(get_config("stablelm-1.6b"))
    agg = CompressedAggregation(method="diana_rr", fraction=0.25, n_slots=2,
                                shift_dtype=torch.float32)
    state = init_train_state(0, cfg, agg, 4, mesh=make_mesh((4, 1)),
                             device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    state = state._replace(shifts=tree_map(
        lambda s: torch.randn(s.shape, generator=g, device=cuda),
        state.shifts))
    path = str(tmp_path / "s.ckpt")
    save_pytree(path, state, step=0, meta={"k": 1})
    like = init_train_state(0, cfg, agg, 4, mesh=make_mesh((4, 1)),
                            device="meta")
    back = restore_train_state(path, like, cuda)
    assert all(x.is_cuda for x in tree_leaves(back))
    assert any(x.dtype == torch.bfloat16 for x in tree_leaves(back))
    assert _same_states(back, state)
    assert load_meta(path) == {"step": 0, "meta": {"k": 1}}


# -- the wire spread over two processes on the one card (gloo) ----------------

SPREAD_CASES = [(shape, method, dt, lv) for shape in ((4, 1), (2, 2, 1))
                for method in ("q", "diana", "diana_rr", "ef")
                for dt, lv in (("f32", None), ("f32", 127), ("bf16", None),
                               ("packed8", None), ("packed4", None))]
_SPREAD_GRADS = {"emb": (4, 50, 24), "w": (4, 2, 40, 33), "b": (4, 37)}


def _spread_wire(comm, shape, method, dt, levels, cuda):
    """Three rounds of the shared wire on the process's ranks, the
    elastic weights (1, 0, 0.5, 1) on: each round's direction and the
    process's table rows, on the host, with the kernels' launches."""
    from repro_torch.core.api import tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import configure_agg

    agg = configure_agg(
        CompressedAggregation(method=method, fraction=0.3, n_slots=2,
                              wire_levels=levels, wire_dtype=dt,
                              shift_dtype=torch.float32, collective=comm),
        make_mesh(shape, ("pod", "data", "model")[-len(shape):]))
    own = comm.local("rank", agg.num_pods())
    g = torch.Generator(device=cuda).manual_seed(5)
    grads = {k: torch.randn(s, generator=g, device=cuda)[own]
             for k, s in _SPREAD_GRADS.items()}
    weight = torch.tensor([1.0, 0.0, 0.5, 1.0], device=cuda)[own]
    state = agg.init({k: v[0] for k, v in grads.items()}, 4)
    gen = torch.Generator(device=cuda).manual_seed(7)
    reset_launches()
    dirs = []
    for t in range(3):
        d, state = agg.aggregate(grads, state, gen, slot=t % 2,
                                 weight=weight)
        dirs.append({k: v.cpu().numpy() for k, v in d.items()})
    units = [] if state is None else [
        u for u, t in zip(agg.table_units(), state) for _ in tree_leaves(t)]
    # numpy, not tensors: a process's tensors would cross by a socket of
    # its own, gone once it exits
    return {"dirs": dirs,
            "tables": [x.cpu().numpy() for x in tree_leaves(state)],
            "units": units, "launches": dict(LAUNCHES)}


def _spread_worker(rank, init_file, out):
    from repro_torch.launch import distributed

    try:
        distributed.init_process_group("gloo", rank=rank, world_size=2,
                                       init_method=f"file://{init_file}")
        cuda = distributed.process_device("cuda", rank)
        comm = distributed.ProcessGroupCollective(4)
        res = [_spread_wire(comm, *case, cuda) for case in SPREAD_CASES]
        distributed.destroy_process_group()
        out.put((rank, res))
    except BaseException:
        import traceback

        out.put((rank, traceback.format_exc()))
        raise


@pytest.fixture(scope="module")
def spread_on_card(tmp_path_factory):
    """Each process's results of SPREAD_CASES at W = 2 over gloo, both
    processes on cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from repro_torch.kernels import _build

    _build.library()  # built once, before the processes load it
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init = tmp_path_factory.mktemp("pg") / "init"
    procs = [ctx.Process(target=_spread_worker, args=(r, str(init), out))
             for r in range(2)]
    for p in procs:
        p.start()
    results = [None, None]
    try:
        for _ in procs:
            rank, res = out.get(timeout=300)
            assert not isinstance(res, str), f"process {rank}:\n{res}"
            results[rank] = res
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.terminate()
    assert [p.exitcode for p in procs] == [0, 0]
    return results


@pytest.mark.parametrize("shape,method,dt,levels", SPREAD_CASES, ids=[
    f"{'x'.join(map(str, s))}-{m}-{dt}{lv or ''}"
    for s, m, dt, lv in SPREAD_CASES])
def test_spread_wire_on_the_card_equals_stacked(cuda, spread_on_card, shape,
                                                method, dt, levels):
    """Two processes on the one card over gloo give the stacked wire's
    bits on the kernels: every direction and each process's table rows;
    each process launches the wire's kernels."""
    from repro_torch.launch import distributed

    want = _spread_wire(distributed.StackedCollective(), shape, method, dt,
                        levels, cuda)
    i = SPREAD_CASES.index((shape, method, dt, levels))
    pods = shape[0] if len(shape) == 3 else 1
    for rank, res in enumerate(spread_on_card):
        got = res[i]
        lay = distributed.RankLayout(2, rank, 4, pods)
        for gd, wd in zip(got["dirs"], want["dirs"]):
            for k in wd:
                assert gd[k].tobytes() == wd[k].tobytes(), (rank, k)
        assert got["units"] == want["units"]
        for g, w, unit in zip(got["tables"], want["tables"], want["units"]):
            rows = {None: slice(None), "rank": lay.local_ranks,
                    "pod": lay.local_pods}[unit]
            assert g.shape == w[rows].shape, (rank, unit)
            assert g.tobytes() == w[rows].tobytes(), (rank, unit)
        assert got["launches"]["randk_compress"] > 0
        assert got["launches"]["randk_decompress"] > 0
        if dt.startswith("packed") or levels:
            assert got["launches"]["pack_slab"] > 0
            assert got["launches"]["unpack_slab"] > 0
        if dt.startswith("packed"):
            assert got["launches"]["unpack_reduce"] > 0
        if method in ("diana", "diana_rr"):
            assert got["launches"]["diana_shift_update"] > 0


# -- the model axis: the wire kernels at the model shards' shapes -------------

# each shard's rows at T = 2 (4 ranks, k/d = 0.02): stablelm-1.6b's
# embedding shard (50176, 2048) with kb = 125, its 24 layers' w_up / w_gate
# shards (24 * 2048, 2816), w_down (24 * 2816, 2048) and wo (24 * 1024,
# 2048) shards, and hymba's per-head ln shard, split on its last axis (25
# heads do not split in two): 32 * 25 rows of 32; and at T = 4 (the (2, 4)
# mesh of chip_smoke.py's phase 13 (g)) qwen2.5-32b's embedding shard
# (38016, 5120) with kb = 95 and one layer's w_up shard (5120, 6912); and
# at T = 2 the leaves the ssm and audio families' compute-sharded layers
# split that no case above has: rwkv6-7b's token-shift mu (32 layers x 5
# rows of 2048 columns a shard), its decay LoRA's wA (32 x 4096 rows of 32)
# and whisper-medium's cross-attention wq (24 x 1024 rows of 512)
SHARD_SHAPES = [("embed", 50176, 2048), ("w_up", 24 * 2048, 2816),
                ("w_down", 24 * 2816, 2048), ("wo", 24 * 1024, 2048),
                ("hymba_ln", 32 * 25, 32),
                ("qwen2.5-32b_embed_t4", 152064 // 4, 5120),
                ("qwen2.5-32b_w_up_t4", 5120, 27648 // 4),
                ("rwkv6_mu", 32 * 5, 4096 // 2),
                ("rwkv6_wA", 32 * 4096, 64 // 2),
                ("whisper_cross_wq", 24 * 1024, 1024 // 2)]


@pytest.mark.parametrize("name,n,d", SHARD_SHAPES,
                         ids=[s[0] for s in SHARD_SHAPES])
def test_wire_kernels_at_model_shard_shapes(cuda, gen, name, n, d):
    """randk_compress, randk_decompress, pack_slab, unpack_slab,
    unpack_reduce and diana_shift_update at a model shard's shape, a
    window that wraps, bitwise to their plain versions, one launch each."""
    from repro_torch.kernels.pack import pack_slab, unpack_reduce, unpack_slab
    from repro_torch.kernels.randk import randk_compress, randk_decompress

    nb = n // 8
    kb = max(1, int(0.02 * nb))
    rows = torch.randn(4, n, d, generator=gen, device=cuda)
    s = _start(cuda, nb - kb // 2)
    reset_launches()
    vals = randk_compress(rows, s, k_blocks=kb)
    dense = randk_decompress(vals, s, n_rows=n)
    assert torch.equal(vals, ref.randk_compress_ref(rows, s, k_blocks=kb))
    assert torch.equal(dense, ref.randk_decompress_ref(vals, s, n_rows=n))
    del rows, dense
    u = torch.rand(kb * 8, d, generator=gen, device=cuda)
    packed, scales = pack_slab(vals, u, levels=127)
    want_p, want_s = ref.pack_slab_ref(vals, u, levels=127)
    assert torch.equal(packed, want_p) and torch.equal(scales, want_s)
    own = unpack_slab(packed, scales, levels=127, n_rows=kb * 8)
    assert torch.equal(own, ref.unpack_slab_ref(packed, scales, levels=127,
                                                n_rows=kb * 8))
    mean = unpack_reduce(packed[None], scales[None], levels=127,
                         n_rows=kb * 8)
    assert torch.equal(mean, ref.unpack_reduce_ref(
        packed[None], scales[None], levels=127, n_rows=kb * 8))
    h = torch.randn(1, 4, kb * 8 * d, generator=gen, device=cuda)
    mh = torch.randn(1, kb * 8 * d, generator=gen, device=cuda)
    got = diana_shift_update(h, own.reshape(1, 4, -1), mh, mean.reshape(1, -1),
                             alpha=0.02)
    want = ref.diana_shift_update_ref(h, own.reshape(1, 4, -1), mh,
                                      mean.reshape(1, -1), 0.02, None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(LAUNCHES[k] == 1 for k in (
        "randk_compress", "randk_decompress", "pack_slab", "unpack_slab",
        "unpack_reduce", "diana_shift_update"))


@pytest.mark.parametrize("shape", [(4, 2), (2, 2, 2)])
@pytest.mark.parametrize("method,dt", [("diana_rr", "packed8"),
                                       ("diana", "f32"), ("ef", "bf16"),
                                       ("q", "packed4")])
def test_model_axis_wire_on_the_kernels_equals_plain(cuda, shape, method, dt):
    """The per-shard wire on the kernels gives the plain versions' bits:
    three rounds at T = 2 over a column, a row, a vocab, a per-head
    fallback and a replicated leaf, directions and tables."""
    from repro_torch.core.api import tree_leaves
    from repro_torch.core.dist import CompressedAggregation
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import configure_agg

    shapes = {"wq": (2, 64, 48), "wo": (2, 48, 64), "embed": (400, 32),
              "u": (5, 64), "scale": (37,)}
    params = {k: torch.zeros(v, device="meta") for k, v in shapes.items()}
    mesh = make_mesh(shape, ("pod", "data", "model")[-len(shape):])
    outs = []
    for backend in ("cuda", "reference"):
        agg = configure_agg(CompressedAggregation(
            method=method, fraction=0.1, n_slots=2, wire_dtype=dt,
            shift_dtype=torch.float32, backend=backend), mesh, params=params)
        g = torch.Generator(device=cuda).manual_seed(5)
        grads = {k: torch.randn((4, *v), generator=g, device=cuda)
                 for k, v in shapes.items()}
        state = agg.init({k: v[0] for k, v in grads.items()}, 4)
        gen = torch.Generator(device=cuda).manual_seed(7)
        reset_launches()
        dirs = []
        for t in range(3):
            d, state = agg.aggregate(grads, state, gen, slot=t % 2)
            dirs += tree_leaves(d)
        outs.append(dirs + tree_leaves(state))
        if backend == "cuda":
            assert LAUNCHES["randk_compress"] > 0
    assert all(torch.equal(a, b) for a, b in zip(*outs))
