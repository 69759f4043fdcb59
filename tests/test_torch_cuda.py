"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine with only PyTorch and CUDA:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Comparisons are bitwise (`torch.equal`): each kernel keeps its plain
version's float operation order (see `repro_torch/kernels/ref.py`).
"""
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
