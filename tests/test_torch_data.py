"""The port's data layer, state helpers and converters against the JAX
reference: byte-equal logreg arrays, identical sampler orders, the loss and
its per-client gradients, the Kahan bits pair, and the converters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro.core.api import accumulate_bits as jax_accumulate_bits
from repro.core.api import clients_grad as jax_clients_grad
from repro.core.api import clients_grad_at as jax_clients_grad_at
from repro.core.api import tree_mean_clients as jax_tree_mean_clients
from repro.core.algorithms import ALGORITHMS as JAX_ALGORITHMS
from repro.core.algorithms import init_algorithm as jax_init_algorithm
from repro.data.logreg import make_federated_logreg as jax_make_logreg
from repro.data.reshuffle import ReshuffleSampler as JaxSampler
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core.algorithms import ALGORITHMS, init_algorithm
from repro_torch.core.api import (
    accumulate_bits,
    clients_grad,
    clients_grad_at,
    tree_flatten,
    tree_map,
    tree_mean_clients,
)
from repro_torch.data.logreg import make_federated_logreg
from repro_torch.data.pipeline import epoch_generator, run_epochs
from repro_torch.data.reshuffle import ReshuffleSampler

# float32 gradients of the same loss through two autodiff systems: the
# operations match but XLA fuses and reorders the mean's sum, so the
# per-client gradients agree to a few f32 ulps of their scale, not bitwise
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


@pytest.mark.parametrize("kw", [
    dict(m=8, n_batches=6, batch=6, d=16, cond=20.0, seed=3),
    dict(m=20, n_batches=10, batch=10, d=100, cond=1e3, seed=0),
    dict(m=4, n_batches=5, batch=3, d=7, cond=50.0, seed=1, heterogeneous=False),
], ids=["tests", "paper", "homogeneous"])
def test_logreg_problem_is_byte_equal(kw):
    ref = jax_make_logreg(**kw)
    port = make_federated_logreg(device="cpu", **kw)
    for name in ("a", "y"):
        want = np.asarray(ref.data[name])
        got = port.data[name].numpy()
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
    for attr in ("lam", "l_smooth", "l_max", "mu", "f_star"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.x_star.tobytes() == ref.x_star.tobytes()
    w = np.linspace(-1, 1, port.d).astype(np.float32)
    assert port.suboptimality(torch.from_numpy(w)) == ref.suboptimality(w)


@pytest.mark.parametrize("mode", ["rr", "rr_once", "rr_shared", "wr"])
def test_sampler_orders_are_identical(mode):
    ref = JaxSampler(7, 9, mode=mode, seed=5)
    port = ReshuffleSampler(7, 9, mode=mode, seed=5)
    for e in range(4):
        want, got = ref.epoch_order(e), port.epoch_order(e)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert port.spec() == ref.spec()
    assert port.batch_index(3, 20) == ref.batch_index(3, 20)


PROBLEM = make_federated_logreg(m=8, n_batches=6, batch=6, d=16, cond=20.0,
                                seed=3, device="cpu")
JPROBLEM = jax_make_logreg(m=8, n_batches=6, batch=6, d=16, cond=20.0, seed=3)


def test_loss_matches_reference():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16,)).astype(np.float32) * 3.0  # |z| > 20 occurs
    batch = {k: v[:, 2].reshape(-1, *v.shape[3:]) for k, v in PROBLEM.data.items()}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    got = float(PROBLEM.loss_fn()({"w": torch.from_numpy(w)}, batch))
    want = float(JPROBLEM.loss_fn()({"w": jnp.asarray(w)}, jbatch))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_clients_grad_matches_reference():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(16,)).astype(np.float32)
    ws = rng.normal(size=(8, 16)).astype(np.float32)
    col = np.array([0, 5, 2, 2, 1, 4, 3, 0])
    batches = {k: v[torch.arange(8), torch.from_numpy(col)]
               for k, v in PROBLEM.data.items()}
    jbatches = {k: jnp.asarray(v.numpy()) for k, v in batches.items()}
    got = clients_grad(PROBLEM.loss_fn(), {"w": torch.from_numpy(w)}, batches)
    want = jax_clients_grad(JPROBLEM.loss_fn(), {"w": jnp.asarray(w)}, jbatches)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    got = clients_grad_at(PROBLEM.loss_fn(), {"w": torch.from_numpy(ws)}, batches)
    want = jax_clients_grad_at(JPROBLEM.loss_fn(), {"w": jnp.asarray(ws)}, jbatches)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    mean = tree_mean_clients(got)["w"].numpy()
    np.testing.assert_allclose(mean, np.asarray(jax_tree_mean_clients(want)["w"]),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_accumulate_bits_is_the_reference_kahan_pair():
    """Same f32 operations in the same order: bitwise, including far past
    2^24 x the increment where a plain f32 sum stops moving."""
    inc = 3.0 * 610 * 8
    tb, tlo = torch.full((), 2.0**40), torch.zeros(())
    jb, jlo = jnp.full((), 2.0**40, jnp.float32), jnp.zeros((), jnp.float32)
    for _ in range(3000):
        tb, tlo = accumulate_bits(tb, tlo, inc)
        jb, jlo = jax_accumulate_bits(jb, jlo, inc)
    assert tb.numpy().tobytes() == np.asarray(jb).tobytes()
    assert tlo.numpy().tobytes() == np.asarray(jlo).tobytes()
    # the pair holds the total as bits - bits_lo
    assert float(tb) - float(tlo) == pytest.approx(2.0**40 + 3000 * inc, rel=1e-12)


def test_tree_flatten_uses_the_reference_leaf_order():
    tree = {"w": torch.zeros(2), "b": (torch.ones(1), None, [torch.ones(3)]),
            "a": torch.ones(4)}
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    leaves, unflatten = tree_flatten(tree)
    assert [t.numel() for t in leaves] == [x.size for x in jax.tree.leaves(jtree)]
    back = unflatten(leaves)
    assert back.keys() == tree.keys() and back["b"][1] is None
    assert tree_map(lambda t: t + 1, tree)["b"][2][0].tolist() == [2.0] * 3


@pytest.mark.parametrize("name", sorted(ALGORITHMS))
def test_init_algorithm_layouts_match_reference(name):
    got = init_algorithm(ALGORITHMS[name], {"w": torch.zeros(16)}, 8, 6)
    want = jax_init_algorithm(JAX_ALGORITHMS[name], {"w": jnp.zeros(16)}, 8, 6)
    for field in ("shifts", "server_h"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None)
        if g is not None:
            assert tuple(g["w"].shape) == w["w"].shape
    assert got.rounds.dtype == torch.int32 and got.bits.dtype == torch.float32


def test_state_from_jax_converts_every_field():
    want = jax_init_algorithm(JAX_ALGORITHMS["diana_nastya"],
                              {"w": jnp.arange(16.0)}, 8, 6)
    want = want._replace(shifts={"w": jnp.full((8, 16), 0.5)},
                         rounds=jnp.int32(7), bits=jnp.float32(2.0**30),
                         bits_lo=jnp.float32(-3.0))
    got = state_from_jax(jax.device_get(want), device="cpu")
    assert got.params["w"].tolist() == list(range(16))
    assert (got.shifts["w"] == 0.5).all() and got.server_h["w"].shape == (16,)
    assert (int(got.rounds), float(got.bits), float(got.bits_lo)) == (7, 2.0**30, -3.0)
    assert got.rounds.dtype == torch.int32 and got.bits_lo.dtype == torch.float32
    assert params_from_jax(None, device="cpu") is None


def test_run_epochs_is_stateless_per_epoch():
    """Epoch e's generator is a pure function of (seed, e): stopping after
    epoch 1 and resuming at epoch 2 gives the uninterrupted run's state."""
    from repro_torch.compression.ops import RandK
    from repro_torch.core.algorithms import make_epoch_fn

    spec, epoch = make_epoch_fn("diana_rr", PROBLEM.loss_fn(), RandK(fraction=0.25),
                                gamma=0.01)
    sampler = ReshuffleSampler(8, 6, mode="rr_once", seed=2)
    st0 = init_algorithm(spec, {"w": torch.zeros(16)}, 8, 6)
    full = run_epochs(epoch, st0, PROBLEM.data, sampler, epochs=4, seed=9)
    half = run_epochs(epoch, st0, PROBLEM.data, sampler, epochs=2, seed=9)
    resumed = run_epochs(epoch, half, PROBLEM.data, sampler, epochs=2, seed=9,
                         start_epoch=2)
    assert torch.equal(full.params["w"], resumed.params["w"])
    assert torch.equal(full.shifts["w"], resumed.shifts["w"])
    assert not torch.equal(st0.shifts["w"], full.shifts["w"])
    assert (st0.shifts["w"] == 0).all()  # the caller's state is untouched
    a = torch.rand(4, generator=epoch_generator(9, 3, "cpu"))
    assert torch.equal(a, torch.rand(4, generator=epoch_generator(9, 3, "cpu")))
