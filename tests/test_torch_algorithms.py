"""The port's fourteen federated methods against the JAX reference.

Trajectory parity: the same data, the same sampler orders and the same
compressor draws go through both packages. JAX's threefry draws cannot be
made in torch, so `jax_draws` rebuilds them from the reference's key
schedule (fold_in(key, e) -> split -> split(k_comp, n) for non-local epochs,
k_comp itself for local ones -> randint / uniform) and the port's epochs
take them through `draws=`. Each case starts once from zero and once from
the reference's own mid-run state (non-zero shift tables, server_h, bits),
converted with `repro_torch.convert.state_from_jax`.

Tolerance: rtol 1e-5, atol 1e-6 on every state leaf after two epochs. Both
sides do the same f32 operations, but in another order where it does not
change the math: XLA sums the loss's mean and the client mean in its own
order and, inside a jitted epoch, fuses `p - gamma * d` and `h + alpha * q`
into single-rounding multiply-adds. Those differences stay a few f32 ulps
per round; a wrong shift rule, stepsize, slot or draw misses by orders of
magnitude more.

tests/test_torch_theorems.py repeats the behavioural claims of
tests/test_algorithms.py on the port, with the port's own draws.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro.compression.ops import Identity as JIdentity
from repro.compression.ops import QSGDQuantizer as JQSGD
from repro.compression.ops import RandK as JRandK
from repro.compression.ops import TopK as JTopK
from repro.core.algorithms import init_algorithm as jax_init_algorithm
from repro.core.algorithms import make_epoch_fn as jax_make_epoch_fn
from repro.data.logreg import make_federated_logreg as jax_make_logreg
from repro.data.pipeline import run_epochs as jax_run_epochs
from repro.data.reshuffle import ReshuffleSampler as JaxSampler
from repro_torch import experiments
from repro_torch.compression.ops import Identity, QSGDQuantizer, RandK, TopK
from repro_torch.convert import state_from_jax
from repro_torch.core.algorithms import (
    ALGORITHMS,
    init_algorithm,
    make_epoch_fn,
    make_round_fn,
)
from repro_torch.data.logreg import make_federated_logreg
from repro_torch.data.pipeline import run_epochs
from repro_torch.data.reshuffle import ReshuffleSampler

RTOL, ATOL = 1e-5, 1e-6
KW = dict(m=8, n_batches=6, batch=6, d=16, cond=20.0, seed=3)
JPROBLEM = jax_make_logreg(**KW)
PROBLEM = make_federated_logreg(device="cpu", **KW)
COMPRESSORS = {
    "identity": (JIdentity(), Identity()),
    "randk": (JRandK(fraction=0.25), RandK(fraction=0.25)),
    "qsgd": (JQSGD(levels=8), QSGDQuantizer(levels=8)),
    "topk": (JTopK(fraction=0.25), TopK(fraction=0.25)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def jax_draws(name, jcomp, e, *, seed, m, n, d):
    """Epoch e's compressor draws as the reference takes them from its key."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), e)
    _, k_comp = jax.random.split(key)
    local = ALGORITHMS[name].family == "local"
    keys = k_comp[None] if local else jax.random.split(k_comp, n)
    if isinstance(jcomp, JRandK):
        field = "starts"
        vals = jax.vmap(lambda k: jax.random.randint(k, (m,), 0, d))(keys)
    elif isinstance(jcomp, JQSGD):
        field, dp = "u", -(-d // 1024) * 1024
        vals = jax.vmap(lambda k: jax.random.uniform(k, (m, dp)))(keys)
    else:
        return None
    vals = np.array(vals)
    return {field: torch.from_numpy(vals[0] if local else vals)}


def _cases():
    out = []
    for name, spec in sorted(ALGORITHMS.items()):
        if not spec.default_compressed:
            out.append((name, "identity"))
        elif spec.shift_mode == "ef":
            out.append((name, "topk"))
        else:
            out += [(name, "randk"), (name, "qsgd")]
    return out


def _stepsizes(name):
    gamma = 0.5 / PROBLEM.l_max
    if ALGORITHMS[name].family == "local":
        gamma /= PROBLEM.n
        return dict(gamma=gamma, eta=3.0 * gamma * PROBLEM.n)
    return dict(gamma=gamma)


def _sampler(name, cls, seed):
    mode = "rr_once" if name == "diana_rr" else ALGORITHMS[name].sampling
    return cls(PROBLEM.m, PROBLEM.n, mode=mode, seed=seed)


@functools.lru_cache(maxsize=None)
def jax_trajectory(name, comp_name, backend, seed=4):
    """The reference's states after epochs 2 and 4, as numpy trees."""
    spec, epoch = jax_make_epoch_fn(name, JPROBLEM.loss_fn(),
                                    COMPRESSORS[comp_name][0],
                                    backend=backend, **_stepsizes(name))
    st = jax_init_algorithm(spec, {"w": jnp.zeros((PROBLEM.d,))}, PROBLEM.m,
                            PROBLEM.n)
    states = {}
    jax_run_epochs(epoch, st, JPROBLEM.data, _sampler(name, JaxSampler, seed),
                   epochs=4, key=jax.random.PRNGKey(seed),
                   callback=lambda e, s: states.__setitem__(e + 1, jax.device_get(s)))
    return states[2], states[4]


def _port_epochs(name, comp_name, state, start, seed=4):
    jcomp, comp = COMPRESSORS[comp_name]
    spec, epoch = make_epoch_fn(name, PROBLEM.loss_fn(), comp, backend="cuda",
                                **_stepsizes(name))
    if state is None:
        state = init_algorithm(spec, {"w": torch.zeros(PROBLEM.d)}, PROBLEM.m,
                               PROBLEM.n)
    draws = functools.partial(jax_draws, name, jcomp, seed=seed, m=PROBLEM.m,
                              n=PROBLEM.n, d=PROBLEM.d)
    return run_epochs(epoch, state, PROBLEM.data,
                      _sampler(name, ReshuffleSampler, seed), epochs=2,
                      seed=seed, start_epoch=start, draws=draws)


def _assert_state_close(got, want):
    for field in ("params", "shifts", "server_h"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            np.testing.assert_allclose(g["w"].numpy(), np.asarray(w["w"]),
                                       rtol=RTOL, atol=ATOL, err_msg=field)
    assert int(got.rounds) == int(want.rounds)
    # the Kahan pair runs the same f32 operations in the same order: bitwise
    assert got.bits.numpy().tobytes() == np.asarray(want.bits).tobytes()
    assert got.bits_lo.numpy().tobytes() == np.asarray(want.bits_lo).tobytes()


@pytest.mark.parametrize("start", ["zero", "mid_run"])
@pytest.mark.parametrize("name,comp_name", _cases())
def test_trajectory_matches_reference(name, comp_name, start):
    mid, end = jax_trajectory(name, comp_name, "reference")
    if start == "zero":
        got, want = _port_epochs(name, comp_name, None, 0), mid
    else:
        got = _port_epochs(name, comp_name, state_from_jax(mid, device="cpu"), 2)
        want = end
    _assert_state_close(got, want)


@pytest.mark.parametrize("name", ["q_rr", "diana", "diana_rr", "diana_nastya"])
def test_trajectory_matches_reference_pallas_backend(name):
    """The same parity against the reference run on its Pallas kernels."""
    mid, end = jax_trajectory(name, "randk", "pallas")
    got = _port_epochs(name, "randk", state_from_jax(mid, device="cpu"), 2)
    _assert_state_close(got, end)


def test_make_round_fn_is_one_epoch_step():
    """make_round_fn's round, applied over an epoch's columns, is the epoch."""
    name, (jcomp, comp) = "diana", COMPRESSORS["randk"]
    draws = jax_draws(name, jcomp, 0, seed=4, m=8, n=6, d=16)
    spec, epoch = make_epoch_fn(name, PROBLEM.loss_fn(), comp, gamma=0.02)
    _, round_fn = make_round_fn(name, PROBLEM.loss_fn(), comp, gamma=0.02)
    st = init_algorithm(spec, {"w": torch.zeros(16)}, 8, 6)
    order = torch.from_numpy(_sampler(name, ReshuffleSampler, 4).epoch_order(0))
    want = epoch(st, PROBLEM.data, None, order, draws)
    params, shifts = st.params, st.shifts
    for i in range(6):
        params, shifts = round_fn(params, shifts, PROBLEM.data, order[:, i].long(),
                                  None, draws["starts"][i])
    assert torch.equal(params["w"], want.params["w"])
    assert torch.equal(shifts["w"], want.shifts["w"])
    with pytest.raises(ValueError, match="local-family"):
        make_round_fn("q_nastya", PROBLEM.loss_fn(), comp, gamma=0.02)


# ---------------------------------------------------------------------------
# the paper-table experiments at the reference's _problem size
# ---------------------------------------------------------------------------

def _jax_experiments():
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "experiments.py"
    spec = importlib.util.spec_from_file_location("jax_paper_experiments", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("which", ["experiment1", "experiment2"])
def test_experiment_rows_match_reference(which, monkeypatch):
    monkeypatch.setenv("REPRO_COMPRESSION_BACKEND", "reference")
    problem = experiments.make_problem("paper", cond=100.0, device="cpu")
    jcomp = JRandK(fraction=0.02)
    draws = lambda name, e: jax_draws(name, jcomp, e, seed=0, m=problem.m,
                                      n=problem.n, d=problem.d)
    want = getattr(_jax_experiments(), which)(epochs=3, quick=True)
    got = getattr(experiments, which)(epochs=3, quick=True, device="cpu",
                                      draws=draws)
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=RTOL, atol=ATOL)


def test_communication_table_matches_reference(monkeypatch):
    """Uplink bits are the same Kahan f32 pair on both sides (bitwise); the
    suboptimalities agree within the trajectory tolerance."""
    monkeypatch.setenv("REPRO_COMPRESSION_BACKEND", "reference")
    problem = experiments.make_problem("paper", cond=100.0, device="cpu")

    def draws(name, e):
        jcomp = JRandK(fraction=0.02 if ALGORITHMS[name].default_compressed else 1.0)
        return jax_draws(name, jcomp, e, seed=0, m=problem.m, n=problem.n,
                         d=problem.d)

    want = _jax_experiments().communication_table(epochs=2)
    got = experiments.communication_table(epochs=2, device="cpu", draws=draws)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=RTOL, atol=ATOL)
