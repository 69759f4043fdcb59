"""The port's examples (`repro_torch.examples`) and experiment3
(`repro_torch.experiments.experiment3`) on the host.

- Each example's `main` runs at a tiny size on the CPU.
- experiment3 with `RandK(fraction=1.0)` (k = d: the identity, so no
  compressor draw matters) follows the reference's `experiment3`
  (benchmarks/experiment3.py) for all four methods: the reference's
  initial parameters and its epochs' batch orders (from its key schedule)
  injected, two epochs. The final train losses agree to rtol 1e-4, not to
  f32 ulps: the tiny LM runs its forward in its config's bf16 on both
  sides, and the two frameworks round its activations after sums taken in
  other orders (measured 2.6e-5 at most). The uplink bits are the same
  Kahan f32 pair, bitwise.
- With compression (Rand-k at k/d = 0.05, the reference's default), the
  port's own draws, 20 epochs on the host reproduce the reference's
  claims (its run.py prints them): Q-RR ~ QSGD and DIANA-RR below DIANA.
  Measured at 10, 20 and 40 epochs: |Q-RR - QSGD| / QSGD = 1.6%, 0.55%
  and 1.2%; DIANA - DIANA-RR = 0.35, 0.74 and 0.73. 20 epochs take about
  11 s; the test asks for Q-RR within 10% of QSGD and DIANA-RR below
  DIANA.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro.core.algorithms import ALGORITHMS as JAX_ALGORITHMS
from repro.core.algorithms import _sample_round_indices
from repro.models import transformer as jax_transformer
from repro_torch import experiments
from repro_torch.compression.ops import RandK
from repro_torch.convert import params_from_jax
from repro_torch.examples import (
    federated_logreg,
    quickstart,
    serve_decode,
    train_lm_diana_rr,
)

ROOT = Path(__file__).resolve().parents[1]
METHODS = ("qsgd", "q_rr", "diana", "diana_rr")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def test_quickstart_runs():
    out = quickstart.main(["--device", "cpu", "--epochs", "3"])
    assert sorted(out) == sorted(METHODS)
    assert all(np.isfinite(v) and v > 0 for v in out.values())


def test_federated_logreg_runs(capsys):
    rows = federated_logreg.main(["--device", "cpu", "--epochs", "2",
                                  "--quick"])
    names = [r[0] for r in rows]
    assert names[:4] == [f"exp1/{m}" for m in METHODS]
    assert "exp2/diana_nastya" in names and "bits/diana_rr" in names
    assert all(np.isfinite(r[2]) for r in rows)
    assert "name,us_per_epoch_or_bits" in capsys.readouterr().out


def test_serve_decode_runs(capsys):
    ids = serve_decode.main(["--device", "cpu", "--reduced", "--arch",
                             "stablelm-1.6b", "--batch", "8", "--tokens",
                             "3"])
    assert len(ids) == 4
    assert "OK: all generated ids in-vocab" in capsys.readouterr().out


def test_train_lm_diana_rr_runs():
    first, last = train_lm_diana_rr.main(
        ["--device", "cpu", "--steps", "2", "--seq", "8", "--log-every",
         "1"])
    assert np.isfinite(first) and np.isfinite(last)


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        serve_decode.main(["--reduced"])
    assert exc.value.code == 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(["--epochs", "1"])


def _reference_experiment3():
    path = ROOT / "benchmarks" / "experiment3.py"
    spec = importlib.util.spec_from_file_location("jax_experiment3", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_orders(name, e, seed=0, m=4, n=4):
    """Epoch e's (M, n) batch order as the reference's epoch draws it:
    key, k = split(key) per epoch, then split(k)[0] for the order."""
    key = jax.random.PRNGKey(seed)
    for _ in range(e + 1):
        key, k = jax.random.split(key)
    k_idx, _ = jax.random.split(k)
    order = _sample_round_indices(JAX_ALGORITHMS[name], k_idx, m, n)
    return torch.from_numpy(np.array(order))


@pytest.fixture(scope="module")
def identity_runs():
    ref = _reference_experiment3()
    want = ref.experiment3(epochs=2, fraction=1.0)
    p0 = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                      jax_transformer.init_params(jax.random.key(0), ref.CFG))
    got = experiments.experiment3(2, fraction=1.0, device="cpu",
                                  params=params_from_jax(p0, device="cpu"),
                                  orders=_reference_orders)
    return got, want


@pytest.mark.parametrize("method", METHODS)
def test_experiment3_identity_matches_reference(identity_runs, method):
    got, want = identity_runs
    (name, loss, bits), = [r for r in got if r[0] == f"exp3/{method}"]
    (_, want_loss, want_bits), = [r for r in want if r[0] == name]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    assert np.float32(bits).tobytes() == np.float32(want_bits).tobytes()


def test_experiment3_reproduces_the_claims():
    rows = {n.split("/")[1]: (loss, bits) for n, loss, bits in
            experiments.experiment3(20, device="cpu")}
    assert sorted(rows) == sorted(METHODS)
    assert all(np.isfinite(v[0]) for v in rows.values())
    loss = {k: v[0] for k, v in rows.items()}
    assert abs(loss["q_rr"] - loss["qsgd"]) < 0.1 * loss["qsgd"]
    assert loss["diana_rr"] < loss["diana"]
    # every method sends the same compressed bits a round
    assert len({v[1] for v in rows.values()}) == 1


def test_experiments_cli_runs_experiment3(capsys):
    experiments.main(["--exp", "3", "--device", "cpu", "--epochs", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "name,final_train_loss,bits_uplinked"
    assert [line.split(",")[0] for line in out[2:6]] == [
        f"exp3/{m}" for m in METHODS]
    assert out[-1].startswith("# kernel launches:")
