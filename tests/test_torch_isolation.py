"""The port stands alone: importing it pulls in neither JAX nor the JAX
package (nor `msgpack` or `ml_dtypes`, which the card's machine lacks),
its entry points run on the card unless the caller names the CPU, and its
smoke script fails where there is no card or no port."""
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import convert, experiments
from repro_torch.configs import get_config, reduced
from repro_torch.core.dist import CompressedAggregation
from repro_torch.data.logreg import make_federated_logreg
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.randk import randk_mask
from repro_torch.launch.steps import init_train_state
from repro_torch.models.transformer import init_params

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                       "repro_torch."))


def _python(code, cwd=ROOT, **env):
    full = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **env}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=300)


def test_every_module_is_covered():
    assert {"repro_torch.experiments", "repro_torch.convert",
            "repro_torch.kernels._build", "repro_torch.core.algorithms",
            "repro_torch.compression.backend", "repro_torch.core.dist",
            "repro_torch.kernels.pack", "repro_torch.launch.steps",
            "repro_torch.launch.mesh", "repro_torch.launch.serve",
            "repro_torch.models.transformer",
            "repro_torch.optim.optimizers", "repro_torch.configs",
            "repro_torch.data.tokens", "repro_torch.core.salts",
            "repro_torch.telemetry.events", "repro_torch.telemetry.trace",
            "repro_torch.telemetry.sink", "repro_torch.telemetry.__main__",
            "repro_torch.checkpoint.io", "repro_torch.data.pipeline",
            "repro_torch.data.paging", "repro_torch.fleet.cohort",
            "repro_torch.fleet.chaos", "repro_torch.fleet.store",
            "repro_torch.fleet.driver", "repro_torch.launch.train"} <= set(
                MODULES)


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for name in {MODULES!r}: importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton', 'msgpack', 'ml_dtypes'))\n"
            "print(bad)\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_need_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("stablelm-1.6b"))
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda:0"),
                 lambda: make_federated_logreg(m=2, n_batches=2, batch=2, d=3),
                 lambda: experiments.make_problem("paper"),
                 lambda: convert.params_from_jax({"w": [0.0]}),
                 lambda: experiments.main(["--epochs", "1"]),
                 lambda: init_params(0, cfg),
                 lambda: init_train_state(0, cfg, CompressedAggregation(), 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    problem = make_federated_logreg(m=2, n_batches=2, batch=2, d=3, device="cpu")
    assert problem.data["a"].device.type == "cpu"


def test_experiments_main_reports_backend_and_launches(capsys):
    """The entry point says which backend ran and how often each kernel
    launched (none on the CPU: the plain versions ran)."""
    experiments.main(["--device", "cpu", "--epochs", "1"])
    out = capsys.readouterr().out.splitlines()
    assert "backend=cuda" in out[0]
    assert len([r for r in out if r.startswith("exp")]) == 8
    assert out[-1] == ("# kernel launches: {'randk_mask': 0, "
                       "'diana_shift_update': 0, 'qsgd_quantize': 0, "
                       "'randk_compress': 0, 'randk_decompress': 0, "
                       "'pack_slab': 0, 'unpack_slab': 0, "
                       "'unpack_reduce': 0}")


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, 1024, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        randk_mask(x, torch.zeros(2, dtype=torch.int32, device="meta"), d=1000,
                   k=5)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    assert _build.library_path().parent == tmp_path
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    """An edited source gets a new library name, so no stale build loads."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    with open(csrc / _build.SOURCES[0], "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path() != before


def test_chip_smoke_fails_without_a_card_or_the_port(tmp_path):
    """No result line without CUDA, and none from a directory that holds the
    script and nothing else of the repository."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    procs = [subprocess.Popen([sys.executable, str(script)], cwd=cwd,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                                 (tmp_path, alone))]
    for proc in procs:  # both at once: each spends seconds importing torch
        stdout, _ = proc.communicate(timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in stdout
