"""The port's production trainer (`python -m repro_torch.launch.train`) on
the host (`--device cpu --reduced`).

- `--resume` bit-reproduces an uninterrupted run (every state leaf equal)
  when the run is cut mid-epoch: on the flat mesh, on 2-pod DIANA-NASTYA
  (2 local steps), packed8 DIANA-RR on 2 pods, a fleet run (population 8)
  and a buffered-async fleet under chaos on a paged data store.
- The run with `--telemetry` equals the run without it, bitwise, and its
  JSONL passes the telemetry CLI.
- The fleet at `--clients 4` (cohort == population) equals the
  full-participation run, bitwise.
- The module docstring's examples parse; the reference's refusals hold
  (diana_rr without rr_shared, the fleet and async gates, the resume
  refusals), the production meshes exit before allocating where a
  process's state does not fit, naming its bytes and the device's, and
  without a card the default device exits 1 and says why.
- The trainer builds the reference trainer's meshes: (4, 2), (pods, 4 /
  pods, 2), (16, 16) and (2, 16, 16), and any flat mesh `--mesh CxT`
  names; `--dry-run` sizes one process of a mesh spread one cell a
  process on the meta device and exits 0 where it fits an H100, else 2,
  naming the largest term.
- The modality stubs equal the reference's `stub_modalities`, bitwise,
  and the salt registry the reference's; a step's generator is a pure
  function of (seed, salt, step).
"""
import shlex

import ml_dtypes
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro_torch.configs import get_config, reduced
from repro_torch.core.api import tree_leaves
from repro_torch.launch import train
from repro_torch.telemetry import read_events, validate_events

BASE = ["--device", "cpu", "--reduced", "--seq", "8", "--log-every", "100"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _run(*argv):
    return train.main(BASE + list(argv))


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


RESUME_CASES = {
    "flat": [],
    "nastya_2pod": ["--pods", "2", "--local-steps", "2", "--eta", "0.2"],
    "diana_rr_packed8_2pod": ["--pods", "2", "--agg", "diana_rr",
                              "--sampling", "rr_shared", "--wire-dtype",
                              "packed8"],
    "fleet": ["--clients", "8"],
    "async_chaos_paged": ["--clients", "8", "--buffer-k", "3", "--late",
                          "drop", "--chaos-dropout", "0.2",
                          "--chaos-straggler", "0.3", "--chaos-store-fail",
                          "0.2", "--data-store", "{tmp}/ds"],
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_bit_reproduces_uninterrupted_run(case, tmp_path):
    flags = [f.format(tmp=tmp_path) for f in RESUME_CASES[case]]
    ckpt = str(tmp_path / "run.ckpt")
    whole = _run("--steps", "5", *flags)
    _run("--steps", "3", "--checkpoint", ckpt, *flags)  # mid-epoch (of 8)
    resumed = _run("--steps", "5", "--resume", ckpt, *flags)
    assert _equal(resumed, whole)


def test_telemetry_on_equals_off_and_validates(tmp_path, capsys):
    tel, trace = str(tmp_path / "t.jsonl"), str(tmp_path / "t.json")
    on = _run("--steps", "3", "--telemetry", tel, "--trace", trace)
    off = _run("--steps", "3", "--no-prefetch")
    assert _equal(on, off)
    events = read_events(tel)
    assert validate_events(events) == []
    kinds = {e["kind"] for e in events}
    assert kinds == {"run_meta", "round_metrics", "span", "counter"}
    assert [e["round"] for e in events if e["kind"] == "round_metrics"] == [
        0, 1, 2]
    from repro_torch.telemetry.__main__ import main as cli

    capsys.readouterr()
    assert cli([tel, "--validate", "--summary"]) == 0
    assert "schema OK" in capsys.readouterr().out


def test_full_cohort_fleet_equals_full_participation():
    assert _equal(_run("--steps", "4", "--clients", "4"),
                  _run("--steps", "4"))


def test_docstring_examples_parse():
    doc = train.__doc__
    examples = [line for line in doc.replace("\\\n", " ").splitlines()
                if "python -m repro_torch.launch.train" in line]
    assert len(examples) == 2
    for ex in examples:
        argv = shlex.split(ex.split("repro_torch.launch.train", 1)[1])
        args = train.build_parser().parse_args(argv)
        assert args.steps > 0


REFUSALS = [
    (["--agg", "diana_rr"], "needs --sampling rr_shared"),
    (["--clients", "2"], "< mesh client ranks"),
    (["--agg", "diana_rr", "--sampling", "rr_shared", "--clients", "6"],
     "divisible by the mesh client count"),
    (["--clients", "8", "--buffer-k", "2", "--local-steps", "2"],
     "need --local-steps 1"),
    (["--chaos-dropout", "0.1"], "are fleet knobs"),
    (["--pods", "3"], "--pods must be 1, 2 or 4"),
    (["--production-mesh", "--arch", "dbrx-132b"], "does not fit"),
    (["--multi-pod", "--arch", "dbrx-132b"], "does not fit"),
]


@pytest.mark.parametrize("argv,match", REFUSALS,
                         ids=[r[1].split()[-1] for r in REFUSALS])
def test_cli_refusals(argv, match, capsys):
    with pytest.raises(SystemExit) as exc:
        _run("--steps", "1", *argv)
    assert exc.value.code == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("argv,shape", [
    ([], (4, 2)), (["--pods", "2"], (2, 2, 2)), (["--pods", "4"], (4, 1, 2)),
    (["--production-mesh"], (16, 16)), (["--multi-pod"], (2, 16, 16)),
    (["--production-mesh", "--multi-pod"], (2, 16, 16))])
def test_meshes_are_the_reference_trainers(argv, shape, capsys):
    """The reference's trainer (src/repro/launch/train.py:370-381) builds
    (4, 2) and (pods, 4 // pods, 2) test meshes and the (16, 16) and (2,
    16, 16) production meshes; so does the port's, and a run says which."""
    mesh = train.train_mesh(train.build_parser().parse_args(argv))
    assert mesh.sizes == shape
    assert mesh.axis_names == ("pod", "data", "model")[-len(shape):]
    if len(argv) <= 2 and "--production-mesh" not in argv \
            and "--multi-pod" not in argv:
        _run("--steps", "1", *argv)
        assert f"mesh={dict(mesh.shape)}" in capsys.readouterr().out


def test_flat_mesh_and_dry_run(capsys):
    """`--mesh 2x4` trains on a (2, 4) ('data', 'model') mesh (the run
    says how the layers meet its shards); a malformed or mixed `--mesh`
    exits 2. `--dry-run` allocates nothing: qwen2.5-32b on the production
    mesh fits an H100 at the trainer's default batch and not at the
    reference's production batch (256 x 4,096 tokens), whose activations
    are the largest term."""
    _run("--steps", "1", "--mesh", "2x4")
    out = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 4}" in out
    assert "model axis: 4 shards, layers compute by shard" in out
    for bad in (["--mesh", "2x"], ["--mesh", "2x4", "--pods", "2"]):
        with pytest.raises(SystemExit) as exc:
            _run("--steps", "1", *bad)
        assert exc.value.code == 2
    for extra, code in (([], 0), (["--seq", "4096", "--batch", "256"], 2)):
        with pytest.raises(SystemExit) as exc:
            train.main(["--dry-run", "--production-mesh", "--arch",
                        "qwen2.5-32b", *extra])
        assert exc.value.code == code
        out = capsys.readouterr().out
        assert "256 processes" in out and "attention case c" in out
        if code:
            assert "the largest term is the activations" in out


@pytest.mark.parametrize("flag", ["--production-mesh", "--multi-pod"])
def test_production_mesh_exits_before_allocating(flag, monkeypatch, capsys):
    """On a device of 64 GiB the production meshes' full stablelm-1.6b
    state (16 clients' f32 shift tables: 105 GB) does not fit one
    process: the trainer exits before it allocates, naming the state's
    bytes (sized on the meta device: the parameters, the tables) and the
    device's."""
    allocated = []
    monkeypatch.setattr(train, "device_memory", lambda device: 64 * 2**30)
    monkeypatch.setattr(train.steps, "init_train_state",
                        _spy(train.steps.init_train_state, allocated))
    with pytest.raises(SystemExit) as exc:
        _run("--steps", "1", flag)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "does not fit" in err and f"has {64 * 2**30} bytes" in err
    params = 1_644_367_872 * 2  # bf16
    pods = 2 if flag == "--multi-pod" else 1
    clients = 16 * pods
    # params + the clients' f32 shift tables + the mean shift(s) (+ on two
    # pods the pods' shift tables and their mean) + the int32 step
    state = params + clients * 2 * params + pods * 2 * params + 4
    if pods > 1:
        state += pods * 2 * params + 2 * params
    assert f"state takes {state} bytes" in err
    assert allocated and all(d == "meta" for d in allocated)


def _spy(fn, seen):
    def call(*args, **kwargs):
        seen.append(kwargs.get("device"))
        return fn(*args, **kwargs)
    return call


def test_resume_refusals(tmp_path):
    plain, fleet = str(tmp_path / "p.ckpt"), str(tmp_path / "f.ckpt")
    _run("--steps", "1", "--checkpoint", plain)
    _run("--steps", "1", "--clients", "8", "--checkpoint", fleet)
    with pytest.raises(SystemExit, match="does not match this run's sampler"):
        _run("--steps", "2", "--resume", plain, "--sampling", "wr")
    with pytest.raises(SystemExit, match="no fleet cursor"):
        _run("--steps", "2", "--resume", plain, "--clients", "8")
    with pytest.raises(SystemExit, match="no data-stream cursor"):
        _run("--steps", "2", "--resume", fleet)
    with pytest.raises(SystemExit, match="different cohort walk"):
        _run("--steps", "2", "--resume", fleet, "--clients", "8",
             "--cohort-mode", "with_replacement")
    with pytest.raises(SystemExit, match="async/chaos plan"):
        _run("--steps", "2", "--resume", fleet, "--clients", "8",
             "--buffer-k", "3")
    with pytest.raises(SystemExit, match="data-store layout"):
        _run("--steps", "2", "--resume", fleet, "--clients", "8",
             "--data-store", str(tmp_path / "ds"))


def test_default_device_without_a_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        train.main(["--steps", "1"])
    assert exc.value.code == 1
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-medium"])
def test_modality_stubs_equal_reference(arch):
    from repro.launch import train as jtrain

    got = train.stub_modalities(reduced(get_config(arch)), 2, 3, 2)
    want = jtrain.stub_modalities(jreduced(jget_config(arch)), 2, 3, 2)
    assert sorted(got) == sorted(want) and got
    for k, v in want.items():
        assert np.asarray(v).dtype == ml_dtypes.bfloat16
        assert got[k].dtype == torch.bfloat16
        assert got[k].view(torch.int16).numpy().tobytes() == \
            np.asarray(v).tobytes()


def test_salts_equal_reference_and_step_generators_are_pure():
    """The registry holds the reference's names and values (the numpy
    channels draw what the reference draws); a step's generator depends on
    (seed, salt, step) alone; a duplicate registration raises."""
    from repro.core import salts as jsalts
    from repro_torch.core import salts

    assert salts.registered_salts() == jsalts.registered_salts()

    def draw(seed, salt, step):
        return torch.randint(0, 2**31, (4,), generator=salts.step_generator(
            seed, salt, step, "cpu"))

    assert torch.equal(draw(0, salts.ROUNDS_KEY_SALT, 3),
                       draw(0, salts.ROUNDS_KEY_SALT, 3))
    others = [draw(1, salts.ROUNDS_KEY_SALT, 3),
              draw(0, salts.PARAMS_KEY_SALT, 3),
              draw(0, salts.ROUNDS_KEY_SALT, 4),
              draw(0, salts.ROUNDS_KEY_SALT, None)]
    assert not any(torch.equal(draw(0, salts.ROUNDS_KEY_SALT, 3), o)
                   for o in others)
    with pytest.raises(ValueError, match="registered twice"):
        salts._register("ROUNDS_KEY_SALT", 12345)
    with pytest.raises(ValueError, match="collides"):
        salts._register("NEW_SALT", salts.ROUNDS_KEY_SALT)
