"""The port's telemetry (`repro_torch.telemetry`) against the reference's
`repro.telemetry`.

The same events go through both packages' sinks: the records decode to the
same dicts (timestamps aside), the Chrome traces of the same decoded events
are byte-equal, and both CLIs print the same lines and exit with the same
codes (0 clean, 1 schema problems, 2 unreadable) on the same files. The
port's sink takes torch tensors where the reference takes jax arrays.
Tolerance: exact.
"""
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro import telemetry as jtel
from repro.telemetry.__main__ import main as jax_cli
from repro_torch import telemetry
from repro_torch.telemetry.__main__ import main as port_cli

TIMING = ("ts", "dur")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _emit_mix(sink, scalar):
    sink.run_meta({"arch": "tiny", "n_params": 7})
    with sink.span("outer", round=0):
        with sink.span("inner"):
            pass
    sink.counter("fleet.uplink_bits", np.float64(96.0), round=0)
    sink.counter("fleet.staleness_hist", [1, 0, 2])
    sink.counter("fleet.store_retry", 1, op="gather")
    sink.round_metrics(0, {"loss": np.float32(1.5),
                           "grad_norm": scalar(2.0),
                           "completed": 4, "skipped": False})
    sink.round_metrics(1, {"loss": scalar(0.25), "vec": [1.0, 2.0]})


def _written(tmp_path, name, sink_cls, scalar):
    path = str(tmp_path / name)
    with sink_cls(path) as sink:
        _emit_mix(sink, scalar)
    return path


def _untimed(events):
    return [{k: v for k, v in ev.items() if k not in TIMING} for ev in events]


@pytest.fixture
def files(tmp_path):
    port = _written(tmp_path, "port.jsonl", telemetry.MetricsSink,
                    lambda x: torch.tensor(x))
    ref = _written(tmp_path, "ref.jsonl", jtel.MetricsSink,
                   lambda x: jnp.float32(x))
    return port, ref


def test_records_equal_reference(files):
    port, ref = files
    got, want = telemetry.read_events(port), jtel.read_events(ref)
    assert _untimed(got) == _untimed(want)
    assert telemetry.validate_events(got) == []
    assert isinstance(got[-1]["metrics"]["loss"], float)
    # the reader is the reference's: each decodes the other's file alike
    assert _untimed(jtel.read_events(port)) == _untimed(got)


def test_in_memory_sink_equals_reference():
    with telemetry.MetricsSink() as ps, jtel.MetricsSink() as js:
        _emit_mix(ps, lambda x: torch.tensor(x))
        _emit_mix(js, lambda x: jnp.float32(x))
        assert _untimed(ps.events()) == _untimed(js.events())


def test_trace_export_byte_equal(files, tmp_path):
    events = jtel.read_events(files[1])
    assert telemetry.to_trace_events(events) == jtel.to_trace_events(events)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert telemetry.write_trace(events, a) == jtel.write_trace(events, b)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("case", ["clean", "schema", "missing", "torn",
                                  "corrupt"])
def test_cli_matches_reference(files, tmp_path, capsys, case):
    """Same file, same flags: same stdout, stderr and exit code."""
    path = files[1]
    if case == "schema":
        path = str(tmp_path / "bad.jsonl")
        with open(path, "w") as f:
            f.write('{"v": 1, "kind": "span", "ts": 0}\n')
    elif case == "missing":
        path = str(tmp_path / "missing.jsonl")
    elif case == "torn":
        with open(path, "a") as f:
            f.write('{"v": 1, "kind": "coun')
    elif case == "corrupt":
        lines = open(path).read().splitlines()
        lines[2] = lines[2][:10]
        path = str(tmp_path / "corrupt.jsonl")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    outs = []
    for cli, trace in ((port_cli, "p.json"), (jax_cli, "j.json")):
        # --summary reads every span's name: a schema case validates only
        flags = (["--validate"] if case == "schema" else
                 ["--validate", "--summary", "--to-trace",
                  str(tmp_path / trace)])
        rc = cli([path] + flags)
        cap = capsys.readouterr()
        outs.append((rc, cap.out.replace(trace, "T"), cap.err))
    assert outs[0] == outs[1]
    assert outs[0][0] == {"clean": 0, "schema": 1, "missing": 2, "torn": 0,
                          "corrupt": 2}[case]
    if case in ("clean", "torn"):
        assert (open(tmp_path / "p.json", "rb").read()
                == open(tmp_path / "j.json", "rb").read())


def test_cli_needs_an_action(files):
    with pytest.raises(SystemExit):
        port_cli([files[0]])


def test_helpers_are_noops_when_off_and_session_uninstalls():
    assert not telemetry.enabled()
    with telemetry.span("anything", round=3):
        pass
    telemetry.counter("x", 1)
    telemetry.round_metrics(0, {"loss": 1.0})
    telemetry.run_meta({})
    assert telemetry.active() is None
    sink = telemetry.MetricsSink()
    with pytest.raises(RuntimeError, match="boom"):
        with telemetry.session(sink):
            assert telemetry.active() is sink
            raise RuntimeError("boom")
    assert telemetry.active() is None


def test_spans_from_worker_threads_get_their_own_tid_and_depth():
    with telemetry.MetricsSink() as sink:
        def worker():
            with sink.span("worker_phase"):
                pass

        with sink.span("main_phase"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        spans = {e["name"]: e for e in sink.events()}
    assert spans["worker_phase"]["tid"] != spans["main_phase"]["tid"]
    assert spans["worker_phase"]["depth"] == 0
    assert spans["main_phase"]["depth"] == 0


def test_stage_passes_host_values_through():
    """On the host nothing is staged (only CUDA tensors are); staging is
    idempotent and keeps the container types."""
    t = torch.tensor(1.5)
    out = telemetry.stage({"a": t, "b": [t, 2], "c": (3,)})
    assert out["a"] is t and out["b"][0] is t and out["c"] == (3,)


def test_console_reporter_matches_reference(capsys):
    def drive(mod, value):
        rep = mod.ConsoleReporter(unit="round", log_every=2, total=5)
        rep.start()
        for t in range(5):
            if t == 3:
                rep.report(t, {"skipped": True})
            else:
                rep.report(t, {"loss": value(1.0), "grad_norm": value(2.0),
                               "completed": 3}, cohort=4)
        return [ln.rsplit("|", 2)[0] + ln.rsplit("|", 1)[1]
                if "s/round" in ln else ln
                for ln in capsys.readouterr().out.strip().splitlines()]

    got = drive(telemetry, torch.tensor)
    assert got == drive(jtel, jnp.float32)
    assert len(got) == 3 and all("done 3/4" in ln for ln in got)


def test_counter_with_a_tensor_value_is_json(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with telemetry.MetricsSink(path) as sink:
        sink.counter("c", torch.tensor([1, 2]))
    (ev,) = telemetry.read_events(path)
    assert ev["value"] == [1, 2]
    json.dumps(ev)
