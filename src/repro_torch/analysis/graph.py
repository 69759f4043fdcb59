"""Layer-2 step census: run the port's real train step on fake tensors and
audit the wire (the counterpart of `repro.analysis.graph`).

The linter cannot see what a step does. This layer runs
`launch.steps.make_train_step` for every wire method on a flat and a
two-pod mesh as process 0 of the mesh, one client a process, on fake
tensors (`launch.cost_analysis`: no values, no card), and holds what it
records against the port's analytic claims:

collective census
    Every message crosses the collective (`launch.distributed`), so its
    records are the wire. Each wire level ("inner", the intra-pod slab,
    key "intra_pod"; "outer", the inter-pod one, "inter_pod") must carry
    the port's wire model: one gather a parameter leaf on the f32 and
    bf16 transports (the slab), two on the packed ones (the byte lattice
    and its f32 scales), and the process's operand bytes a level must
    equal `CompressedAggregation.wire_bytes_per_round` exactly (one client
    a process contributes one rank's message; TP = 1, so no leaf splits).
unexpected traffic
    Nothing crosses the "model" level at TP = 1; the only keyless gathers
    are the step's metrics (the losses and the norms' partial sums over
    "world", and over "outer" on NASTYA paths); on a packed wire no f32
    slab is gathered (only the bytes and the (rows, 1) scales).
dtype audit
    No op makes a float64 tensor, and the state's dtypes after the step
    equal those before.
in-place tables
    The step writes its shift tables in place (`core.dist`; the
    reference's step donates its state): every table leaf of the state
    after the step lies in the storage it lay in before. The counterpart
    of the reference's donation audit; a rebuilt leaf is named.
elastic weights
    The elastic step's (m,) weights are read by an op, and two weight
    vectors give the same op sequence: the counterpart of the reference's
    single-compile guarantee (a cohort change runs the same step).
telemetry identity
    An installed telemetry sink leaves the step's op sequence unchanged.

Every rule name is the reference's (`RULES`). None lacks a counterpart:
the reference's jaxpr-level psum census becomes the gather census (the
port's wire reduces a gathered stack on every process), its StableHLO
aliasing audit the storages' identity.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.analysis.findings import Finding
from repro_torch.core.api import tree_leaves
from repro_torch.core.dist import CompressedAggregation
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (
    make_mesh,
    model_size,
    num_clients,
    num_pods,
)

RULES = {
    "census-collective-count":
        "gathers per wire level != the wire model (one a leaf; two a leaf "
        "on packed wires)",
    "census-collective-bytes":
        "a wire level's operand bytes != the analytic wire_bytes_per_round",
    "census-unexpected-collective":
        "a gather no wire level owns (any over 'model' at TP = 1), or an "
        "f32 slab on a packed wire",
    "census-dtype-promotion":
        "float64 in the step, or a state dtype changed by it",
    "census-donation":
        "a shift table the step writes in place was rebuilt (its storage "
        "changed)",
    "census-elastic-invariant":
        "the elastic weights are not read, or two weight vectors run "
        "different op sequences",
    "census-telemetry-identity":
        "installing a telemetry sink changed the step's op sequence",
}

CENSUS_METHODS = ("q", "diana", "diana_rr", "ef")
CENSUS_MESHES = (
    ("flat", (4, 1), ("data", "model")),
    ("two_pod", (2, 2, 1), ("pod", "data", "model")),
)
CENSUS_PACKED_METHODS = ("q", "diana_rr")
CENSUS_EXTRA_DTYPES = ("packed4", "bf16")
# the wire levels and their keys (`core.dist`)
_WIRE_KEYS = {"inner": "intra_pod", "outer": "inter_pod"}
_METRIC_LEVELS = ("world", "outer")
_TABLES = ("shifts", "mean_shift", "pod_shifts", "pod_mean_shift")


def _trace_step(cfg, mesh, method: str, *, elastic: bool = False,
                fraction: float = 0.25, wire_dtype: str = "f32",
                weights=None, sink=None):
    """One train step of `method` on fake tensors as process 0 of `mesh`
    (one client a process, two sequences of `cfg.max_seq` tokens, no
    remat): `launch.dryrun.trace_train`, with `sink` installed around it.
    Returns a dict of what the checks read: "ops" (the `OpCensus`),
    "records" (the gathers), "agg" (the wire bound to the mesh), "params",
    "before"/"after" (the state), "storages" (each table leaf's storage
    before the step, by name)."""
    m, t = num_clients(mesh), model_size(mesh)
    coll = ca.CensusCollective(m, t, world=m * t, rank=0)
    agg0 = CompressedAggregation(
        method=method, wire="shared", fraction=fraction,
        shift_dtype=torch.float32, wire_dtype=wire_dtype,
        n_slots=2 if method == "diana_rr" else 1, collective=coll)
    if sink is not None:
        telemetry.install(sink)
    try:
        run = dryrun.trace_train(
            cfg, mesh, agg0, rows=2 * coll.layout(num_pods(mesh)).local,
            seq=cfg.max_seq, remat=False, seq_shard=False, elastic=elastic,
            weights=weights)
    finally:
        if sink is not None:
            telemetry.uninstall()
    storages = {f"{name}[{i}]": x.untyped_storage()._cdata
                for name in _TABLES if getattr(run.state, name) is not None
                for i, x in enumerate(tree_leaves(getattr(run.state, name)))}
    return {"ops": run.ops, "records": coll.records, "agg": run.wired,
            "params": tree_leaves(run.state.params), "before": run.state,
            "after": run.stepped, "storages": storages}


def _is_wire(r) -> bool:
    return r.level in _WIRE_KEYS and r.key == _WIRE_KEYS[r.level]


def wire_census(records) -> dict[str, tuple[int, int]]:
    """{wire level -> (gathers, operand bytes)} of a step's records."""
    out: dict[str, tuple[int, int]] = {}
    for r in records:
        if _is_wire(r):
            c, b = out.get(r.level, (0, 0))
            out[r.level] = (c + 1, b + r.nbytes)
    return out


def check_step(cfg, mesh, method: str, label: str, *,
               wire_dtype: str = "f32") -> list[Finding]:
    """Every census check of one (mesh, method, wire_dtype) point."""
    run = _trace_step(cfg, mesh, method, wire_dtype=wire_dtype)
    agg, records = run["agg"], run["records"]
    where = f"step:{label}/{method}"
    if wire_dtype != "f32":
        where += f"/{wire_dtype}"
    out: list[Finding] = []
    packed = wire_dtype in ("packed8", "packed4")
    per_leaf = 2 if packed else 1
    n_leaves = len(run["params"])
    wire = agg.wire_bytes_per_round(run["params"])
    expected = {}
    if agg.client_axes:
        expected["inner"] = wire["intra_pod"]
    if agg.pod_axes and agg.pod_size > 1:
        expected["outer"] = wire["inter_pod"]
    levels = wire_census(records)
    for level, (count, nbytes) in sorted(levels.items()):
        if level not in expected:
            out.append(Finding(
                file=where, line=0, rule="census-unexpected-collective",
                message=f"wire gathers over {level!r}, which no wire level "
                        "of this mesh owns"))
            continue
        if count != per_leaf * n_leaves:
            out.append(Finding(
                file=where, line=0, rule="census-collective-count",
                message=f"{count} gathers over {level!r}, expected "
                        f"{per_leaf * n_leaves} ({per_leaf} a parameter "
                        "leaf)"))
        if nbytes != expected[level]:
            out.append(Finding(
                file=where, line=0, rule="census-collective-bytes",
                message=f"the {level!r} wire's operand is {nbytes} B a "
                        f"process, the analytic wire model says "
                        f"{expected[level]} B — the wire and its accounting "
                        "have diverged"))
    for level in expected:
        if level not in levels:
            out.append(Finding(
                file=where, line=0, rule="census-collective-count",
                message=f"no gathers over {level!r} — an expected wire level "
                        "is missing from the step"))
    for r in records:
        wire_rec = _is_wire(r)
        if r.level == "model" or not wire_rec and (
                r.key is not None or r.level not in _METRIC_LEVELS):
            out.append(Finding(
                file=where, line=0, rule="census-unexpected-collective",
                message=f"a {r.dtype} gather of {r.shape} over {r.level!r} "
                        f"(key {r.key}) that no wire level or metric owns"))
        elif wire_rec and packed and r.dtype == "torch.float32" \
                and r.shape[-1] != 1:
            out.append(Finding(
                file=where, line=0, rule="census-unexpected-collective",
                message=f"an f32 slab {r.shape} gathered over {r.level!r} on "
                        f"the {wire_dtype} wire, which moves only bytes and "
                        "their scales"))
    if "torch.float64" in run["ops"].dtypes:
        out.append(Finding(
            file=where, line=0, rule="census-dtype-promotion",
            message="float64 appears in the step — a silent promotion "
                    "doubles the wire's payloads"))
    before = [str(x.dtype) for x in tree_leaves(run["before"])]
    after = [str(x.dtype) for x in tree_leaves(run["after"])]
    if before != after:
        out.append(Finding(
            file=where, line=0, rule="census-dtype-promotion",
            message="the state's dtypes after the step differ from before "
                    "— an in-flight promotion"))
    now = {f"{name}[{i}]": x.untyped_storage()._cdata
           for name in _TABLES if getattr(run["after"], name) is not None
           for i, x in enumerate(tree_leaves(getattr(run["after"], name)))}
    rebuilt = sorted(k for k, v in run["storages"].items()
                     if now.get(k) != v)
    if rebuilt:
        out.append(Finding(
            file=where, line=0, rule="census-donation",
            message=f"{len(rebuilt)} of {len(run['storages'])} shift tables "
                    f"were rebuilt, not written in place: {rebuilt[:4]} — "
                    "the step holds two copies of each at its peak"))
    return out


def check_elastic(cfg, mesh, label: str, method: str = "diana"
                  ) -> list[Finding]:
    """The elastic step reads its weights, and runs the same ops for two
    weight vectors."""
    m = num_clients(mesh)
    a = _trace_step(cfg, mesh, method, elastic=True)
    b = _trace_step(cfg, mesh, method, elastic=True,
                    weights=np.linspace(0.0, 1.0, m))
    where = f"step:{label}/{method}+elastic"
    out = []
    if "weights" not in a["ops"].read:
        out.append(Finding(
            file=where, line=0, rule="census-elastic-invariant",
            message="no op reads the (m,) participation weights — a cohort "
                    "change would not reach the wire"))
    if a["ops"].sequence != b["ops"].sequence:
        out.append(Finding(
            file=where, line=0, rule="census-elastic-invariant",
            message="two weight vectors run different op sequences — the "
                    "step depends on the weights' values on the host"))
    return out


def check_telemetry_identity(cfg, mesh, label: str, method: str = "diana"
                             ) -> list[Finding]:
    """A telemetry sink installed around the step leaves its ops as they
    are: telemetry lives on the host side of the step."""
    off = _trace_step(cfg, mesh, method)
    sink = telemetry.MetricsSink()
    try:
        on = _trace_step(cfg, mesh, method, sink=sink)
    finally:
        sink.close()
    if off["ops"].sequence != on["ops"].sequence:
        return [Finding(
            file=f"step:{label}/{method}+telemetry", line=0,
            rule="census-telemetry-identity",
            message="the step's op sequence differs with a telemetry sink "
                    "installed — host instrumentation reached the device "
                    "path")]
    return []


def run_census() -> list[Finding]:
    """The CLI's census: every method on both meshes, the packed and bf16
    transports, the elastic weights and telemetry."""
    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config("stablelm-1.6b"), seq=16)
    findings: list[Finding] = []
    for label, shape, axes in CENSUS_MESHES:
        mesh = make_mesh(shape, axes)
        for method in CENSUS_METHODS:
            findings.extend(check_step(cfg, mesh, method, label))
        for method in CENSUS_PACKED_METHODS:
            findings.extend(check_step(cfg, mesh, method, label,
                                       wire_dtype="packed8"))
    flat = make_mesh(*CENSUS_MESHES[0][1:])
    for wire_dtype in CENSUS_EXTRA_DTYPES:
        findings.extend(check_step(cfg, flat, "diana", CENSUS_MESHES[0][0],
                                   wire_dtype=wire_dtype))
    findings.extend(check_elastic(cfg, flat, CENSUS_MESHES[0][0]))
    findings.extend(check_telemetry_identity(cfg, flat, CENSUS_MESHES[0][0]))
    return sorted(findings)
