"""Roofline report of a dry-run grid (the counterpart of the reference's
`benchmarks/roofline.py`).

    PYTHONPATH=src python -m repro_torch.launch.roofline dryrun.jsonl \
        [--mesh single]

For each (arch, shape) of the grid's "ok" records on one mesh: the
traced peak beside `reckon`'s total (train) and whether it fits an H100,
the traced FLOPs and HBM bytes and the messages' bytes by level, the
three per-process roofline terms (seconds, at an H100's data-sheet
peaks, `launch.cost_analysis.Roofline`) and the dominant one; MODEL_FLOPS, 6 N D
for a train step and 2 N D for prefill and decode (N the config's active
parameters, `cfg.active_param_count()`, D the step's tokens) over the
mesh's processes, against the traced FLOPs (below 1: recompute under
remat, attention's blocks, the vocab's padding; above 1: work the
counter does not see, such as element-wise FLOPs); the traced peak
against 80 GB; and a note on what would move the dominant term in the
port.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.configs import get_config
from repro_torch.configs.shapes import INPUT_SHAPES

NOTES = {
    ("train", "collective"): "the model group's activation gathers: a "
                             "reduce-scatter in place of gather-then-sum, "
                             "or fewer shards a client",
    ("train", "memory"): "fuse the element-wise chains (norms, the CE) and "
                         "the f32 copies of the wire's leaves",
    ("train", "compute"): "raise MFU: larger client batch, fused attention",
    ("prefill", "collective"): "per-layer partials over the model group: "
                               "sequence-shard the activations",
    ("prefill", "memory"): "bigger attention blocks; no f32 logits",
    ("prefill", "compute"): "attention-bound: a fused attention kernel",
    ("decode", "collective"): "a token's partials over the model group "
                              "dominate: fuse them a layer",
    ("decode", "memory"): "weights and cache streaming at one token a "
                          "request: expected; a wider batch or a smaller "
                          "cache",
    ("decode", "compute"): "decode should not be compute-bound: check the "
                           "attention's blocks",
}


def model_flops_per_device(arch: str, shape_name: str, n_devices: int,
                           kind: str) -> float:
    """6 N D (train) or 2 N D (prefill; decode: one token a request) over
    the mesh's processes, N the active parameters."""
    n = get_config(arch).active_param_count()
    shape = INPUT_SHAPES[shape_name]
    if kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len / n_devices
    if kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len / n_devices
    return 2.0 * n * shape.global_batch / n_devices


def load(path: str, mesh: str | None = None) -> list[dict]:
    """The grid's "ok" records with a roofline (of one mesh, if named)."""
    rows = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            if d.get("status") == "ok" and "roofline" in d and (
                    mesh is None or d.get("mesh") == mesh):
                rows.append(d)
    return rows


def _levels(d) -> str:
    """A record's message bytes by level, GB."""
    by = d.get("collectives_by_level", {})
    return ", ".join(f"{lvl} {v['bytes'] / 1e9:.3g}"
                     for lvl, v in sorted(by.items()) if lvl != "by_key")


def table(rows) -> str:
    out = ["| arch | shape | mesh | peak GB | reckon GB | fits | TFLOP | "
           "HBM TB | messages GB | compute s | memory s | collective s | "
           "dominant | 6ND/traced | note |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for d in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        r = d["roofline"]
        kind = INPUT_SHAPES[d["shape"]].kind
        mf = model_flops_per_device(d["arch"], d["shape"], d["n_devices"],
                                    kind)
        ratio = mf / r["flops"] if r["flops"] else float("nan")
        note = NOTES.get((kind, r["dominant"]), "")
        peak = d["memory"]["peak_bytes"] / 1e9
        reckon = (f"{d['reckon']['total'] / 1e9:.2f}" if "reckon" in d
                  else "")
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | {peak:.2f} | "
            f"{reckon} | {'yes' if d['fits'] else 'no'} | "
            f"{r['flops'] / 1e12:.4g} | {r['hbm_bytes'] / 1e12:.4g} | "
            f"{_levels(d)} | {r['compute_s']:.3g} | {r['memory_s']:.3g} | "
            f"{r['collective_s']:.3g} | **{r['dominant']}** | {ratio:.2f} | "
            f"{note} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("path", help="the dry run's JSONL (--out)")
    ap.add_argument("--mesh", choices=("single", "multi"), default=None,
                    help="one mesh's records (default: both)")
    args = ap.parse_args(argv)
    rows = load(args.path, args.mesh)
    print(f"# Roofline ({len(rows)} ok pairs from {args.path}; H100 SXM5 "
          "data-sheet peaks, the host's trace)\n")
    print(table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
