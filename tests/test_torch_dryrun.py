"""The port's dry run (`repro_torch.launch.dryrun`, `launch.cost_analysis`,
`kernels.census`): a step traced on fake tensors records what the same
step records on real host tensors under the same counters (FLOPs, op
bytes, kernel launches, messages and the tracked peak), for a reduced
dense and a reduced MoE config on (4, 2) as one (client, shard) a
process; its "model" bytes are `sharding.model_bytes` and its serving
bytes `serve_model_bytes`; the records carry the reference's keys; the
skipped pairs are the reference's; `fleet_smoke` returns the reference's
numbers; and the roofline table reads a written grid."""
import json
import os

import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, input_specs
from repro_torch.kernels import LAUNCHES, census
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun, sharding, train
from repro_torch.launch.mesh import make_mesh

SEQ, ROWS = 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _args(arch, wire_dtype="packed8", agg="diana_rr"):
    return train.build_parser().parse_args(
        ["--arch", arch, "--agg", agg, "--wire-dtype", wire_dtype,
         "--fraction", "0.25", "--seq", str(SEQ), "--batch", str(4 * ROWS),
         "--reduced"])


@pytest.fixture(scope="module")
def runs():
    """Each reduced config's step on (4, 2), process 0 of 8, on fake and
    on real host tensors."""
    out = {}
    mesh = make_mesh((4, 2), ("data", "model"))
    for arch in ("stablelm-1.6b", "qwen2-moe-a2.7b"):
        cfg = reduced(get_config(arch), seq=SEQ)
        for fake in (True, False):
            coll = ca.CensusCollective(4, 2, world=8, rank=0)
            agg = train._aggregation(_args(arch), 4, dryrun.N_SLOTS, coll)
            ops, wired, held = dryrun.trace_train(cfg, mesh, agg, rows=ROWS,
                                                  seq=SEQ, fake=fake)[:3]
            out[arch, fake] = ops, coll, wired, held
    return out


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-moe-a2.7b"])
def test_fake_census_equals_the_real_tensor_run(runs, arch):
    fake, _, _, held_f = runs[arch, True]
    real, _, _, held_r = runs[arch, False]
    assert fake.sequence == real.sequence
    assert (fake.flops, fake.f32_flops, fake.op_bytes) == (
        real.flops, real.f32_flops, real.op_bytes)
    assert fake.flops > 0 and fake.op_bytes > 0
    assert fake.kern.records == real.kern.records
    assert fake.peak == real.peak and fake.peak_parts == real.peak_parts
    assert held_f == held_r
    assert fake.host_reads == 0


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-moe-a2.7b"])
def test_census_messages_and_model_bytes(runs, arch):
    """The two runs send the same messages; the model group's are
    `sharding.model_bytes` of the process's one shard, the wire's each
    level's `wire_bytes_per_round` of its shards; all six wire kernels of
    the packed8 wire launch, one of each a leaf shard."""
    _, coll_f, wired, _ = runs[arch, True]
    _, coll_r, _, _ = runs[arch, False]
    assert coll_f.records == coll_r.records
    cfg = reduced(get_config(arch), seq=SEQ)
    assert coll_f.bytes_sent["model"] == sharding.model_bytes(
        cfg, ROWS, SEQ, 2, 1)
    kernels = runs[arch, True][0].kern.summary()
    assert set(kernels) == {"randk_compress", "randk_decompress",
                            "pack_slab", "unpack_slab", "unpack_reduce",
                            "diana_shift_update"}
    meta = [torch.empty(x.shape, dtype=x.dtype, device="meta")
            for x in _shard_leaves(cfg, wired)]
    want = sum(wired.wire_bytes_per_round([x])["intra_pod"] for x in meta)
    assert coll_f.bytes_sent["intra_pod"] == want
    assert kernels["pack_slab"]["launches"] == len(meta)


def _shard_leaves(cfg, wired):
    """Each parameter leaf's process shard (one of T), as the wire sees it."""
    from repro_torch.core.api import tree_leaves
    from repro_torch.models import transformer

    out = []
    for x, ax in zip(tree_leaves(transformer.init_params(0, cfg, "meta")),
                     wired.model_axes):
        shape = list(x.shape)
        if ax is not None:
            shape[ax] //= wired.model_size
        out.append(torch.empty(shape, dtype=x.dtype, device="meta"))
    return out


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_census_bytes_are_serve_model_bytes(kind):
    cfg = reduced(get_config("stablelm-1.6b"), seq=32)
    mesh = make_mesh((4, 2), ("data", "model"))
    ops, coll, held = dryrun._serve_trace(cfg, mesh,
                                          InputShape("x", 32, 8, kind))
    want = sharding.serve_model_bytes(cfg, 2, 32, 2, 1,
                                      prompt=32 if kind == "prefill" else 0)
    assert coll.bytes_sent["model"] == want
    assert ops.peak >= held > 0
    # under inference_mode a matmul reaches the census whole: its FLOPs
    # count through its decomposition
    assert ops.flops > 0


def test_record_keys_and_roofline_table(tmp_path, capsys):
    from repro.launch.hlo_analysis import Roofline as RefRoofline

    cfg = reduced(get_config("stablelm-1.6b"), seq=SEQ)
    shape = InputShape("train_4k", SEQ, 8, "train")
    saved = INPUT_SHAPES["train_4k"]
    INPUT_SHAPES["train_4k"] = shape
    try:
        rec = dryrun.trace_pair("stablelm-1.6b", "train_4k", multi_pod=False,
                                cfg=cfg, mesh=make_mesh((4, 2)),
                                clients=8)
    finally:
        INPUT_SHAPES["train_4k"] = saved
    ref_keys = {"arch", "shape", "mesh", "status", "n_devices", "clients",
                "agg", "remat", "ce", "seq_shard", "local_steps", "elastic",
                "memory", "roofline", "top_collectives", "model_params",
                "active_params", "fleet"}
    assert ref_keys <= set(rec)
    assert {"kernels", "collectives_by_level", "reckon", "fits"} <= set(rec)
    assert rec["status"] == "ok" and rec["fits"] is True
    assert set(rec["roofline"]) == set(RefRoofline(1, 1, 1, 1).as_dict())
    assert len(rec["kernels"]) == 6
    assert rec["reckon"]["total"] == sum(
        v for k, v in rec["reckon"].items() if k != "total")
    path = tmp_path / "grid.jsonl"
    skipped = dryrun.trace_pair("stablelm-1.6b", "long_500k",
                                multi_pod=False)
    path.write_text(json.dumps(rec) + "\n" + json.dumps(skipped) + "\n")
    from repro_torch.launch import roofline

    assert roofline.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "1 ok pairs" in out
    assert "| stablelm-1.6b | train_4k | single |" in out


def test_skips_are_the_reference_pairs():
    from repro.configs import get_config as ref_get_config
    from repro.configs import shape_supported as ref_supported
    from repro.configs.shapes import INPUT_SHAPES as REF_SHAPES

    for arch in ARCH_NAMES:
        for name in INPUT_SHAPES:
            ok, reason = ref_supported(ref_get_config(arch), REF_SHAPES[name])
            if ok:
                continue
            rec = dryrun.trace_pair(arch, name, multi_pod=True)
            assert rec == {"arch": arch, "shape": name, "mesh": "multi",
                           "status": "skipped", "reason": reason}


def test_input_specs_are_the_reference_shapes():
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.configs import input_specs as ref_input_specs
    from repro.data.pipeline import abstract_stream_batch as ref_stream
    from repro_torch.data.pipeline import abstract_stream_batch

    with ca.fake_mode():
        for arch in ("qwen2-vl-2b", "whisper-medium", "rwkv6-7b"):
            for name in ("train_4k", "prefill_32k", "decode_32k"):
                cfg, shape = get_config(arch), INPUT_SHAPES[name]
                got = input_specs(cfg, shape, device="cpu")
                want = ref_input_specs(ref_get_config(arch), shape)
                if shape.kind == "train":
                    got = {"batch": abstract_stream_batch(got["batch"], 2)}
                    want = {"batch": ref_stream(want["batch"], 2)}
                gl = _shapes(got)
                wl = sorted((tuple(x.shape), str(x.dtype))
                            for x in jax.tree.leaves(want))
                assert gl == wl, (arch, name)
    with pytest.raises(RuntimeError, match="fake mode"):
        input_specs(get_config("stablelm-1.6b"), INPUT_SHAPES["train_4k"],
                    device="cpu")


def _shapes(tree):
    from repro_torch.core.api import tree_leaves

    names = {torch.int32: "int32", torch.bfloat16: "bfloat16",
             torch.float32: "float32"}
    return sorted((tuple(x.shape), names[x.dtype]) for x in tree_leaves(tree)
                  if isinstance(x, torch.Tensor))


def test_wrappers_census_branch():
    """A fake tensor records the card's launch; a real host tensor runs
    the plain version, recorded under a census; neither is counted in
    `LAUNCHES`, which counts the card's launches only; a fake tensor
    outside a census raises."""
    from repro_torch.kernels.randk import randk_compress

    rows = torch.arange(4 * 32 * 8, dtype=torch.float32).reshape(4, 32, 8)
    start = torch.tensor(1, dtype=torch.int32)
    before = LAUNCHES["randk_compress"]
    with census.recording() as rec:
        plain = randk_compress(rows, start, k_blocks=2)
        with ca.fake_mode():
            fr = torch.empty(4, 32, 8)
            fs = torch.empty((), dtype=torch.int32)
            faked = randk_compress(fr, fs, k_blocks=2)
    assert LAUNCHES["randk_compress"] == before
    assert faked.shape == plain.shape and faked.dtype == plain.dtype
    assert [r.name for r in rec.records] == ["randk_compress"] * 2
    assert rec.records[0] == rec.records[1]
    assert rec.records[0].read == plain.numel() * 4 + 4
    assert rec.records[0].written == plain.numel() * 4
    with ca.fake_mode():
        with pytest.raises(RuntimeError, match="outside a census"):
            randk_compress(torch.empty(4, 32, 8),
                           torch.empty((), dtype=torch.int32), k_blocks=2)


def test_wrappers_census_applies_the_cards_checks():
    """A fake tensor is held to the card's checks before its launch is
    recorded: a non-contiguous input raises as it would on the card, and
    nothing is recorded; the same host tensor runs the plain version."""
    from repro_torch.kernels.qsgd import qsgd_quantize
    from repro_torch.kernels.randk import randk_mask

    with census.recording() as rec:
        with ca.fake_mode():
            x = torch.empty(8, 2048)[:, :1024]
            starts = torch.empty(8, dtype=torch.int32)
            with pytest.raises(ValueError, match="contiguous"):
                randk_mask(x, starts, d=1024, k=16)
            v = torch.empty(2 * 1024 * 2)[::2]
            with pytest.raises(ValueError, match="contiguous"):
                qsgd_quantize(v, torch.empty(2 * 1024))
        assert rec.records == []
        host = torch.ones(8, 2048)[:, :1024]
        out = randk_mask(host, torch.zeros(8, dtype=torch.int32), d=1024,
                         k=16)
    assert out.shape == (8, 1024)
    assert [r.name for r in rec.records] == ["randk_mask"]


def test_fleet_smoke_is_the_reference(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    jax.devices()  # the session's 8 host devices, before the import below
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.configs import get_config as ref_get_config
    from repro.configs import reduced as ref_reduced
    from repro.core.dist import CompressedAggregation as RefAgg
    from repro.launch import dryrun as ref_dryrun
    from repro.launch.mesh import make_test_mesh
    from repro_torch.core.dist import CompressedAggregation

    for method, kw in (("diana_rr", {"buffer_k": 3, "chaos_dropout": 0.2}),
                       ("diana", {"data_store": "store"})):
        n_slots = 8 if method == "diana_rr" else 1
        if "data_store" in kw:
            kw = {"data_store": str(tmp_path / f"ref_{method}")}
            mine = {"data_store": str(tmp_path / f"port_{method}")}
        else:
            mine = kw
        want = ref_dryrun.fleet_smoke(
            ref_reduced(ref_get_config("stablelm-1.6b")),
            make_test_mesh((4, 2), ("data", "model")),
            RefAgg(method=method, fraction=0.25, n_slots=n_slots,
                   shift_dtype=jnp.float32), 64, **kw)
        got = dryrun.fleet_smoke(
            reduced(get_config("stablelm-1.6b")),
            make_mesh((4, 2), ("data", "model")),
            CompressedAggregation(method=method, fraction=0.25,
                                  n_slots=n_slots, shift_dtype=torch.float32),
            64, **mine)
        # the pager's hits count the lookups of every round the stream's
        # prefetch thread assembled before the stream closed: thread
        # timing, in the reference as here (8 or 9 rounds)
        for d in (want, got):
            d.get("paging", {}).pop("path", None)
            d.get("paging", {}).pop("hits", None)
        assert got == want, method
