"""The port's batch streams (`repro_torch.data.pipeline`) against the
reference's `repro.data.pipeline`.

The same client-stacked data (int32 tokens and a bf16 patch leaf, made
from a seed with numpy) and the same sampler specs go through both
packages' `BatchStream` / `make_batch_stream` and `CohortStream`, with
`put` the identity (the port's host batches are CPU tensors, the
reference's numpy arrays): every emitted batch is byte-equal over more
than two epochs, for local_steps 1 and 2, prefetch on and off, a stream
resumed from a mid-epoch cursor, uneven per-client data, cohorts with and
without an async planner, and paged data against in-RAM data. Cursor
metadata is equal too. Tolerance: exact.
"""
import ml_dtypes
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro.data import pipeline as jpipe
from repro.data.paging import ClientDataStore as JDataStore
from repro.data.paging import LookaheadPager as JPager
from repro.data.reshuffle import ReshuffleSampler as JSampler
from repro.fleet import AsyncPlanner as JPlanner
from repro.fleet import ChaosConfig as JChaos
from repro.fleet import CohortSampler as JCohorts
from repro_torch.data import pipeline
from repro_torch.data.paging import ClientDataStore, LookaheadPager
from repro_torch.data.reshuffle import ReshuffleSampler
from repro_torch.fleet import AsyncPlanner, ChaosConfig, CohortSampler

M, N, B, S = 4, 5, 2, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _data(m=M, n=N, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 500, (m, n, B, S + 1)).astype(np.int32),
            "patches": rng.normal(size=(m, n, B, 3, 4)).astype(
                ml_dtypes.bfloat16)}


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _same_batch(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert _bytes(got[k]) == _bytes(want[k]), k


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("local_steps", [1, 2])
@pytest.mark.parametrize("mode", ["rr", "rr_shared", "wr"])
def test_batch_stream_equals_reference(mode, local_steps, prefetch):
    data = _data()
    extras = {"patches": data.pop("patches")}
    steps = 3 * N // local_steps  # past two epochs
    port = pipeline.make_batch_stream(
        data, ReshuffleSampler(M, N, mode=mode, seed=1),
        local_steps=local_steps, extras=extras, prefetch=prefetch)
    ref = jpipe.make_batch_stream(
        data, JSampler(M, N, mode=mode, seed=1), local_steps=local_steps,
        extras=extras, prefetch=prefetch)
    with port, ref:
        for t in range(steps):
            _same_batch(next(port), next(ref))
            assert port.cursor == ref.cursor
        assert port.cursor_meta() == ref.cursor_meta()


@pytest.mark.parametrize("local_steps", [1, 2])
def test_stream_resumed_mid_epoch_equals_reference(local_steps):
    data = _data()
    start = 3  # mid-epoch for both local_steps
    kw = dict(local_steps=local_steps, start_step=start)
    with pipeline.make_batch_stream(data, ReshuffleSampler(M, N, seed=2),
                                    **kw) as port, \
            jpipe.make_batch_stream(data, JSampler(M, N, seed=2), **kw) as ref:
        for _ in range(2 * N):
            _same_batch(next(port), next(ref))
    # and a port stream resumed from its own cursor continues the original
    with pipeline.make_batch_stream(data, ReshuffleSampler(M, N, seed=2),
                                    local_steps=local_steps) as full:
        head = [next(full) for _ in range(start)]
        meta = full.cursor_meta()
        tail = [next(full) for _ in range(4)]
    assert len(head) == meta["train_step"] == start
    with pipeline.make_batch_stream(data, ReshuffleSampler(M, N, seed=2),
                                    local_steps=local_steps,
                                    start_step=meta["train_step"]) as again:
        for want in tail:
            got = next(again)
            assert all(torch.equal(got[k], want[k]) for k in want)


def test_uneven_clients_drop_remainder_equals_reference():
    rng = np.random.default_rng(3)
    per = [rng.integers(0, 9, (n, B, S)).astype(np.int32)
           for n in (5, 4, 6, 4)]
    with pipeline.make_batch_stream({"x": per}, ReshuffleSampler(4, 4, seed=0),
                                    prefetch=False) as port, \
            jpipe.make_batch_stream({"x": per}, JSampler(4, 4, seed=0),
                                    prefetch=False) as ref:
        for _ in range(9):
            _same_batch(next(port), next(ref))
    with pytest.raises(ValueError, match="uneven"):
        pipeline.make_batch_stream({"x": per}, ReshuffleSampler(4, 4),
                                   drop_remainder=False)


def test_failed_put_poisons_the_stream():
    calls = {"n": 0}

    def put(batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("device lost")
        return batch

    s = pipeline.make_batch_stream(_data(), ReshuffleSampler(M, N), put=put,
                                   prefetch=False)
    next(s)
    with pytest.raises(RuntimeError, match="device lost"):
        next(s)
    with pytest.raises(ValueError, match="closed"):
        next(s)


def _cohort_streams(C, m, *, data, paged_dirs=None, planner=False,
                    start_round=0, prefetch=True, local_steps=1):
    kw = dict(local_steps=local_steps, prefetch=prefetch,
              start_round=start_round)
    chaos = dict(dropout=0.3, straggler=0.3, seed=4)
    port_kw, ref_kw = dict(kw), dict(kw)
    if planner:
        port_kw["planner"] = AsyncPlanner(m, buffer_k=m - 1, late="drop",
                                          chaos=ChaosConfig(**chaos))
        ref_kw["planner"] = JPlanner(m, buffer_k=m - 1, late="drop",
                                     chaos=JChaos(**chaos))
    port_data, ref_data = data, data
    if paged_dirs is not None:
        store = ClientDataStore.from_stacked(paged_dirs, data, shard_size=2)
        port_kw["paged"] = LookaheadPager(store)
        port_data = None
    port = pipeline.CohortStream(port_data, ReshuffleSampler(C, N, seed=1),
                                 CohortSampler(C, m, seed=2), **port_kw)
    ref = jpipe.CohortStream(ref_data, JSampler(C, N, seed=1),
                             JCohorts(C, m, seed=2), **ref_kw)
    return port, ref


@pytest.mark.parametrize("case", ["in_ram", "paged", "planner",
                                  "paged_planner", "resumed", "sync",
                                  "local_steps_2"])
def test_cohort_stream_equals_reference(case, tmp_path):
    C, m = 7, 3
    data = _data(m=C)
    kw = {"paged_dirs": str(tmp_path / "ds") if "paged" in case else None,
          "planner": "planner" in case,
          "start_round": 4 if case == "resumed" else 0,
          "prefetch": case != "sync",
          "local_steps": 2 if case == "local_steps_2" else 1}
    port, ref = _cohort_streams(C, m, data=data, **kw)
    with port, ref:
        for _ in range(3 * C):  # past two fleet and data epochs
            got, want = next(port), next(ref)
            assert got.round == want.round
            assert np.array_equal(got.cohort, want.cohort)
            assert np.array_equal(got.cols, want.cols)
            _same_batch(got.batch, want.batch)
            if kw["planner"]:
                assert np.array_equal(got.plan.completes, want.plan.completes)
                assert np.array_equal(got.plan.weights, want.plan.weights)
        assert port.cursor_meta() == ref.cursor_meta()
        assert np.array_equal(port.counts, ref.counts)


def test_full_cohort_stream_is_the_batch_stream():
    """cohort == population under cohort-RR: the fleet stream emits the
    full-participation stream's batches (the fleet bit-match invariant)."""
    data = _data()
    with pipeline.CohortStream(data, ReshuffleSampler(M, N, seed=1),
                               CohortSampler(M, M, seed=5)) as cs, \
            pipeline.make_batch_stream(
                data, ReshuffleSampler(M, N, seed=1)) as bs:
        for _ in range(2 * N + 1):
            got, want = next(cs).batch, next(bs)
            for k in want:
                assert torch.equal(got[k], want[k])


def test_device_put_on_the_host_is_a_plain_move():
    batch = {"x": torch.arange(4)}
    out = pipeline.DevicePut("cpu")(batch)
    assert isinstance(out, dict) and torch.equal(out["x"], batch["x"])


def test_host_tensor_keeps_bf16_bits():
    a = np.random.default_rng(0).normal(size=7).astype(ml_dtypes.bfloat16)
    t = pipeline.host_tensor(a)
    assert t.dtype == torch.bfloat16
    assert t.view(torch.int16).numpy().tobytes() == a.tobytes()


def test_jax_paged_store_feeds_port_cohort_stream(tmp_path):
    """A data store written by the reference feeds the port's paged
    stream: the rows equal the reference's own paged stream's."""
    C, m = 6, 2
    data = _data(m=C)
    JDataStore.from_stacked(str(tmp_path / "ds"), data, shard_size=4)
    port = pipeline.CohortStream(
        None, ReshuffleSampler(C, N, seed=1), CohortSampler(C, m, seed=2),
        paged=LookaheadPager(ClientDataStore.open(str(tmp_path / "ds"))))
    ref = jpipe.CohortStream(
        None, JSampler(C, N, seed=1), JCohorts(C, m, seed=2),
        paged=JPager(JDataStore.open(str(tmp_path / "ds"))))
    with port, ref:
        for _ in range(2 * C):
            _same_batch(next(port).batch, next(ref).batch)
