"""The port's out-of-core fleet data (`repro_torch.data.paging`) against the
reference's `repro.data.paging`.

A data store written by either package (`from_stacked` or `create` +
`write_rows`, int32 and bf16 leaves, several shards, a short last shard)
opens in the other with equal spec, equal files and equal rows, absent
shards reading as zeros. Both packages' lookahead pagers, driven by the
same cohort walk, hold the same pages with the same hit, miss, eviction
and residency counts, and the same resident bound. Tolerance: exact.
"""
import os

import ml_dtypes
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro.data.paging import ClientDataStore as JStore
from repro.data.paging import LookaheadPager as JPager
from repro.fleet import CohortSampler as JCohorts
from repro_torch.data.paging import ClientDataStore, LookaheadPager
from repro_torch.fleet import CohortSampler

C, N, B, S = 7, 3, 2, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 500, (C, N, B, S)).astype(np.int32),
            "frames": rng.normal(size=(C, N, B, 4)).astype(
                ml_dtypes.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stores_cross_open_with_equal_rows(tmp_path, writer):
    data = _data()
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    make = ClientDataStore if writer == "port" else JStore
    make.from_stacked(a, data, shard_size=3)
    # the other package writes the same layout to the same bytes
    (JStore if writer == "port" else ClientDataStore).from_stacked(
        b, data, shard_size=3)
    assert _files(a) == _files(b)
    port, ref = ClientDataStore.open(a), JStore.open(a)
    assert port.spec() == ref.spec()
    assert (port.num_shards, port.n_batches, port.nbytes) == (
        ref.num_shards, ref.n_batches, ref.nbytes)
    for name in data:
        for s in range(port.num_shards):
            assert _np(port.page(name, s)).tobytes() == ref.page(
                name, s).tobytes()
        assert port.page_nbytes(name) == ref.page_nbytes(name)


def test_lazy_shards_and_incremental_writes_match(tmp_path):
    structs = {k: v[0] for k, v in _data().items()}
    rows = {k: v[[1, 5]] for k, v in _data(1).items()}
    for cls, d in ((ClientDataStore, "p"), (JStore, "j")):
        st = cls.create(str(tmp_path / d), C, structs, shard_size=3)
        assert sorted(os.listdir(tmp_path / d)) == ["data_store.json"]
        st.write_rows(np.array([1, 5]), rows)
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    port = ClientDataStore.open(str(tmp_path / "j"))
    assert not _np(port.page("tokens", 2)).any()  # absent shard: zeros
    assert np.array_equal(_np(port.page("tokens", 1))[2], rows["tokens"][1])
    ro = ClientDataStore.open(str(tmp_path / "p"))
    with pytest.raises(OSError, match="read-only"):
        ro.write_rows(np.array([0]), {"tokens": rows["tokens"][:1]})
    with pytest.raises(OSError, match="not a client data store"):
        ClientDataStore.open(str(tmp_path / "nowhere"))
    with pytest.raises(ValueError, match="per-client rows"):
        ClientDataStore.create(str(tmp_path / "x"), 3,
                               {"a": np.zeros(3, np.int32)})


@pytest.mark.parametrize("lookahead,max_resident", [(1, None), (2, None),
                                                    (0, 3)])
def test_pager_residency_equals_reference(tmp_path, lookahead, max_resident):
    data = _data()
    ClientDataStore.from_stacked(str(tmp_path / "s"), data, shard_size=2)
    port = LookaheadPager(ClientDataStore.open(str(tmp_path / "s")),
                          lookahead=lookahead, max_resident=max_resident)
    ref = JPager(JStore.open(str(tmp_path / "s")), lookahead=lookahead,
                 max_resident=max_resident)
    pc, jc = CohortSampler(C, 3, seed=4), JCohorts(C, 3, seed=4)
    for t in range(2 * C):
        for c in pc.cohort_for_round(t):
            for name in data:
                assert _np(port.views[name][c]).tobytes() == \
                    ref.views[name][c].tobytes()
        port.advance_window(t, pc)
        ref.advance_window(t, jc)
        assert port.stats() == ref.stats()
        assert sorted(port._pages) == sorted(ref._pages)
    assert port.resident_bound_nbytes(3) == ref.resident_bound_nbytes(3)
    assert ClientDataStore.estimate_nbytes(
        {k: v[0] for k, v in data.items()}, C) == JStore.estimate_nbytes(
        {k: v[0] for k, v in data.items()}, C)


def test_pager_needs_a_bound_store(tmp_path):
    ClientDataStore.from_stacked(str(tmp_path / "s"), _data(), shard_size=2)
    pager = LookaheadPager(ClientDataStore.open(str(tmp_path / "s")))
    with pytest.raises(RuntimeError, match="bind_store"):
        pager.gather(np.array([0, 1]))
