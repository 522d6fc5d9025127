"""The port's device clock cache (``corrosion_tpu_torch/ops/devcache.py``)
against the reference's (``corrosion_tpu/ops/devcache.py``), on the CPU.

``TorchStore(device="cpu")`` runs the store kernels' plain versions
(``kernels/store.py``); it must equal ``NumpyStore`` and the reference's
``JaxStore`` on every ``set`` / ``gather``, bitwise, repeated indices
keeping the last pair.  The port's whole ``DeviceClockCache`` then runs
under the reference's own storage engine (which reaches its cache only
through the duck-typed ``device_cache`` attribute) and must leave the
state the reference leaves uncached and with its NumPy-store cache; a
reference cache carried across (``convert.devcache_from_reference``)
must go on answering as the reference's does.  A corrupted cached
version must show in the state, or the comparisons above read nothing
through the cache.
"""

import random

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import devcache as ref_dc
from corrosion_tpu_torch.convert import devcache_from_reference
from corrosion_tpu_torch.kernels import store as kst
from corrosion_tpu_torch.ops import devcache as port_dc
from tests.test_apply_batched import _assert_state_equal, _dump, _mk, _stream

# (cap, n, kind): kind "unique" draws distinct indices, "repeat" draws
# with replacement and different values (the last pair wins), "negative"
# counts some indices from the end
STORE_CASES = [
    (1, 1, "unique"), (256, 0, "unique"), (256, 256, "unique"),
    (256, 257, "repeat"), (255, 100, "repeat"), (1024, 1000, "unique"),
    (1024, 2500, "repeat"), (4096, 64, "negative"), (65536, 2500, "unique"),
    (65536, 10000, "repeat"), (257, 255, "negative"), (512, 1, "repeat"),
]


def _case(cap, n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "unique":
        idx = rng.permutation(cap)[:n]
    else:
        idx = rng.integers(0, cap, n)
        if kind == "repeat" and n > 1:
            idx[-1] = idx[0]  # at least one repeat, different values
        if kind == "negative":
            idx = np.where(rng.random(n) < 0.5, idx - cap, idx)
    vals = rng.integers(-(1 << 62), 1 << 62, n)
    base = rng.integers(-5, 1 << 40, cap)
    return idx.astype(np.int64), vals.astype(np.int64), base


def _run(store, base, idx, vals):
    arr = store.from_host(base)
    arr = store.set(arr, idx, vals)
    return store.to_host(arr), store.gather(arr, idx)


@pytest.mark.parametrize("case", range(len(STORE_CASES)))
def test_torch_store_equals_numpy_store(case):
    cap, n, kind = STORE_CASES[case]
    idx, vals, base = _case(cap, n, kind, case)
    ts = port_dc.TorchStore(device="cpu")
    got_arr, got = _run(ts, base, idx, vals)
    want_arr, want = _run(port_dc.NumpyStore(), base.copy(), idx, vals)
    np.testing.assert_array_equal(got_arr, want_arr)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got.shape == (n,)
    full = ts.to_host(ts.full(cap, port_dc.ABSENT))
    np.testing.assert_array_equal(full, np.full(cap, -1))


# JaxStore pads from the last index, so it takes n >= 1
@pytest.mark.parametrize("case", [i for i, c in enumerate(STORE_CASES)
                                  if c[1] > 0])
def test_torch_store_equals_reference_jax_store(case):
    cap, n, kind = STORE_CASES[case]
    idx, vals, base = _case(cap, n, kind, 100 + case)
    got_arr, got = _run(port_dc.TorchStore(device="cpu"), base, idx, vals)
    with jax.enable_x64(True):
        want_arr, want = _run(ref_dc.JaxStore(), base, idx, vals)
    np.testing.assert_array_equal(got_arr, want_arr)
    np.testing.assert_array_equal(got, want)


def test_repeated_indices_keep_the_last_pair():
    ts = port_dc.TorchStore(device="cpu")
    arr = ts.full(8, 0)
    arr = ts.set(arr, np.array([3, 5, 3, 3, 5]), np.array([1, 2, 3, 4, 5]))
    np.testing.assert_array_equal(ts.to_host(arr), [0, 0, 0, 4, 0, 5, 0, 0])
    plain = kst.store_set_plain(torch.zeros(8, dtype=torch.int64),
                                torch.tensor([7, 7, 0]),
                                torch.tensor([9, 8, 6]))
    assert plain.tolist() == [6, 0, 0, 0, 0, 0, 0, 8]


@pytest.mark.parametrize("bad", [[4], [0, 7, 2], [-5], [3, -9]])
def test_out_of_range_indices_raise_as_numpy(bad):
    base = np.arange(4, dtype=np.int64)
    ts = port_dc.TorchStore(device="cpu")
    arr = ts.from_host(base)
    idx = np.array(bad, np.int64)
    with pytest.raises(IndexError) as want:
        base[idx]
    with pytest.raises(IndexError) as got:
        ts.gather(arr, idx)
    assert str(got.value) == str(want.value)
    with pytest.raises(IndexError):
        ts.set(arr, idx, np.zeros(len(bad), np.int64))
    np.testing.assert_array_equal(ts.to_host(arr), base)  # untouched
    with pytest.raises(IndexError):
        ts.gather(arr, np.array([0.0]))


def test_cpu_arrays_take_the_plain_versions():
    """A CPU array never reaches a kernel: the launch counters stay."""
    before = (kst.store_set.launches, kst.store_gather.launches)
    arr = torch.zeros(16, dtype=torch.int64)
    kst.store_set(arr, np.array([1, 2]), np.array([3, 4]))
    assert kst.store_gather(arr, np.array([2, 1])).tolist() == [4, 3]
    assert (kst.store_set.launches, kst.store_gather.launches) == before


def test_store_choice_on_a_host_with_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: auto picks the torch store")
    assert port_dc.default_enabled() is False
    assert type(port_dc.make_store("auto")) is port_dc.NumpyStore
    assert port_dc.DeviceClockCache(slots=64).backend == "numpy"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_dc.make_store("torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_dc.DeviceClockCache(backend="torch")
    with pytest.raises(ValueError):
        port_dc.make_store("jax")
    assert port_dc.make_store("torch", device="cpu").backend == "torch"


# -- the port's cache under the reference's storage engine ---------------


def _ref_with_port_cache(tmp_path, name, slots=None):
    conn = _mk(tmp_path, name, columnar=True)
    conn.device_cache = port_dc.DeviceClockCache(
        slots=slots or port_dc.DEFAULT_SLOTS, backend="torch", device="cpu")
    return conn


@pytest.mark.parametrize("seed", range(8))
def test_port_cache_on_reference_storage_randomized(tmp_path, seed):
    """The randomized device-parity stream of tests/test_devcache.py
    (local writes, a compaction invalidation): the port's cache (torch
    store on the CPU) under the reference's ``CrConn`` leaves the state
    of the reference's uncached columnar path, and of the reference
    with its own NumPy-store cache, with equal counters."""
    rng = random.Random(seed)
    unc = _mk(tmp_path, f"unc{seed}", columnar=True)
    ref = _mk(tmp_path, f"ref{seed}", columnar=True)
    ref.enable_device_cache(slots=64, backend="numpy")
    port = _ref_with_port_cache(tmp_path, f"port{seed}", slots=64)
    for rnd in range(4):
        batch = _stream(rng, 60)
        counts = {c.apply_changes_batched(list(batch))
                  for c in (unc, ref, port)}
        assert len(counts) == 1, counts
        if rnd == 1:
            for c in (unc, ref, port):
                c.execute("INSERT OR REPLACE INTO items (id, a) "
                          "VALUES (4, 'mid')")
        if rnd == 2:
            for c in (ref, port):
                c.device_cache_invalidate("compaction")
        for c in (ref, port):
            c.flush_barrier()
        _assert_state_equal(unc, port)
        _assert_state_equal(ref, port)
        assert port.device_cache.stats() == ref.device_cache.stats()
    assert port.device_cache.invalidations == ref.device_cache.invalidations
    assert port.device_cache.counters["hits"] > 0
    for c in (unc, ref, port):
        c.close()


def _tables_equal(port_cache, ref_cache):
    assert set(port_cache._tables) == set(ref_cache._tables)
    for name, rt in ref_cache._tables.items():
        pt = port_cache._tables[name]
        assert pt.pk_slot == rt.pk_slot
        assert (pt.next_slot, pt.cap_rows, pt.cap_cells, pt.cells_used) == (
            rt.next_slot, rt.cap_rows, rt.cap_cells, rt.cells_used)
        np.testing.assert_array_equal(pt.store.to_host(pt.row_cl),
                                      rt.store.to_host(rt.row_cl))
        np.testing.assert_array_equal(pt.store.to_host(pt.cell_ver),
                                      rt.store.to_host(rt.cell_ver))
        np.testing.assert_array_equal(pt.cell_keys, rt.cell_keys)
        np.testing.assert_array_equal(pt.row_known, rt.row_known)
        np.testing.assert_array_equal(pt.row_present, rt.row_present)
        unknown = [type(v).__name__ == "_ValUnknown" for v in rt.cell_val]
        assert [v is port_dc.VAL_UNKNOWN for v in pt.cell_val] == unknown
        assert [v for v, u in zip(pt.cell_val, unknown) if not u] == [
            v for v, u in zip(rt.cell_val, unknown) if not u]


def _recording(cache, log):
    """Record every lookup result of ``cache`` in ``log``."""
    for name in ("lookup", "lookup_seed"):
        fn = getattr(cache, name)

        def rec(*args, _fn=fn, _name=name):
            out = _fn(*args)
            log.append((_name, out))
            return out

        setattr(cache, name, rec)


@pytest.mark.parametrize("seed", range(4))
def test_cache_carried_across_answers_as_the_reference(tmp_path, seed):
    """Warm a reference cache, carry it into the port
    (``devcache_from_reference``) and go on: every lookup result, the
    state and the final arrays equal those of the reference cache that
    went on itself."""
    rng = random.Random(500 + seed)
    warm = [_stream(rng, 50) for _ in range(3)]
    more = [_stream(rng, 50) for _ in range(4)]
    a = _mk(tmp_path, f"a{seed}", columnar=True)
    b = _mk(tmp_path, f"b{seed}", columnar=True)
    for c in (a, b):
        c.enable_device_cache(slots=128, backend="numpy")
        for batch in warm:
            c.apply_changes_batched(list(batch))
    b.device_cache = devcache_from_reference(b.device_cache, device="cpu")
    assert b.device_cache.backend == "torch"
    _tables_equal(b.device_cache, a.device_cache)
    log_a, log_b = [], []
    _recording(a.device_cache, log_a)
    _recording(b.device_cache, log_b)
    for batch in more:
        assert a.apply_changes_batched(list(batch)) == \
            b.apply_changes_batched(list(batch))
    assert log_a and log_b == log_a
    for c in (a, b):
        c.flush_barrier()
    _assert_state_equal(a, b)
    _tables_equal(b.device_cache, a.device_cache)
    assert b.device_cache.stats() == a.device_cache.stats()
    for c in (a, b):
        c.close()


def test_corrupted_cached_version_is_detected(tmp_path):
    """Negative control (tests/test_devcache.py
    ``test_stale_cache_corruption_detected``, on a cell version): one
    corrupted ``cell_ver`` entry of the torch store makes the port's
    cache keep a value the uncached path replaces."""
    from corrosion_tpu_torch.agent.pack import pack_values
    from corrosion_tpu_torch.types.base import CrsqlDbVersion, CrsqlSeq
    from corrosion_tpu_torch.types.change import Change
    from tests.test_torch_storage import SITES, port_conn

    unc = port_conn(tmp_path, "corr-unc", columnar=True)
    dev = port_conn(tmp_path, "corr-dev", columnar=True)
    dev.enable_device_cache(backend="torch", device="cpu")
    pk = pack_values([1])

    def change(val, version):
        return [Change(table="items", pk=pk, cid="a", val=val,
                       col_version=version, db_version=CrsqlDbVersion(version),
                       seq=CrsqlSeq(0), site_id=SITES[0], cl=1)]

    for c in (unc, dev):
        c.apply_changes_batched(change("v1", 1))
    dev.flush_barrier()
    assert _dump(unc) == _dump(dev)
    tc = dev.device_cache._tables["items"]
    key = tc.pk_slot[pk] * tc.n_cid + tc.cid_ord["a"] + 1
    (pos,) = tc.cell_find(np.array([key], np.int64))
    tc.cell_ver[int(pos)] = 9  # the cache now believes version 9
    for c in (unc, dev):
        c.apply_changes_batched(change("v2", 2))
    dev.flush_barrier()
    assert _dump(unc) != _dump(dev)
    with pytest.raises(AssertionError):
        _assert_state_equal(unc, dev)
    unc.close()
    dev.close()
