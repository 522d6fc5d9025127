"""The port's storage engine (``corrosion_tpu_torch/agent/storage.py``)
against the reference's (``corrosion_tpu/agent/storage.py``), on the CPU.

The same change streams (the randomized and fuzz streams of
tests/test_apply_batched.py, and the eviction, crash-window, read-barrier
and snapshot-install cases of tests/test_devcache.py), converted with
``convert.changes_from_reference``, go through a reference ``CrConn`` and
a port ``CrConn`` in each arm: per-change, batched by dict replay,
batched by the columnar kernel, and device-resident (the reference with
its NumPy-store cache, the port with its torch store on the CPU).  Each
port arm must leave the reference arm's state exactly: data, clock and
causal-length tables, site interning, compaction impact records,
``collect_changes`` and the rows-impacted counts.
"""

import random
import shutil

import pytest

from corrosion_tpu.agent import pack as ref_pack
from corrosion_tpu.agent.storage import CrConn as RefConn
from corrosion_tpu.types.base import CrsqlDbVersion as RefDbVersion
from corrosion_tpu.types.base import CrsqlSeq as RefSeq
from corrosion_tpu.types.change import Change as RefChange
from corrosion_tpu_torch.agent import pack as port_pack
from corrosion_tpu_torch.agent.storage import CrConn
from corrosion_tpu_torch.convert import changes_from_reference
from tests.test_apply_batched import SCHEMA, SITES, _dump, _stream

ARMS = ("per_change", "dict", "columnar", "device")


def _setup(conn, columnar):
    if columnar is True:
        conn.columnar_merge_min = 0
    elif columnar is False:
        conn.columnar_merge = False
    conn.conn.executescript(SCHEMA)
    for t in ("items", "typed", "pkonly"):
        conn.as_crr(t)
    return conn


def port_conn(tmp_path, name, columnar=None):
    """A port CRR database with tests/test_apply_batched.py's schema
    (``columnar`` as that file's ``_mk`` takes it)."""
    return _setup(CrConn(str(tmp_path / f"{name}.db"), site_id=b"\x77" * 16),
                  columnar)


def _ref_conn(tmp_path, name, columnar=None):
    return _setup(RefConn(str(tmp_path / f"{name}.db"), site_id=b"\x77" * 16),
                  columnar)


def _arm(tmp_path, tag, arm, port, slots=None):
    mk = port_conn if port else _ref_conn
    columnar = {"dict": False, "columnar": True, "device": True}.get(arm)
    conn = mk(tmp_path, f"{'port' if port else 'ref'}-{arm}-{tag}", columnar)
    if arm == "device":
        if port:
            conn.enable_device_cache(slots=slots, backend="torch",
                                     device="cpu")
        else:
            conn.enable_device_cache(slots=slots, backend="numpy")
    return conn


def _apply(conn, arm, batch):
    if arm == "per_change":
        with conn.apply_tx():
            return conn.apply_changes_sequential_in_tx(list(batch))
    return conn.apply_changes_batched(list(batch))


def _fields(changes):
    return [(c.table, c.pk, c.cid, c.val, c.col_version, int(c.db_version),
             int(c.seq), c.site_id, c.cl) for c in changes]


def assert_same_state(ref, port):
    """The reference connection's observable CRDT state equals the
    port's (``_dump``'s queries, ``collect_changes`` per origin)."""
    want, got = _dump(ref), _dump(port)
    for key in want:
        assert got[key] == want[key], f"divergence in {key}"
    for site in SITES + [ref.site_id]:
        origin = None if site == ref.site_id else site
        assert _fields(port.collect_changes((1, 64), origin)) == _fields(
            ref.collect_changes((1, 64), origin)), site[:1].hex()


def _local_writes(conn):
    conn.execute("INSERT INTO items (id, a, b) VALUES (1, 'local', 0)")
    conn.execute("INSERT INTO typed (id, name, n) VALUES (2, 'loc', 7)")
    conn.execute("INSERT INTO pkonly (k) VALUES (3)")


def _pairs(tmp_path, tag, slots=None):
    return {arm: (_arm(tmp_path, tag, arm, False, slots),
                  _arm(tmp_path, tag, arm, True, slots)) for arm in ARMS}


def _close(pairs):
    for ref, port in pairs.values():
        ref.close()
        port.close()


def _round(pairs, batch):
    port_batch = changes_from_reference(batch)
    counts = set()
    for arm, (ref, port) in pairs.items():
        n_ref = _apply(ref, arm, batch)
        assert _apply(port, arm, port_batch) == n_ref, arm
        counts.add(n_ref)
        if arm == "device":
            ref.flush_barrier()
            port.flush_barrier()
        assert_same_state(ref, port)
    assert len(counts) == 1, counts


# seeds 0-7: test_batched_apply_parity_randomized's (three rounds);
# 100-105: the first of test_batched_apply_parity_fuzz_200's (two)
@pytest.mark.parametrize("seed,rounds", [(s, 3) for s in range(8)]
                         + [(s, 2) for s in range(100, 106)])
def test_port_arms_equal_reference_arms(tmp_path, seed, rounds):
    rng = random.Random(seed)
    pairs = _pairs(tmp_path, seed)
    for ref, port in pairs.values():
        _local_writes(ref)
        _local_writes(port)
    for _ in range(rounds):
        _round(pairs, _stream(rng, 40))
    ref_dev, port_dev = pairs["device"]
    assert port_dev.device_cache.stats() == ref_dev.device_cache.stats()
    _close(pairs)


def _wide_changes(n_rows, col_version):
    """tests/test_devcache.py ``_wide_changes`` (reference types)."""
    return [
        RefChange(table="items", pk=ref_pack.pack_values([i]), cid="a",
                  val=f"v{col_version}-{i}", col_version=col_version,
                  db_version=RefDbVersion(col_version), seq=RefSeq(i),
                  site_id=SITES[0], cl=1)
        for i in range(n_rows)
    ]


def test_eviction_pressure(tmp_path):
    """More pks than a 64-slot cache holds: capacity clears the table
    (evictions) in both caches alike, and every arm stays equal."""
    pairs = _pairs(tmp_path, "ev", slots=64)
    for cv in (1, 2):
        changes = _wide_changes(150, cv)
        for lo in range(0, 150, 50):
            _round(pairs, changes[lo:lo + 50])
    ref, port = pairs["device"]
    assert port.device_cache.counters["evictions"] > 0
    assert port.device_cache.stats() == ref.device_cache.stats()
    _close(pairs)


def _journal_rows(conn):
    return conn.conn.execute(
        "SELECT COUNT(*) FROM __corro_flush_journal").fetchone()[0]


def test_crash_window_journal_recovery(tmp_path):
    """A committed device merge whose flush never ran: the port replays
    its journal at reopen as the reference does."""
    rng = random.Random(99)
    ref = _arm(tmp_path, "crash", "device", False, slots=128)
    port = _arm(tmp_path, "crash", "device", True, slots=128)
    for _ in range(5):
        batch = _stream(rng, 50)
        ref.apply_changes_batched(list(batch))
        port.apply_changes_batched(changes_from_reference(batch))
    pending = len(port._wb.pending)
    assert pending == len(ref._wb.pending) > 0
    assert _journal_rows(port) == _journal_rows(ref) > 0
    reopened = []
    for cls, conn in ((RefConn, ref), (CrConn, port)):
        conn.conn.close()  # no drain: the simulated crash
        reopened.append(cls(conn.path, site_id=b"\x77" * 16))
    ref2, port2 = reopened
    assert port2.flush_journal_recovered == pending
    assert _journal_rows(port2) == 0
    assert_same_state(ref2, port2)
    ref2.close()
    port2.close()


def test_read_paths_barrier_unflushed_winners(tmp_path):
    """``read_query`` and ``collect_changes_ro`` drain the write-behind
    queue before they read, in the port as in the reference."""
    ref = _arm(tmp_path, "bar", "device", False)
    port = _arm(tmp_path, "bar", "device", True)
    for conn, conv in ((ref, list), (port, changes_from_reference)):
        conn.apply_changes_batched(conv(_wide_changes(10, 1)))
        assert len(conn._wb.pending) > 0
        assert conn.read_query("SELECT a FROM items WHERE id = 3")[1] == [
            ("v1-3",)]
        assert len(conn._wb.pending) == 0
        conn.apply_changes_batched(conv(_wide_changes(10, 2)))
    with ref.reader() as rc, port.reader() as pc:
        assert _fields(port.collect_changes_ro(pc, (1, 64), SITES[0])) == \
            _fields(ref.collect_changes_ro(rc, (1, 64), SITES[0]))
    assert_same_state(ref, port)
    ref.close()
    port.close()


def test_read_barrier_waits_for_a_drain_on_another_thread(tmp_path):
    """A drain on one thread takes the queue off ``pending`` before it
    writes: a ``read_query`` on another thread meanwhile waits for that
    drain's commit and sees its winners (the reference's barrier returns
    at once there, and its read misses them)."""
    import threading

    port = _arm(tmp_path, "race", "device", True)
    port.apply_changes_batched(changes_from_reference(_wide_changes(10, 1)))
    assert len(port._wb.pending) > 0
    taken, release = threading.Event(), threading.Event()
    real = port._wb_flush_entries_in_tx

    def held_flush(entries):
        taken.set()
        assert release.wait(10)
        return real(entries)

    port._wb_flush_entries_in_tx = held_flush
    drain = threading.Thread(target=port.flush_pending)
    drain.start()
    assert taken.wait(10) and port._wb.pending == []
    got = []
    read = threading.Thread(target=lambda: got.append(port.read_query(
        "SELECT a FROM items WHERE id = 3")[1]))
    read.start()
    read.join(0.3)
    assert read.is_alive() and got == []  # waiting for the drain
    release.set()
    drain.join(10)
    read.join(10)
    assert got == [[("v1-3",)]] and port._wb.flushing == 0
    port.close()


def test_snapshot_install_invalidates_and_purges_journal(tmp_path):
    """Installing a donor's snapshot drops the cache and purges the
    donor's journal rows unread; later applies re-seed from the file."""
    donor = _ref_conn(tmp_path, "donor")
    donor.execute("INSERT INTO items (id, a) VALUES (9, 'donor')")
    donor.conn.execute(
        "INSERT INTO __corro_flush_journal (tbl, payload) VALUES (?, ?)",
        ("items", b"\x01not-a-pickle"))
    donor.conn.commit()
    donor.close()
    ref = _arm(tmp_path, "recv", "device", False)
    port = _arm(tmp_path, "recv", "device", True)
    for conn, conv in ((ref, list), (port, changes_from_reference)):
        conn.apply_changes_batched(conv(_wide_changes(8, 1)))
        assert len(conn._wb.pending) > 0
        # the install moves the file it is given: a copy each
        snapshot = shutil.copy(donor.path, conn.path + ".donor")
        conn.install_snapshot(snapshot)
        assert _journal_rows(conn) == 0 and len(conn._wb.pending) == 0
        assert conn.device_cache.invalidations.get("snapshot_install", 0) > 0
        conn.apply_changes_batched(conv(_wide_changes(8, 3)))
        conn.flush_barrier()
    assert port.read_query("SELECT a FROM items WHERE id = 9")[1] == [
        ("donor",)]
    assert_same_state(ref, port)
    assert port.device_cache.stats() == ref.device_cache.stats()
    ref.close()
    port.close()


# the bench stream's value types (bench.py ``_apply_bench_changes``) and
# every SQL value type of tests/test_apply_batched.py's generator
PACK_VALUES = [None, 0, 1, -5, 2.5, -0.25, "x", "yy", "", b"", b"\x00\x01",
               b"\xff", 123456789, "unicode-é", "v2-65535-d", 1 << 62,
               -(1 << 63), 1e300]


@pytest.mark.parametrize("i", range(len(PACK_VALUES)))
def test_pack_values_equal_reference(i):
    """The port's Python codec equals the reference's ``pack_values``
    (its native kernel where built), byte for byte, and both orders."""
    v = PACK_VALUES[i]
    for row in ([v], [i, v], [v, "a", b"b"]):
        blob = port_pack.pack_values(row)
        assert blob == ref_pack.pack_values(row)
        assert port_pack.unpack_values(blob) == ref_pack.unpack_values(blob)
    for w in PACK_VALUES:
        assert port_pack.value_cmp(v, w) == ref_pack.value_cmp(v, w)
