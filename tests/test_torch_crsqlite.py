"""The port's golden bridge (``corrosion_tpu_torch/bridge/crsqlite_ref.py``).

Without the vendored cr-sqlite extension (``CRSQLITE_SO``, or its place
in the repository) both packages' bridges find nothing and refuse
alike, and the row order the golden comparisons sort by is the
reference's.  With the extension, the port's engine (``CrConn``)
replays the reference's golden scenarios against cr-sqlite itself; those
tests skip where no extension is found, as the reference's do.
"""

import numpy as np
import pytest

from corrosion_tpu.bridge import crsqlite_ref as ref_bridge
from corrosion_tpu_torch.agent.storage import CrConn
from corrosion_tpu_torch.bridge import CrsqliteRef, crsqlite_available
from corrosion_tpu_torch.bridge import crsqlite_ref as port_bridge

VALUE_POOL = [
    None, -7, 0, 1, 10, 2**40, 0.5, -2.25, 10.0,
    "", "a", "z", "hello", "héllo", "10",
    b"", b"\x00", b"blob", b"\xff\xff",
]


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_key_equals_reference(seed):
    rng = np.random.default_rng(seed)
    rows = [tuple(VALUE_POOL[i] for i in rng.integers(0, len(VALUE_POOL), 3))
            for _ in range(200)]
    assert [port_bridge._sort_key(r) for r in rows] == [
        ref_bridge._sort_key(r) for r in rows]
    assert sorted(rows, key=port_bridge._sort_key) == sorted(
        rows, key=ref_bridge._sort_key)


def test_without_the_extension_both_refuse(tmp_path, monkeypatch):
    missing = str(tmp_path / "crsqlite-linux-x86_64.so")
    for mod in (port_bridge, ref_bridge):
        monkeypatch.setattr(mod, "_SO_CANDIDATES", ("", missing))
        assert mod.find_crsqlite_so() is None
        assert mod.crsqlite_available() is False
        with pytest.raises(FileNotFoundError, match="CRSQLITE_SO"):
            mod.CrsqliteRef(":memory:")
    assert port_bridge.CHANGES_COLS == ref_bridge.CHANGES_COLS


golden = pytest.mark.skipif(
    not crsqlite_available(),
    reason="vendored cr-sqlite extension not loadable",
)

SCHEMA = (
    "CREATE TABLE foo ("
    " id INTEGER NOT NULL PRIMARY KEY,"
    " a TEXT, b INTEGER, c REAL, v);"
)


def _pair(tmp_path, i):
    ref = CrsqliteRef(":memory:")
    ref.conn.executescript(SCHEMA)
    ref.as_crr("foo")
    mine = CrConn(str(tmp_path / f"mine_{i}.db"), site_id=ref.site_id)
    mine.conn.executescript(SCHEMA)
    mine.as_crr("foo")
    return ref, mine


def _all_changes(c):
    out = []
    for _, sid in c.conn.execute(
            "SELECT ordinal, site_id FROM __corro_sites ORDER BY ordinal"):
        sid = bytes(sid)
        out.extend(c.collect_changes((0, 1 << 60),
                                     None if sid == c.site_id else sid))
    return out


def _parity(pairs):
    for ref, mine in pairs:
        rows = sorted((tuple(r) for r in mine.read_query(
            "SELECT * FROM foo")[1]), key=port_bridge._sort_key)
        assert rows == ref.data("foo")


@golden
@pytest.mark.parametrize("va,vb", [(10, 20), (10, "10"), ("abc", b"abc"),
                                   (1.5, 1), (None, "")])
def test_concurrent_write_tie_break_matches_crsqlite(tmp_path, va, vb):
    pairs = [_pair(tmp_path, i) for i in range(2)]
    try:
        for (ref, mine), v in zip(pairs, (va, vb)):
            for eng in (ref, mine):
                eng.execute("INSERT INTO foo (id, v) VALUES (1, ?)", (v,))
        (r0, m0), (r1, m1) = pairs
        r1.apply(r0.changes())
        m1.apply_changes(_all_changes(m0))
        r0.apply(r1.changes())
        m0.apply_changes(_all_changes(m1))
        _parity(pairs)
    finally:
        for ref, mine in pairs:
            ref.close()
            mine.close()
