"""Snapshot bootstrap: build, stage, crash-safe install.

A fresh (or wiped, or long-dead) node catching up change-by-change pays
O(history) serve work on every peer it syncs from — at production scale
a restart storm turns bootstrap into a cluster-wide serve stampede.
This module is the data half of the snapshot path (docs/sync.md,
"Snapshot serve + install"):

* **build** — a consistent ``VACUUM INTO`` copy of a live database
  (safe against concurrent writers under WAL: the vacuum runs inside
  one read transaction), scrubbed of node-local state by the shared
  :data:`SNAP_SCRUB` registry — the SAME decision set ``backup.py``
  uses, so a bookkeeping table added later cannot silently leak into
  snapshots (the registry-coverage regression test fails instead);
* **stage** — the receiving client writes the snapshot stream into a
  sidecar file next to its database, with a journal marker recording
  the expected whole-snapshot digest, so a crash at ANY point boots
  into a clean retry rather than a torn database;
* **install** — after the content digest verifies, the staged file is
  rewritten in place to carry the INSTALLING node's identity (the
  ``backup.restore`` site-ordinal rewrite), then atomically swapped in
  with ``os.replace`` under the storage lock.  The marker protocol
  makes every crash window recoverable:

  ======================  =========================================
  crash window            boot recovery (:func:`recover_pending_install`)
  ======================  =========================================
  mid-stream / pre-swap   discard sidecar + marker, retry from scratch
  marker written, staged  discard sidecar + marker (old DB intact),
  still present           retry from scratch
  after ``os.replace``    the DB *is* the fully-prepared snapshot:
  (staged gone)           drop the marker, resume normal boot + tail
  ======================  =========================================

The dispatch rule (which peer/need combination goes snapshot instead
of change-by-change) is the pure-function pair
:func:`covered_below_floor` / :func:`client_behind` — a client
requests a snapshot exactly when the server's advertised per-actor
snapshot floors cover needs the server can no longer serve as changes
(its below-floor bookkeeping is compacted) and the client is strictly
behind the server on every actor it tracks (so the install cannot
lose local-only writes).
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
from typing import Dict, Optional

#: node-local tables a snapshot (and a backup) must NOT carry: the
#: receiving node has its own membership view, its own compaction work
#: list, and its own bounded digest cache (the digests are a
#: node-local detection FIFO — reloading another node's window would
#: evict the receiver's own evidence).
SNAP_SCRUB = frozenset({
    "__corro_members",
    "__corro_versions_impacted",
    "__corro_equiv_digests",
    # write-behind flush journal (device-resident apply): donor-local
    # crash bookkeeping — the donor drains before building a snapshot,
    # and a receiver must never replay another node's flush intents
    "__corro_flush_journal",
})

#: portable cluster state a snapshot MUST carry: the data's version
#: cursor (``__corro_state``, minus the node-local ``incarnation`` key
#: — see :func:`scrub_snapshot`), site directory, CRR registry, the
#: whole bookkeeping plane (versions, cleared ranges, partial buffers,
#: gaps, cleared watermarks, snapshot floors), signed equivocation
#: proofs (cryptographic evidence is valid on any node —
#: docs/faults.md, signed attribution), and the pending as_crr
#: backfill queue: its table rows travel in the copy but are still
#: UNVERSIONED, so without the queue entry the receiver's boot-time
#: ``_register_backfills`` would never version them and they would
#: silently drop out of replication.
SNAP_KEEP = frozenset({
    "__corro_state",
    "__corro_sites",
    "__corro_crr_tables",
    "__corro_bookkeeping",
    "__corro_seq_bookkeeping",
    "__corro_buffered_changes",
    "__corro_bookkeeping_gaps",
    "__corro_sync_state",
    "__corro_equiv_proofs",
    "__corro_snap_floors",
    "__corro_backfills",
})

#: per-CRR-table bookkeeping suffixes (clock + causal-length tables):
#: these ARE the replicated state — always kept.
SNAP_KEEP_SUFFIXES = ("__corro_clock", "__corro_cl")

#: prefix-classified node-local families (consul session cache).
SNAP_SCRUB_PREFIXES = ("__corro_consul_",)

#: node-local keys inside kept tables: scrubbed even though the table
#: itself is portable.
SNAP_SCRUB_STATE_KEYS = ("incarnation",)

DIGEST_LEN = 32
_CHUNK = 1 << 20


class SnapshotError(Exception):
    """A snapshot build/stage/install step failed."""


class SnapshotCrash(Exception):
    """Harness-injected crash at a named install stage (faults.SnapFault
    via the virtual cluster) — never raised on a production path."""

    def __init__(self, stage: str):
        super().__init__(stage)
        self.stage = stage


def classify_table(name: str) -> Optional[str]:
    """``"keep"`` / ``"scrub"`` for a ``__corro_*`` table, None for a
    user table.  Every internal table must classify — an unknown
    ``__corro_*`` name raises so a future bookkeeping table cannot
    silently leak into (or vanish from) snapshots."""
    if any(name.endswith(sfx) for sfx in SNAP_KEEP_SUFFIXES):
        # per-CRR-table clock/cl tables ("tests__corro_clock"): the
        # replicated state itself, named after the user table
        return "keep"
    if not name.startswith("__corro_"):
        return None
    if name in SNAP_SCRUB:
        return "scrub"
    if name in SNAP_KEEP:
        return "keep"
    if any(name.startswith(pfx) for pfx in SNAP_SCRUB_PREFIXES):
        return "scrub"
    raise SnapshotError(
        f"internal table {name!r} has no snapshot scrub/keep decision — "
        "add it to snapshot.SNAP_SCRUB or snapshot.SNAP_KEEP"
    )


def scrub_snapshot(conn: sqlite3.Connection) -> None:
    """Delete node-local state from a snapshot/backup copy (shared by
    the sync snapshot path and ``backup.py``).  Caller commits."""
    tables = [
        r[0]
        for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "AND name LIKE '\\_\\_corro\\_%' ESCAPE '\\'"
        )
    ]
    for t in tables:
        if classify_table(t) == "scrub":
            conn.execute(f'DELETE FROM "{t}"')
    for key in SNAP_SCRUB_STATE_KEYS:
        conn.execute("DELETE FROM __corro_state WHERE key=?", (key,))


def _connect(path: str) -> sqlite3.Connection:
    """Open a database with the CRR layer's SQL functions registered
    (expression indexes reference them)."""
    from corrosion_tpu_torch.agent.storage import register_udfs

    conn = sqlite3.connect(path)
    register_udfs(conn)
    return conn


def build_snapshot(db_path: str, out_path: str) -> None:
    """Write a consistent, scrubbed, single-file snapshot of
    ``db_path`` to ``out_path`` (must not exist).  Safe against a live
    writer: ``VACUUM INTO`` copies one WAL read snapshot."""
    if os.path.exists(out_path):
        raise SnapshotError(f"snapshot target exists: {out_path}")
    src = _connect(db_path)
    try:
        src.execute("VACUUM INTO ?", (out_path,))
    finally:
        src.close()
    snap = _connect(out_path)
    try:
        # single file on disk: the staged copy travels (and swaps) as
        # one artifact, never a db + sidecar-journal pair
        snap.execute("PRAGMA journal_mode=DELETE")
        scrub_snapshot(snap)
        snap.commit()
        snap.execute("VACUUM")
    finally:
        snap.close()


def file_digest(path: str) -> bytes:
    """Whole-file blake2b content digest (the install gate: a served
    snapshot installs only when the received bytes hash to the digest
    the offer advertised)."""
    h = hashlib.blake2b(digest_size=DIGEST_LEN)
    with open(path, "rb") as f:
        while True:
            block = f.read(_CHUNK)
            if not block:
                break
            h.update(block)
    return h.digest()


# ---------------------------------------------------------------------------
# staging sidecar + crash journal
# ---------------------------------------------------------------------------


def fsync_dir(path: str) -> None:
    """fsync the directory holding ``path``: a rename/unlink is only
    durable once its directory entry is — without this a power loss
    (not just a process kill) could reorder the marker rename against
    the database swap and present the boot-time recovery with a
    window its classification table calls impossible."""
    d = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def staged_path(db_path: str) -> str:
    return db_path + ".snap-staged"


def marker_path(db_path: str) -> str:
    return db_path + ".snap-state"


def write_marker(db_path: str, stage: str, digest: bytes,
                 size: int) -> None:
    """Durably record the install state machine's position: written
    BEFORE each irreversible step so a crash at any point is
    classifiable at boot."""
    p = marker_path(db_path)
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(
            {"stage": stage, "digest": digest.hex(), "size": int(size)}, f
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, p)
    fsync_dir(p)


def read_marker(db_path: str) -> Optional[dict]:
    try:
        with open(marker_path(db_path)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def clear_marker(db_path: str) -> None:
    removed = False
    for p in (marker_path(db_path), marker_path(db_path) + ".tmp"):
        if os.path.exists(p):
            os.unlink(p)
            removed = True
    if removed:
        fsync_dir(db_path)


def recover_pending_install(db_path: str) -> Optional[str]:
    """Boot-time crash recovery (called before storage opens).  A node
    killed at ANY install point classifies into exactly two outcomes:

    * ``"finalized"`` — the marker says ``installing`` and the staged
      sidecar is GONE: ``os.replace`` completed, so the database IS the
      fully-prepared snapshot (identity rewrite happens on the staged
      file *before* the swap).  Drop the marker and boot normally; the
      tail anti-entropy round picks up the delta.
    * ``"retry"`` — every other window (mid-stream, verified-but-
      unswapped, marker-but-staged-present): discard the sidecar and
      marker.  The previous database is untouched — the node boots
      into a clean snapshot retry, never a torn install.

    Returns the outcome, or None when no install was pending.
    """
    m = read_marker(db_path)
    sp = staged_path(db_path)
    if m is None:
        if os.path.exists(sp):
            # orphan sidecar with no journal: a crash before the first
            # marker write — nothing was promised, discard it
            os.unlink(sp)
            return "retry"
        return None
    if m.get("stage") == "installing" and not os.path.exists(sp):
        # the swap completed; a crash before the stale -wal/-shm of the
        # REPLACED inode were unlinked leaves them next to the new file
        # — they must not be recovered into the installed snapshot
        for ext in ("-wal", "-shm"):
            p = db_path + ext
            if os.path.exists(p):
                os.unlink(p)
        clear_marker(db_path)
        return "finalized"
    if os.path.exists(sp):
        os.unlink(sp)
    clear_marker(db_path)
    return "retry"


def prepare_staged(staged: str, site_id: bytes,
                   incarnation: Optional[int] = None) -> None:
    """Rewrite a verified staged snapshot IN PLACE to carry the
    installing node's identity — the ``backup.restore`` site-ordinal
    rewrite, run on the sidecar *before* the atomic swap so a crash
    after ``os.replace`` needs no further repair.

    The snapshot origin's identity moves from ordinal 1 to a fresh
    ordinal (keeping every clock row's attribution intact) and ordinal
    1 — the slot the local triggers stamp — becomes ``site_id``.  When
    the installing node's identity already exists in the snapshot's
    site directory (the server knew us), its existing ordinal is
    REUSED: its clock rows re-attribute to ordinal 1 instead of a
    unique-constraint failure."""
    conn = _connect(staged)
    try:
        conn.execute("PRAGMA journal_mode=DELETE")
        row = conn.execute(
            "SELECT site_id FROM __corro_sites WHERE ordinal=1"
        ).fetchone()
        if row is None:
            raise SnapshotError("staged snapshot has no site directory")
        origin = bytes(row[0])
        tables = [
            r[0]
            for r in conn.execute("SELECT name FROM __corro_crr_tables")
        ]

        def _rewrite(old_ord: int, new_ord: int) -> None:
            for t in tables:
                for suffix in SNAP_KEEP_SUFFIXES:
                    conn.execute(
                        f'UPDATE "{t}{suffix}" SET site_ordinal=? '
                        "WHERE site_ordinal=?",
                        (new_ord, old_ord),
                    )

        if origin != site_id:
            (max_ord,) = conn.execute(
                "SELECT COALESCE(MAX(ordinal), 1) FROM __corro_sites"
            ).fetchone()
            ours = conn.execute(
                "SELECT ordinal FROM __corro_sites WHERE site_id=?",
                (site_id,),
            ).fetchone()
            # origin identity out of slot 1, attribution preserved
            conn.execute(
                "UPDATE __corro_sites SET ordinal=? WHERE ordinal=1",
                (max_ord + 1,),
            )
            _rewrite(1, max_ord + 1)
            if ours is not None:
                conn.execute(
                    "UPDATE __corro_sites SET ordinal=1 WHERE site_id=?",
                    (site_id,),
                )
                _rewrite(ours[0], 1)
            else:
                conn.execute(
                    "INSERT INTO __corro_sites (ordinal, site_id) "
                    "VALUES (1, ?)",
                    (site_id,),
                )
        if incarnation is not None:
            conn.execute(
                "INSERT INTO __corro_state (key, value) "
                "VALUES ('incarnation', ?) "
                "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
                (int(incarnation),),
            )
        conn.commit()
    finally:
        conn.close()
    # the prepared bytes must be durable BEFORE the 'installing' marker
    # promises them: fsync file + directory entry
    fd = os.open(staged, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    fsync_dir(staged)


# ---------------------------------------------------------------------------
# snapshot-or-changes dispatch (pure functions)
# ---------------------------------------------------------------------------


def covered_below_floor(needs: Dict, floors: Dict) -> int:
    """How many of the client's needed versions sit at-or-below the
    server's advertised per-actor snapshot floors — versions whose
    per-version bookkeeping the server has COMPACTED and therefore can
    no longer serve change-by-change.  Pure in (client needs, server
    floors): the whole snapshot-or-changes dispatch decides on this
    count (≥ 1 ⇒ only a snapshot can deliver them from this peer)."""
    covered = 0
    for actor, actor_needs in needs.items():
        floor = int(floors.get(actor, 0))
        if floor <= 0:
            continue
        for n in actor_needs:
            if n.kind == "full":
                s, e = n.versions
                if s <= floor:
                    covered += min(int(e), floor) - int(s) + 1
            elif n.kind == "partial" and int(n.version) <= floor:
                covered += 1
    return covered


def client_behind(our_heads: Dict, their_heads: Dict) -> bool:
    """Install-safety gate: a snapshot REPLACES the client's database,
    so it is only sound when the server's recorded head for every
    actor the client tracks (including the client's own) is at least
    the client's — otherwise local-only writes would be lost.  Pure in
    (client heads, server heads); re-checked under the storage lock
    immediately before the swap."""
    for actor, head in our_heads.items():
        if int(head) > int(their_heads.get(actor, 0)):
            return False
    return True
