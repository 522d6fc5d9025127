"""Device-resident clock cache for the batched CRDT apply path.

The port of ``corrosion_tpu/ops/devcache.py``: the host code (the
packed-key index, the transactional shadow, the promotes) is the
reference's, copied; ``TorchStore`` takes the place of ``JaxStore`` and
keeps the clock arrays as int64 tensors on a device, its ``set`` and
``gather`` on the hand-written kernels of ``kernels/store.py``.

The columnar apply kernel (:mod:`corrosion_tpu_torch.ops.merge`) made winner
selection array-shaped, but every batch still re-seeds its DB view from
three SQLite prefetches and throws the merged clocks away after the
flush.  This module keeps that hot state resident across batches: per
CRR table, an open-addressed packed-key index maps ``(pk, cid)`` cells
to slots in int64 arrays that live on the configured backend — plain
ndarrays on the NumPy store, tensors on the card on the torch store —
so a steady stream of batches for the same rows
merges with **zero** SQLite prefetches and one device scatter per
commit.

Correctness contract (docs/crdts.md "Device-resident apply"):

* the cache is a *view*, never the truth — SQLite stays the durable
  sink behind :class:`corrosion_tpu_torch.agent.storage` write-behind flush;
* all knowledge is full-row: a pk is served only when its causal
  length, row presence, and every requested cell (version *and* value)
  are known, else the whole pk misses and the caller re-prefetches;
* uncommitted state lives in a per-transaction shadow overlay
  (:meth:`DeviceClockCache.install` / :meth:`~DeviceClockCache.stage_states`
  write shadow-only) promoted into the main arrays at commit and
  discarded on rollback, so a rolled-back apply can never poison the
  cache;
* slots are monotonic and never reused — invalidation retires a pk's
  slot, orphaning its packed cell keys, instead of tombstoning the
  index; capacity pressure clears the whole table (counted as
  evictions) and the next batch re-seeds from SQLite.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.kernels import store as kstore

DEFAULT_SLOTS = 262144

# Fibonacci-multiplier hash over packed keys; scalar (python int) and
# vector (uint64 ndarray) forms below agree bit for bit.
_HASH_MULT = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1

# Cell version sentinel on the *output* side: "known, and no clock row
# exists".  Versions are >= 1, so -1 is unreachable.
ABSENT = -1


class _ValUnknown:
    """Clock version cached without its value (the install's selected
    columns didn't cover this cid) — forces a pk miss when requested."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<val-unknown>"


VAL_UNKNOWN = _ValUnknown()


def default_enabled() -> bool:
    """Auto-default for an agent's ``device_cache=None``: on only when
    a CUDA card is present — hosts with no accelerator keep the
    prefetch path, the reference's rule (its ``default_enabled``)."""
    return torch.cuda.is_available()


def _pow2_ceil(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


class NumpyStore:
    """Host twin of the device store — same API over plain ndarrays.
    The bit-equality suite pins TorchStore against this."""

    backend = "numpy"

    def full(self, n: int, fill: int):
        return np.full(n, fill, dtype=np.int64)

    def set(self, arr, idx: np.ndarray, vals: np.ndarray):
        arr[idx] = vals
        return arr

    def gather(self, arr, idx: np.ndarray) -> np.ndarray:
        return arr[idx]

    def to_host(self, arr) -> np.ndarray:
        return arr

    def from_host(self, arr) -> np.ndarray:
        return np.ascontiguousarray(arr, dtype=np.int64)


class TorchStore:
    """Clock/cl arrays as int64 tensors on ``device`` (default
    ``"cuda"``, which raises without a card).  ``set`` scatters in place
    (``kernels.store.store_set``, last pair wins on a repeated index, as
    ``NumpyStore.set``) and returns the array, so callers keep the
    reference's rebinding form; ``gather`` comes back as one host
    ndarray (``kernels.store.store_gather``).  Both launch at n: no
    padding (the reference pads only to reuse XLA shapes).  On a CPU
    device both run the kernels' plain versions."""

    backend = "torch"

    def __init__(self, device=None):
        self.device = resolve_device("cuda" if device is None else device)
        self._owner = None  # store_set's int32 owner scratch, all -1

    def full(self, n: int, fill: int):
        return torch.full((n,), fill, dtype=torch.int64, device=self.device)

    def set(self, arr, idx: np.ndarray, vals: np.ndarray):
        owner = None
        if self.device.type == "cuda":
            if self._owner is None or self._owner.shape[0] < arr.shape[0]:
                self._owner = kstore.new_owner(arr.shape[0], self.device)
            owner = self._owner
        return kstore.store_set(arr, idx, vals, owner)

    def gather(self, arr, idx: np.ndarray) -> np.ndarray:
        return kstore.store_gather(arr, idx)

    def to_host(self, arr) -> np.ndarray:
        return arr.to("cpu", copy=True).numpy()

    def from_host(self, arr):
        return torch.from_numpy(
            np.array(arr, dtype=np.int64)
        ).to(self.device)


def make_store(backend: str = "auto", device=None):
    """``"numpy"``, ``"torch"`` (on ``device``, a card unless the caller
    asks for ``"cpu"``), or ``"auto"``: torch when ``default_enabled()``
    (a card is present), else NumPy."""
    if backend == "auto":
        backend = "torch" if default_enabled() else "numpy"
    if backend == "torch":
        return TorchStore(device)
    if backend == "numpy":
        return NumpyStore()
    raise ValueError(f"unknown devcache backend: {backend!r}")


class _TableShadow:
    """Per-transaction overlay for one table.

    ``rows[pk] = [cl, present, full]``:

    * ``cl``: causal length of the pk's ``__corro_cl`` row, or ``None``
      meaning *known to have no cl row* (always known once shadowed);
    * ``present``: data-row existence; ``None`` = inherit from the main
      cache (partial stage over a main-cache hit);
    * ``full``: the cells dict is exhaustive — a missing cid means *no
      clock row* (set by install, which sees every clock row for the
      pk, and by generation stages, which delete them all).

    ``cells[pk] = {cid: cell}`` with ``cell[0] = value`` (may be
    :data:`VAL_UNKNOWN`) and ``cell[1] = col_version`` — the layout of
    the merge's net-state cell tuples, so staging can BORROW the merge
    output dicts wholesale instead of re-keying every cell (tuples may
    carry trailing fields; only [0]/[1] are read here, and borrowed
    dicts are never mutated — an in-tx re-stage of the same pk builds
    a fresh merged dict).

    ``columnar`` memoizes the merge's own flat winner arrays when this
    shadow holds EXACTLY one staged batch with no generation rows and
    no prefetch install — the steady-state hot path — so the commit
    promote can scatter them straight into the device arrays instead
    of re-walking the dicts.  Anything that complicates the overlay
    (a second stage, an install, a targeted invalidation) clears it
    and the dict promote takes over.

    ``staged`` holds stage_states batches not yet folded into the
    dicts: the hot commit path promotes from ``columnar`` and never
    pays the dict build at all, so staging is LAZY — any reader of
    ``rows``/``cells`` must run ``_materialize`` first.
    """

    __slots__ = ("rows", "cells", "staged", "columnar")

    def __init__(self):
        self.rows: Dict[bytes, list] = {}
        self.cells: Dict[bytes, Dict[str, tuple]] = {}
        # deferred (info, states, cl_by_pk, vals_by_pk) stage batches
        self.staged: list = []
        # (plan, decision, cl_by_pk, vals_by_pk) or None
        self.columnar: Optional[tuple] = None


class _TableCache:
    """Main (committed) cache for one CRR table."""

    __slots__ = (
        "name", "n_cid", "cid_ord", "store", "max_rows", "max_cells",
        "pk_slot", "next_slot", "cap_rows", "row_cl", "row_known",
        "row_present", "cap_cells", "capbits", "cell_keys", "cell_ver",
        "cell_val", "cells_used",
    )

    def __init__(self, info, store, max_rows: int, max_cells: int):
        self.name = info.name
        self.n_cid = max(1, len(info.data_cols))
        self.cid_ord = {c: i for i, c in enumerate(info.data_cols)}
        self.store = store
        self.max_rows = max(64, int(max_rows))
        self.max_cells = max(64, int(max_cells))
        self._reset()

    def _reset(self) -> None:
        self.pk_slot: Dict[bytes, int] = {}
        self.next_slot = 0
        self.cap_rows = _pow2_ceil(min(1024, self.max_rows))
        self.row_cl = self.store.full(self.cap_rows, ABSENT)
        self.row_known = np.zeros(self.cap_rows, dtype=bool)
        self.row_present = np.zeros(self.cap_rows, dtype=bool)
        self.cap_cells = _pow2_ceil(min(4096, self.max_cells * 2))
        self.capbits = self.cap_cells.bit_length() - 1
        self.cell_keys = np.zeros(self.cap_cells, dtype=np.int64)
        self.cell_ver = self.store.full(self.cap_cells, 0)
        self.cell_val: List[object] = [None] * self.cap_cells
        self.cells_used = 0

    def live_entries(self) -> int:
        """Entries lost if this table were cleared (eviction accounting):
        live pks plus their reachable cells."""
        return len(self.pk_slot) + self.cells_used

    # -- keys ---------------------------------------------------------

    def _key(self, slot: int, cid: str) -> Optional[int]:
        o = self.cid_ord.get(cid)
        if o is None:
            return None
        return slot * self.n_cid + o + 1

    def _hash_scalar(self, key: int) -> int:
        return ((key * _HASH_MULT) & _MASK64) >> (64 - self.capbits)

    def _hash_vec(self, keys: np.ndarray) -> np.ndarray:
        prod = keys.astype(np.uint64) * np.uint64(_HASH_MULT)
        return (prod >> np.uint64(64 - self.capbits)).astype(np.int64)

    # -- rows ---------------------------------------------------------

    def room_for_rows(self, n: int) -> bool:
        return self.next_slot + n <= self.max_rows

    def ensure_row_capacity(self, n: int) -> None:
        """Grow the row arrays to hold ``n`` more slots; caller has
        already checked :meth:`room_for_rows`."""
        need = self.next_slot + n
        if need <= self.cap_rows:
            return
        cap = self.cap_rows
        while cap < need:
            cap <<= 1
        host = self.store.to_host(self.row_cl)
        new = np.full(cap, ABSENT, dtype=np.int64)
        new[: self.cap_rows] = host
        self.row_cl = self.store.from_host(new)
        nk = np.zeros(cap, dtype=bool)
        nk[: self.cap_rows] = self.row_known
        self.row_known = nk
        npr = np.zeros(cap, dtype=bool)
        npr[: self.cap_rows] = self.row_present
        self.row_present = npr
        self.cap_rows = cap

    def alloc_slot(self, pk: bytes) -> int:
        slot = self.next_slot
        self.next_slot = slot + 1
        self.pk_slot[pk] = slot
        return slot

    def retire(self, pk: bytes) -> bool:
        """Forget a pk: drop its slot (never reused) — its packed cell
        keys become unreachable garbage, reclaimed at the next clear."""
        slot = self.pk_slot.pop(pk, None)
        if slot is None:
            return False
        self.row_known[slot] = False
        return True

    # -- cells --------------------------------------------------------

    def room_for_cells(self, n: int) -> bool:
        return self.cells_used + n <= self.max_cells

    def ensure_cell_capacity(self, n: int) -> None:
        """Keep the open-addressed index under ~0.65 load after adding
        up to ``n`` entries; caller checked :meth:`room_for_cells`."""
        need = self.cells_used + n
        if need * 16 <= self.cap_cells * 10:  # load <= 0.625
            return
        cap = self.cap_cells
        while need * 16 > cap * 10:
            cap <<= 1
        old_keys = self.cell_keys
        live = np.nonzero(old_keys)[0]
        vers = self.store.gather(self.cell_ver, live) if len(live) \
            else np.zeros(0, dtype=np.int64)
        vals = [self.cell_val[int(i)] for i in live]
        self.cap_cells = cap
        self.capbits = cap.bit_length() - 1
        self.cell_keys = np.zeros(cap, dtype=np.int64)
        new_ver = np.zeros(cap, dtype=np.int64)
        self.cell_val = [None] * cap
        self.cells_used = 0
        mask = cap - 1
        for j, li in enumerate(live):
            key = int(old_keys[int(li)])
            i = self._hash_scalar(key)
            while int(self.cell_keys[i]) != 0:
                i = (i + 1) & mask
            self.cell_keys[i] = key
            new_ver[i] = int(vers[j])
            self.cell_val[i] = vals[j]
            self.cells_used += 1
        self.cell_ver = self.store.from_host(new_ver)

    def cell_put_batch(self, entries: List[Tuple[int, int, object]]) -> None:
        """Insert/update packed cells: ``(key, ver, val)`` triples
        (keys unique — shadow cells are per-pk dicts and slots are
        never shared).  One vectorized probe finds the already-present
        keys (the ENTIRE batch, in steady state); only genuinely new
        keys take the scalar insert walk.  Then ONE store scatter for
        the versions (the single device dispatch per commit).  Caller
        ensured capacity."""
        if not entries:
            return
        keys = np.fromiter(
            (e[0] for e in entries), np.int64, len(entries)
        )
        pos = self.cell_find(keys)
        missing = pos < 0
        if missing.any():
            mask = self.cap_cells - 1
            keys_arr = self.cell_keys
            for j in np.nonzero(missing)[0].tolist():
                key = entries[j][0]
                i = self._hash_scalar(key)
                while True:
                    k = int(keys_arr[i])
                    if k == key:
                        break
                    if k == 0:
                        keys_arr[i] = key
                        self.cells_used += 1
                        break
                    i = (i + 1) & mask
                pos[j] = i
        pos_l = pos.tolist()
        cell_val = self.cell_val
        vers = np.fromiter(
            (e[1] for e in entries), np.int64, len(entries)
        )
        for j, e in enumerate(entries):
            cell_val[pos_l[j]] = e[2]
        self.cell_ver = self.store.set(self.cell_ver, pos, vers)

    def cell_find(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized probe: index position per key, -1 if absent."""
        n = len(keys)
        out = np.full(n, -1, dtype=np.int64)
        if n == 0:
            return out
        mask = self.cap_cells - 1
        idx = self._hash_vec(keys)
        pending = np.arange(n)
        table = self.cell_keys
        for _ in range(self.cap_cells):
            cur = table[idx[pending]]
            hit = cur == keys[pending]
            out[pending[hit]] = idx[pending[hit]]
            cont = ~(hit | (cur == 0))
            pending = pending[cont]
            if len(pending) == 0:
                break
            idx[pending] = (idx[pending] + 1) & mask
        return out


class DeviceClockCache:
    """Cross-batch (pk, cid) clock cache with a transactional shadow.

    All methods take the internal RLock; callers additionally hold the
    storage write lock for every mutating path (documented contract —
    the cache orders itself relative to SQLite through that lock)."""

    def __init__(self, slots: int = DEFAULT_SLOTS, backend: str = "auto",
                 device=None):
        self.store = make_store(backend, device)
        self.backend = self.store.backend
        self.slots = max(64, int(slots))
        self._lock = threading.RLock()
        self._tables: Dict[str, _TableCache] = {}
        self._shadow: Dict[str, _TableShadow] = {}
        # monotonic counters; the agent emits metric deltas off these
        self.counters: Dict[str, float] = {
            "hits": 0.0, "misses": 0.0, "evictions": 0.0,
        }
        self.invalidations: Dict[str, float] = {}

    # -- plumbing -----------------------------------------------------

    def _table(self, info) -> _TableCache:
        tc = self._tables.get(info.name)
        if tc is None:
            max_rows = max(64, self.slots // 4)
            tc = self._tables[info.name] = _TableCache(
                info, self.store, max_rows, self.slots
            )
        return tc

    def _shadow_for(self, name: str) -> _TableShadow:
        sh = self._shadow.get(name)
        if sh is None:
            sh = self._shadow[name] = _TableShadow()
        return sh

    def _evict_table(self, tc: _TableCache) -> None:
        self.counters["evictions"] += tc.live_entries()
        tc._reset()

    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self.counters)
            out["invalidations"] = sum(self.invalidations.values())
            return out

    # -- read side ----------------------------------------------------

    def lookup(self, info, pks: List[bytes], ref_cids) -> Tuple[
        List[bytes], Dict[bytes, int], Dict[Tuple[bytes, str], int],
        Dict[bytes, dict],
    ]:
        """Resolve the merge seed view for a batch.

        Returns ``(miss_pks, cl_by_pk, clock_by_cell, vals_by_pk)``
        where the three dicts cover exactly the *hit* pks (shapes
        identical to the SQLite prefetches in
        ``storage._apply_table_batched``).  A pk hits only when its cl,
        row presence, and every requested cell — version *and* value —
        are known; anything less is a miss and the caller re-prefetches
        + installs.  A ref cid outside the table's schema poisons the
        whole batch to misses (junk cids are never cached)."""
        cl_by_pk: Dict[bytes, int] = {}
        clock_by_cell: Dict[Tuple[bytes, str], int] = {}
        vals_by_pk: Dict[bytes, dict] = {}
        with self._lock:
            tc = self._table(info)
            refs = [c for c in ref_cids]
            if any(c not in tc.cid_ord for c in refs):
                self.counters["misses"] += len(pks)
                return list(pks), cl_by_pk, clock_by_cell, vals_by_pk
            sh = self._shadow.get(info.name)
            if sh is None or (
                not sh.rows and not sh.cells and not sh.staged
            ):
                # steady state: no staged overlay for this table (the
                # common case — the shadow clears at every commit), so
                # the whole batch resolves against the main arrays in
                # a handful of vectorized ops
                return self._lookup_fast(tc, pks, refs)
            self._materialize(sh)
            miss: List[bytes] = []
            # phase 1: shadow + slot resolution; collect main-cache
            # row/cell queries for one vectorized probe each
            row_q_pks: List[bytes] = []
            row_q_slots: List[int] = []
            cell_q: List[Tuple[bytes, str, int]] = []  # (pk, cid, key)
            # per-pk assembly notes: list of (pk, shadow_row|None)
            plan: List[Tuple[bytes, Optional[list], list]] = []
            for pk in pks:
                srow = sh.rows.get(pk) if sh is not None else None
                scells = sh.cells.get(pk, {}) if sh is not None else {}
                slot = tc.pk_slot.get(pk)
                known = slot is not None and bool(tc.row_known[slot])
                need_main = []
                if srow is not None:
                    full = srow[2]
                    bad = False
                    for c in refs:
                        e = scells.get(c)
                        if e is None:
                            if not full:
                                need_main.append(c)
                        elif e[0] is VAL_UNKNOWN:
                            bad = True
                            break
                    if bad or (
                        (srow[1] is None or need_main) and not known
                    ):
                        miss.append(pk)
                        continue
                else:
                    if not known:
                        miss.append(pk)
                        continue
                    need_main = refs
                if srow is None or srow[1] is None or need_main:
                    row_q_pks.append(pk)
                    row_q_slots.append(slot)  # type: ignore[arg-type]
                for c in need_main:
                    cell_q.append((pk, c, tc._key(slot, c)))  # type: ignore[arg-type]
                plan.append((pk, srow, need_main))
            # phase 2: one probe + gathers against the main arrays
            row_cl_h: Dict[bytes, int] = {}
            row_pr_h: Dict[bytes, bool] = {}
            if row_q_slots:
                slots_arr = np.asarray(row_q_slots, dtype=np.int64)
                cls = tc.store.gather(tc.row_cl, slots_arr)
                prs = tc.row_present[slots_arr]
                for i, pk in enumerate(row_q_pks):
                    row_cl_h[pk] = int(cls[i])
                    row_pr_h[pk] = bool(prs[i])
            cell_h: Dict[Tuple[bytes, str], Tuple[int, object]] = {}
            bad_pks: set = set()
            if cell_q:
                keys = np.asarray([k for _, _, k in cell_q], np.int64)
                pos = tc.cell_find(keys)
                found = pos >= 0
                vers = tc.store.gather(
                    tc.cell_ver, pos[found]
                ) if found.any() else np.zeros(0, np.int64)
                vi = 0
                for j, (pk, c, _k) in enumerate(cell_q):
                    if found[j]:
                        p = int(pos[j])
                        val = tc.cell_val[p]
                        if val is VAL_UNKNOWN:
                            bad_pks.add(pk)
                        else:
                            cell_h[(pk, c)] = (int(vers[vi]), val)
                        vi += 1
                    else:
                        # row fully known: absent from index == no
                        # clock row for this cell
                        cell_h[(pk, c)] = (ABSENT, None)
            # phase 3: assemble outputs; demote val-unknown pks to miss
            hits = 0
            for pk, srow, need_main in plan:
                if pk in bad_pks:
                    miss.append(pk)
                    continue
                if srow is not None:
                    cl = srow[0]
                    present = srow[1]
                    if present is None:
                        present = row_pr_h[pk]
                else:
                    cl = row_cl_h[pk]
                    cl = None if cl == ABSENT else cl
                    present = row_pr_h[pk]
                if cl is not None:
                    cl_by_pk[pk] = cl
                row_vals: dict = {}
                sh_cells = (
                    self._shadow[info.name].cells.get(pk, {})
                    if srow is not None else {}
                )
                for c in refs:
                    if c in need_main:
                        ver, val = cell_h[(pk, c)]
                        if ver == ABSENT:
                            continue
                    else:
                        e = sh_cells.get(c)
                        if e is None:
                            continue  # full shadow: known absent
                        val, ver = e[0], e[1]
                    clock_by_cell[(pk, c)] = ver
                    row_vals[c] = val
                if present:
                    vals_by_pk[pk] = row_vals
                hits += 1
            self.counters["hits"] += hits
            self.counters["misses"] += len(miss)
            return miss, cl_by_pk, clock_by_cell, vals_by_pk

    def _lookup_fast(self, tc: _TableCache, pks: List[bytes],
                     refs: List[str]) -> Tuple[
        List[bytes], Dict[bytes, int], Dict[Tuple[bytes, str], int],
        Dict[bytes, dict],
    ]:
        """Shadow-free lookup: slot map, one row gather, one cell probe
        + gather, then a single assembly pass.  Semantically identical
        to the general path with an empty shadow (caller holds the
        lock and has validated ``refs`` against the schema)."""
        get = tc.pk_slot.get
        slots_arr = np.fromiter(
            (get(pk, -1) for pk in pks), np.int64, len(pks)
        )
        known = (slots_arr >= 0)
        if known.any():
            known &= tc.row_known[np.maximum(slots_arr, 0)]
        known_l = known.tolist()
        miss = [pk for pk, k in zip(pks, known_l) if not k]
        cl_by_pk: Dict[bytes, int] = {}
        clock_by_cell: Dict[Tuple[bytes, str], int] = {}
        vals_by_pk: Dict[bytes, dict] = {}
        if len(miss) == len(pks):
            self.counters["misses"] += len(miss)
            return miss, cl_by_pk, clock_by_cell, vals_by_pk
        hit_pks = [pk for pk, k in zip(pks, known_l) if k]
        hit_slots = slots_arr[known]
        cls_l = tc.store.gather(tc.row_cl, hit_slots).tolist()
        prs_l = tc.row_present[hit_slots].tolist()
        cl_by_pk.update(
            (pk, c) for pk, c in zip(hit_pks, cls_l) if c != ABSENT
        )
        bad: set = set()
        if refs:
            ords = np.fromiter(
                (tc.cid_ord[c] + 1 for c in refs), np.int64, len(refs)
            )
            keys = (
                hit_slots[:, None] * np.int64(tc.n_cid) + ords[None, :]
            ).ravel()
            pos = tc.cell_find(keys)
            found = pos >= 0
            vers = np.full(len(keys), ABSENT, dtype=np.int64)
            if found.any():
                vers[found] = tc.store.gather(tc.cell_ver, pos[found])
            pos_l = pos.tolist()
            vers_l = vers.tolist()
            cell_val = tc.cell_val
            k = 0
            for j, pk in enumerate(hit_pks):
                row_vals: dict = {}
                for c in refs:
                    p = pos_l[k]
                    if p >= 0:
                        val = cell_val[p]
                        if val is VAL_UNKNOWN:
                            bad.add(pk)
                        else:
                            clock_by_cell[(pk, c)] = vers_l[k]
                            row_vals[c] = val
                    k += 1
                if prs_l[j]:
                    vals_by_pk[pk] = row_vals
        else:
            vals_by_pk.update(
                (pk, {}) for pk, pr in zip(hit_pks, prs_l) if pr
            )
        if bad:
            # a requested value is cached version-only (non-selected
            # column at install time): demote those pks to misses
            for pk in bad:
                miss.append(pk)
                cl_by_pk.pop(pk, None)
                vals_by_pk.pop(pk, None)
                for c in refs:
                    clock_by_cell.pop((pk, c), None)
        self.counters["hits"] += len(hit_pks) - len(bad)
        self.counters["misses"] += len(miss)
        return miss, cl_by_pk, clock_by_cell, vals_by_pk

    def lookup_seed(self, info, pks: List[bytes], ref_cids) -> Optional[
        Tuple[List[bytes], Dict[bytes, int], tuple, set]
    ]:
        """Hot-path lookup returning the seed view in the columnar
        encoder's NATIVE form — parallel ``(pks, cids, col_versions,
        values)`` sequences plus a row-presence set — skipping the
        per-cell dict assembly :meth:`lookup` pays.  Returns ``None``
        when the table carries a live transaction overlay (same-tx
        restage: the caller must take the dict route), and the same
        miss/demotion decisions as :meth:`lookup` otherwise."""
        with self._lock:
            tc = self._table(info)
            refs = [c for c in ref_cids]
            if any(c not in tc.cid_ord for c in refs):
                self.counters["misses"] += len(pks)
                return list(pks), {}, ([], [], [], []), set()
            sh = self._shadow.get(info.name)
            if sh is not None and (sh.rows or sh.cells or sh.staged):
                return None
            n = len(pks)
            get = tc.pk_slot.get
            slots_arr = np.fromiter(
                (get(pk, -1) for pk in pks), np.int64, n
            )
            known = (slots_arr >= 0)
            if known.any():
                known &= tc.row_known[np.maximum(slots_arr, 0)]
            known_l = known.tolist()
            miss = [pk for pk, k in zip(pks, known_l) if not k]
            cl_by_pk: Dict[bytes, int] = {}
            s_pks: list = []
            s_cids: list = []
            s_vers: list = []
            s_vals: list = []
            present: set = set()
            if len(miss) == n:
                self.counters["misses"] += len(miss)
                return miss, cl_by_pk, (
                    s_pks, s_cids, s_vers, s_vals,
                ), present
            hit_pks = [pk for pk, k in zip(pks, known_l) if k]
            hit_slots = slots_arr[known]
            cls_l = tc.store.gather(tc.row_cl, hit_slots).tolist()
            prs_l = tc.row_present[hit_slots].tolist()
            cl_by_pk.update(
                (pk, c) for pk, c in zip(hit_pks, cls_l) if c != ABSENT
            )
            bad: set = set()
            if refs:
                ords = np.fromiter(
                    (tc.cid_ord[c] + 1 for c in refs), np.int64,
                    len(refs),
                )
                keys = (
                    hit_slots[:, None] * np.int64(tc.n_cid)
                    + ords[None, :]
                ).ravel()
                pos = tc.cell_find(keys)
                found = pos >= 0
                vers = np.full(len(keys), ABSENT, dtype=np.int64)
                if found.any():
                    vers[found] = tc.store.gather(
                        tc.cell_ver, pos[found]
                    )
                pos_l = pos.tolist()
                vers_l = vers.tolist()
                cell_val = tc.cell_val
                if found.all() and all(prs_l):
                    # bulk path for the steady-state shape (every cell
                    # cached, every row present): C-level repeats and
                    # one gather comprehension instead of the per-cell
                    # conditional loop
                    vals = [cell_val[p] for p in pos_l]
                    if not any(v is VAL_UNKNOWN for v in vals):
                        s_pks = [pk for pk in hit_pks for _ in refs]
                        s_cids = refs * len(hit_pks)
                        s_vers = vers_l
                        s_vals = vals
                        present = set(hit_pks)
                        self.counters["hits"] += len(hit_pks)
                        self.counters["misses"] += len(miss)
                        return miss, cl_by_pk, (
                            s_pks, s_cids, s_vers, s_vals,
                        ), present
                k = 0
                for j, pk in enumerate(hit_pks):
                    pr = prs_l[j]
                    if pr:
                        present.add(pk)
                    for c in refs:
                        p = pos_l[k]
                        if p >= 0:
                            val = cell_val[p]
                            if val is VAL_UNKNOWN:
                                bad.add(pk)
                            else:
                                s_pks.append(pk)
                                s_cids.append(c)
                                s_vers.append(vers_l[k])
                                # a non-present row's values never
                                # reach the merge (lookup() binds vals
                                # only for present rows)
                                s_vals.append(val if pr else None)
                        k += 1
            else:
                present.update(
                    pk for pk, pr in zip(hit_pks, prs_l) if pr
                )
            if bad:
                for pk in bad:
                    miss.append(pk)
                    cl_by_pk.pop(pk, None)
                    present.discard(pk)
                keep = [
                    i for i, pk in enumerate(s_pks) if pk not in bad
                ]
                if len(keep) != len(s_pks):
                    s_pks = [s_pks[i] for i in keep]
                    s_cids = [s_cids[i] for i in keep]
                    s_vers = [s_vers[i] for i in keep]
                    s_vals = [s_vals[i] for i in keep]
            self.counters["hits"] += len(hit_pks) - len(bad)
            self.counters["misses"] += len(miss)
            return miss, cl_by_pk, (
                s_pks, s_cids, s_vers, s_vals,
            ), present

    # -- write side (shadow only; promoted at commit) -----------------

    def install(self, info, miss_pks: List[bytes],
                cl_by_pk: Dict[bytes, int],
                clock_by_cell: Dict[Tuple[bytes, str], int],
                vals_by_pk: Dict[bytes, dict], ref_cids) -> None:
        """Seed the shadow from a SQLite prefetch of ``miss_pks``.  The
        clock prefetch covers every cid of those pks, so the installed
        rows are *full*; values outside the selected columns are
        :data:`VAL_UNKNOWN` (a later request for them re-misses)."""
        with self._lock:
            tc = self._table(info)
            sel = {c for c in info.data_cols if c in ref_cids}
            sh = self._shadow_for(info.name)
            self._materialize(sh)
            by_pk: Dict[bytes, Dict[str, tuple]] = {}
            for (pk, cid), ver in clock_by_cell.items():
                if cid not in tc.cid_ord:
                    continue  # junk cid in the DB: never cached
                if cid in sel:
                    val = vals_by_pk.get(pk, {}).get(cid)
                else:
                    val = VAL_UNKNOWN
                by_pk.setdefault(pk, {})[cid] = (val, ver)
            for pk in miss_pks:
                sh.rows[pk] = [
                    cl_by_pk.get(pk), pk in vals_by_pk, True,
                ]
                sh.cells[pk] = by_pk.get(pk, {})
            sh.columnar = None

    def stage_states(self, info, states: Dict[bytes, list],
                     cl_by_pk: Dict[bytes, int],
                     vals_by_pk: Dict[bytes, dict],
                     columnar: Optional[tuple] = None) -> None:
        """Overlay the post-flush net state of a merged batch (the
        ``states`` structure ``storage._flush_table_states`` consumes)
        onto the shadow.  ``cl_by_pk`` / ``vals_by_pk`` are the *seed
        views the merge ran against* (cache hits + prefetch overlay) —
        they resolve carried-over cl and row presence.  ``columnar``
        is the merge kernel's ``(plan, decision)`` when it ran — kept
        on the shadow for the vectorized commit promote when this
        stays the only overlay of the transaction.

        Staging is LAZY: the batch is queued on the shadow and only
        folded into the overlay dicts when something actually reads
        them (a same-tx lookup, install or invalidation, or the dict
        promote) — the steady-state commit promotes straight from the
        columnar arrays and never materializes."""
        with self._lock:
            sh = self._shadow_for(info.name)
            fresh = not sh.rows and not sh.cells and not sh.staged
            sh.staged.append((info, states, cl_by_pk, vals_by_pk))
            if (
                fresh and columnar is not None
                and not bool(columnar[1].gen.any())
            ):
                sh.columnar = (
                    columnar[0], columnar[1], cl_by_pk, vals_by_pk,
                )
            else:
                sh.columnar = None

    def _materialize(self, sh: _TableShadow) -> None:
        """Fold queued stage batches into the overlay dicts, in stage
        order.  Caller holds the lock."""
        if not sh.staged:
            return
        staged, sh.staged = sh.staged, []
        for info, states, cl_by_pk, vals_by_pk in staged:
            self._stage_into(sh, info, states, cl_by_pk, vals_by_pk)

    def _stage_into(self, sh: _TableShadow, info,
                    states: Dict[bytes, list],
                    cl_by_pk: Dict[bytes, int], vals_by_pk) -> None:
        CL, CLROW, GEN, ALIVE, ENSURE, CELLS = range(6)
        for pk, st in states.items():
            clrow = st[CLROW]
            if clrow is not None:
                cl = clrow[1]
            elif st[CL] is not None:
                cl = st[CL]
            else:
                cl = cl_by_pk.get(pk)  # None == no cl row
            # shadow cells share the merge cell layout, so the net
            # state's dict is borrowed as-is (never mutated here)
            cells = st[CELLS]
            if st[GEN]:
                # generation: row + every clock row replaced
                present = bool(st[ALIVE]) and bool(info.data_cols)
                sh.rows[pk] = [cl, present, True]
                sh.cells[pk] = cells
                continue
            prev = sh.rows.get(pk)
            if prev is not None:
                prev[0] = cl
                if st[ENSURE] and info.data_cols:
                    prev[1] = True
                prev_cells = sh.cells.get(pk)
                if prev_cells:
                    # fresh dict: the borrowed net-state dict is
                    # also queued for the write-behind flush
                    sh.cells[pk] = {**prev_cells, **cells}
                else:
                    sh.cells[pk] = cells
            else:
                # pk was a main-cache hit: partial overlay; row
                # presence inherits unless this batch ensured it
                present: Optional[bool]
                if pk in vals_by_pk or st[ENSURE]:
                    present = bool(info.data_cols)
                else:
                    present = None
                sh.rows[pk] = [cl, present, False]
                sh.cells[pk] = cells

    # -- transaction boundary -----------------------------------------

    def abort_tx(self) -> None:
        with self._lock:
            self._shadow = {}

    def commit_tx(self) -> None:
        """Promote the shadow into the main arrays: retire + reallocate
        slots for full rows, update cells in place for partial ones.
        Capacity pressure clears the table (evictions) and retries the
        promote once against the fresh arrays."""
        with self._lock:
            shadow, self._shadow = self._shadow, {}
            for name, sh in shadow.items():
                tc = self._tables.get(name)
                if tc is None:
                    continue
                self._promote_table(tc, sh)

    def _promote_table(self, tc: _TableCache, sh: _TableShadow) -> None:
        if sh.columnar is not None and self._promote_columnar(tc, sh):
            return
        self._materialize(sh)
        for attempt in (0, 1):
            n_rows = len(sh.rows)
            n_cells = sum(len(c) for c in sh.cells.values())
            if not tc.room_for_rows(n_rows) or \
                    not tc.room_for_cells(n_cells):
                if attempt:
                    return  # shadow alone exceeds capacity: skip cache
                self._evict_table(tc)
                continue
            break
        tc.ensure_row_capacity(len(sh.rows))
        tc.ensure_cell_capacity(
            sum(len(c) for c in sh.cells.values())
        )
        row_slots: List[int] = []
        row_cls: List[int] = []
        pres_slots: List[int] = []
        pres_vals: List[bool] = []
        known_slots: List[int] = []
        cell_entries: List[Tuple[int, int, object]] = []
        pk_slot_get = tc.pk_slot.get
        row_known = tc.row_known
        cid_ord = tc.cid_ord
        n_cid = tc.n_cid
        sh_cells_get = sh.cells.get
        for pk, (cl, present, full) in sh.rows.items():
            slot = pk_slot_get(pk)
            if full:
                # full knowledge replaces the row wholesale: a fresh
                # slot orphans any stale cells keyed to the old one
                if slot is not None:
                    tc.retire(pk)
                if not tc.room_for_rows(1):
                    return  # capacity raced the retire loop: give up
                slot = tc.alloc_slot(pk)
                pres_slots.append(slot)
                pres_vals.append(bool(present))
                known_slots.append(slot)
            else:
                if slot is None or not row_known[slot]:
                    continue  # partial overlay with no base: uncacheable
                if present is not None:
                    pres_slots.append(slot)
                    pres_vals.append(bool(present))
            row_slots.append(slot)
            row_cls.append(ABSENT if cl is None else int(cl))
            cells = sh_cells_get(pk)
            if cells:
                base = slot * n_cid + 1
                for cid, cell in cells.items():
                    o = cid_ord.get(cid)
                    if o is not None:
                        cell_entries.append(
                            (base + o, int(cell[1]), cell[0])
                        )
        # scalar boolean writes batched into two fancy-index stores
        if known_slots:
            tc.row_known[np.asarray(known_slots, dtype=np.int64)] = True
        if pres_slots:
            tc.row_present[np.asarray(pres_slots, dtype=np.int64)] = \
                np.asarray(pres_vals, dtype=bool)
        if row_slots:
            tc.row_cl = tc.store.set(
                tc.row_cl,
                np.asarray(row_slots, dtype=np.int64),
                np.asarray(row_cls, dtype=np.int64),
            )
        tc.cell_put_batch(cell_entries)

    def _promote_columnar(self, tc: _TableCache,
                          sh: _TableShadow) -> bool:
        """Steady-state promote: scatter the merge kernel's winner
        arrays straight into the device arrays.  Valid only for the
        shape ``stage_states`` vetted — one no-generation batch whose
        every pk was a main-cache hit — so every row is a partial
        in-place update of a known slot.  Returns False (no mutation
        done) to hand anything else to the dict promote."""
        plan, dec, cl_by_pk, vals_by_pk = sh.columnar  # type: ignore
        pk_values = plan.pk_values
        n = len(pk_values)
        if n == 0:
            return True
        get = tc.pk_slot.get
        slots = np.fromiter(
            (get(pk, -1) for pk in pk_values), np.int64, n
        )
        if (slots < 0).any() or not tc.row_known[slots].all():
            return False  # a pk missed the cache after all
        cids = plan.cid_values
        ord_map = np.fromiter(
            (tc.cid_ord.get(c, -1) for c in cids), np.int64, len(cids)
        )
        if (ord_map < 0).any():
            return False  # cid outside the cached ordinal space
        # n_cid pads to >= 1; phantom pad columns never hold winners,
        # so restrict the scatter to the real cid columns
        win = np.asarray(dec.winner_idx).reshape(
            n, plan.n_cid
        )[:, :len(cids)]
        wmask = win >= 0
        keys = (
            slots[:, None] * tc.n_cid + ord_map[None, :] + 1
        )[wmask]
        widx = win[wmask]
        pos = tc.cell_find(keys)
        n_new = int((pos < 0).sum())
        if n_new:
            if not tc.room_for_cells(n_new):
                return False  # capacity pressure: dict path evicts
            tc.ensure_cell_capacity(n_new)
            pos = tc.cell_find(keys)  # capacity growth rehashes
            mask = tc.cap_cells - 1
            keys_arr = tc.cell_keys
            for j in np.nonzero(pos < 0)[0].tolist():
                key = int(keys[j])
                i = tc._hash_scalar(key)
                while True:
                    k = int(keys_arr[i])
                    if k == key:
                        break
                    if k == 0:
                        keys_arr[i] = key
                        tc.cells_used += 1
                        break
                    i = (i + 1) & mask
                pos[j] = i
        if len(pos):
            tc.cell_ver = tc.store.set(
                tc.cell_ver, pos,
                np.asarray(plan.vers, dtype=np.int64)[widx],
            )
            vals = plan.vals
            cell_val = tc.cell_val
            for p, w in zip(pos.tolist(), widx.tolist()):
                cell_val[p] = vals[w]
        # rows: cl carries over as ABSENT unless the seed view had one
        # (mirrors stage_states' cl fallback for no-generation rows)
        has_cl = np.fromiter(
            (pk in cl_by_pk for pk in pk_values), bool, n
        )
        tc.row_cl = tc.store.set(
            tc.row_cl, slots,
            np.where(has_cl, np.asarray(dec.final_cl), ABSENT),
        )
        pres = np.asarray(dec.ensure, dtype=bool) | np.fromiter(
            (pk in vals_by_pk for pk in pk_values), bool, n
        )
        if pres.any():
            tc.row_present[slots[pres]] = True
        return True

    # -- invalidation -------------------------------------------------

    def _count_invalidation(self, reason: str, n: int) -> None:
        if n:
            self.invalidations[reason] = \
                self.invalidations.get(reason, 0.0) + n

    def invalidate_pks(self, table: str, pks, reason: str = "local_write") -> None:
        """Forget specific rows (small-path applies, targeted local
        writes).  Always safe: forgetting only forces a re-prefetch."""
        with self._lock:
            n = 0
            tc = self._tables.get(table)
            sh = self._shadow.get(table)
            if sh is not None:
                self._materialize(sh)
            for pk in pks:
                if tc is not None and tc.retire(pk):
                    n += 1
                if sh is not None:
                    if sh.rows.pop(pk, None) is not None:
                        n += 1
                    sh.cells.pop(pk, None)
            if sh is not None:
                sh.columnar = None
            self._count_invalidation(reason, n)

    def invalidate_table(self, table: str, reason: str = "schema") -> None:
        """Drop one table's cache wholesale (schema migration via
        ``as_crr`` changes the cid ordinal space)."""
        with self._lock:
            tc = self._tables.pop(table, None)
            sh = self._shadow.pop(table, None)
            n = tc.live_entries() if tc is not None else 0
            if sh is not None:
                self._materialize(sh)
                n += len(sh.rows)
            self._count_invalidation(reason, n)

    def invalidate_all(self, reason: str) -> None:
        """Snapshot install / compaction floor / local write commit:
        anything that rewrites CRR state outside the staged apply path.
        Caller holds the storage write lock (ordering contract)."""
        with self._lock:
            for sh in self._shadow.values():
                self._materialize(sh)
            n = sum(len(sh.rows) for sh in self._shadow.values())
            for tc in self._tables.values():
                n += tc.live_entries()
            self._tables = {}
            self._shadow = {}
            self._count_invalidation(reason, n)
