"""CRDT merge of packed keys (port of ``corrosion_tpu/ops/merge.py``).

Part A, the merge the simulator runs: the merge of two replicas' cell
states is an elementwise ``max`` over packed keys (``ops/keys.py``);
message delivery into a replica array is a scatter-max.

Part B, the columnar batched apply (docs/crdts.md "Columnar merge
kernel"): a batch of changes encodes to flat arrays (interned pk/cid
ordinals, causal lengths, packed ``(cl, col_version, value_rank)`` LWW
keys) and ``select_winners`` resolves causal-length / LWW winners with
two stable sorts, segmented prefix-max scans and scatter reductions.
Two backends give bit-identical integer results: the NumPy twin
(``backend="numpy"``, the reference's ``_winners_np``) and
``_winners_torch_core`` (``backend="torch"``), which runs the
``seg_argsort``, ``seg_cummax``, ``winners_a`` and ``winners_b``
kernels on a card and their plain versions on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.kernels import seg_sort, winners
from corrosion_tpu_torch.kernels.winners import BIG as _BIG
from corrosion_tpu_torch.kernels.winners import NEG_KEY


def merge_keys(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two equally-shaped packed-key tensors (commutative,
    idempotent, associative — the CRDT join)."""
    return torch.maximum(a, b)


def merge_cells(states: torch.Tensor) -> torch.Tensor:
    """Merge replica states along the leading axis: [R, ...] -> [...]."""
    return torch.amax(states, dim=0)


def scatter_merge(state: torch.Tensor, targets: torch.Tensor,
                  msg_keys: torch.Tensor) -> torch.Tensor:
    """Deliver messages into a replica-indexed state via scatter-max.

    state:    [N, ...cells] packed keys, one row per replica.
    targets:  [M] int replica indices (may repeat; duplicates merge).
    msg_keys: [M, ...cells] packed keys carried by each message.

    Returns the updated state (``state`` is left as it was).  Targets
    outside [-N, N) are dropped, as the reference's ``mode="drop"``
    does, and negative ones count from the end: every dropped message
    lands on one pad row past the end that is sliced off again."""
    n = state.shape[0]
    t = targets.to(torch.int64)
    t = torch.where(t < 0, t + n, t)
    t = torch.where((t >= 0) & (t < n), t, n)
    pad = state.new_empty((1,) + tuple(state.shape[1:]))
    padded = torch.cat([state, pad])
    msg_keys = msg_keys.to(state.dtype)
    index = t.reshape((-1,) + (1,) * (msg_keys.dim() - 1)).expand_as(msg_keys)
    padded.scatter_reduce_(0, index, msg_keys, "amax", include_self=True)
    return padded[:n]


# ---------------------------------------------------------------------------
# Columnar batched-apply winner selection
# ---------------------------------------------------------------------------

#: dense per-(pk, cid) seed matrices beyond this many cells fall back to
#: the dict oracle rather than allocating a hostile-batch-shaped array
MAX_SEED_CELLS = 4_000_000


@dataclass(frozen=True)
class MergePlan:
    """One table batch, encoded to flat arrays in stream order.

    ``pk``/``cid`` are first-appearance-interned ordinals (cid ``-1`` =
    row-level sentinel change); ``key`` packs ``(cl, col_version,
    value_rank)`` so that int64 order == the merge rule's lexicographic
    order (``NEG_KEY`` on sentinels).  ``seed_cl``/``seed_key`` carry the
    database's pre-batch view: the row causal length per pk (``-1`` = no
    row entry) and the packed clock/value per (pk, cid) cell (``NEG_KEY``
    = no clock row).
    """

    n: int
    n_pk: int
    n_cid: int
    pk: np.ndarray
    cid: np.ndarray
    sent: np.ndarray
    cl: np.ndarray
    key: np.ndarray
    seed_cl: np.ndarray
    seed_key: np.ndarray  # flat [n_pk * n_cid]
    pk_values: List
    cid_values: List
    # the extracted per-change value / col_version columns, stream
    # order — decoders index these instead of re-walking the changes
    vals: Tuple = ()
    vers: Tuple = ()


@dataclass(frozen=True)
class MergeDecision:
    """``select_winners`` output, mirroring the dict loop's per-pk state.

    Per pk ordinal: ``final_cl`` (max causal length incl. the seed),
    ``gen`` (the row generation changed), ``alive`` (final cl odd),
    ``ensure`` (an equal-generation live cell change touched the row),
    ``sent_flag`` (some generation raise was a sentinel change) and
    ``clrow_idx`` (stream index of the change whose ``(db_version, seq,
    site)`` stamp the row-CL record takes; ``-1`` = no raise).  Per
    (pk, cid) cell: ``winner_idx`` — stream index of the surviving LWW
    winner (``-1`` = none: beaten by the DB view, or wiped by a later
    generation).  ``impacted`` counts accept events exactly like the
    sequential replay (rows-impacted parity).
    """

    final_cl: np.ndarray
    gen: np.ndarray
    alive: np.ndarray
    ensure: np.ndarray
    sent_flag: np.ndarray
    clrow_idx: np.ndarray
    winner_idx: np.ndarray  # flat [n_pk * n_cid]
    impacted: int


_TYPE_BUCKET = {type(None): 0, bytes: 1, str: 2, float: 3, int: 4,
                bool: 4}


def value_ranks(values: Sequence) -> np.ndarray:
    """Dense ranks (position -> rank) under the cr-sqlite value order
    (the agent's ``pack.value_cmp``): type-enum bucket
    first -- ``NULL < BLOB < TEXT < REAL < INTEGER`` -- then the
    in-type order (str order == UTF-8 byte order; bool binds as
    INTEGER).  Equal-comparing values share a rank, bigger values get
    bigger ranks.  Bucketed so each type sorts with native C compares;
    no per-value comparator calls.  Raises TypeError on unsupported
    types, ValueError on NaN (value_cmp "ties" NaN against everything,
    which is not a total order) -- callers fall back to the per-change
    oracle."""
    n = len(values)
    ranks = np.zeros(n, np.int64)
    if not n:
        return ranks
    buckets = list(map(_TYPE_BUCKET.get, map(type, values)))
    if None in buckets:
        # exotic types: normalize bytes-likes / int subclasses, reject
        # the rest (rare path -- wire decode produces exact types)
        values = list(values)
        for i, v in enumerate(values):
            if buckets[i] is not None:
                continue
            if isinstance(v, (bytearray, memoryview)):
                values[i] = bytes(v)
                buckets[i] = 1
            elif isinstance(v, bool):
                values[i] = bool(v)
                buckets[i] = 4
            elif isinstance(v, int):
                values[i] = int(v)
                buckets[i] = 4
            elif isinstance(v, float):
                values[i] = float(v)
                buckets[i] = 3
            elif isinstance(v, str):
                values[i] = str(v)
                buckets[i] = 2
            else:
                raise TypeError(f"unsupported SQL value: {type(v)!r}")
    b0 = buckets[0]
    if b0 is not None and b0 != 0 and buckets.count(b0) == n:
        # homogeneous batch (the common wire shape): no bucket gather
        if b0 == 3 and any(v != v for v in values):
            raise ValueError("NaN value")
        rank_of = {v: r for r, v in enumerate(sorted(set(values)))}
        return np.fromiter(
            map(rank_of.__getitem__, values), np.int64, count=n
        )
    barr = np.fromiter(buckets, np.int8, count=n)
    offset = 0
    for b in range(5):
        ix = np.flatnonzero(barr == b)
        if not len(ix):
            continue
        if b == 0:  # every NULL is one rank
            offset += 1
            continue
        vals = [values[i] for i in ix.tolist()]
        if b == 3 and any(v != v for v in vals):
            raise ValueError("NaN value")
        distinct = sorted(set(vals))
        rank_of = {v: r for r, v in enumerate(distinct)}
        ranks[ix] = np.fromiter(
            map(rank_of.__getitem__, vals), np.int64, count=len(vals)
        )
        ranks[ix] += offset
        offset += len(distinct)
    return ranks


def encode_changes(
    records: Sequence[Tuple],
    seed_cls: Optional[Dict] = None,
    seed_cells: Optional[Dict] = None,
) -> Optional[MergePlan]:
    """Encode one table batch for :func:`select_winners`.

    ``records``: stream-ordered ``(pk, cid_or_None, cl, col_version,
    value)`` tuples (cid ``None`` = row-level sentinel).  ``seed_cls``:
    pk -> pre-batch row causal length.  ``seed_cells``: (pk, cid) ->
    ``(col_version, current_value)`` pre-batch clock view.

    Returns ``None`` when the batch cannot be packed into 62-bit keys
    (hostile out-of-range fields) or the dense seed matrix would be
    unreasonably large -- callers fall back to the per-change oracle.
    """
    if not records:
        return None
    pk_raw, cid_raw, cl_raw, ver_raw, val_raw = zip(*records)
    seed_cols = None
    if seed_cells:
        s_pk, s_cid = zip(*seed_cells)
        s_ver, s_val = zip(*seed_cells.values())
        seed_cols = (s_pk, s_cid, s_ver, s_val)
    return _encode_cols(
        len(records), pk_raw, cid_raw, cl_raw, ver_raw, val_raw,
        None, seed_cls or {}, seed_cols,
    )


def encode_change_batch(
    changes: Sequence,
    sentinel_cid,
    seed_cls: Optional[Dict] = None,
    seed_cell_cols: Optional[Tuple] = None,
) -> Optional[MergePlan]:
    """:func:`encode_changes` straight off ``Change`` objects -- column
    extraction via C-level ``attrgetter`` maps, no per-change tuple
    build.  ``sentinel_cid`` is the row-level sentinel marker
    (``types.change.SENTINEL_CID``); ``seed_cell_cols`` carries the
    DB clock view as parallel ``(pks, cids, col_versions, values)``
    sequences."""
    import operator

    if not changes:
        return None
    return _encode_cols(
        len(changes),
        tuple(map(operator.attrgetter("pk"), changes)),
        tuple(map(operator.attrgetter("cid"), changes)),
        tuple(map(operator.attrgetter("cl"), changes)),
        tuple(map(operator.attrgetter("col_version"), changes)),
        tuple(map(operator.attrgetter("val"), changes)),
        sentinel_cid, seed_cls or {}, seed_cell_cols,
    )


def _encode_cols(
    n: int, pk_raw, cid_raw, cl_raw, ver_raw, val_raw,
    sentinel, seed_cls: Dict, seed_cell_cols: Optional[Tuple],
) -> Optional[MergePlan]:
    from itertools import repeat

    # version/causal-length fields must be real ints (the dict oracle
    # compares whatever arrives; the kernel only handles the conforming
    # stream and falls back otherwise) -- C-level isinstance map
    if not all(map(isinstance, cl_raw, repeat(int))):
        return None
    if not all(map(isinstance, ver_raw, repeat(int))):
        return None

    pk_ord: Dict = {}
    for pk in pk_raw:
        if pk not in pk_ord:
            pk_ord[pk] = len(pk_ord)
    cid_ord: Dict = {sentinel: -1}
    for c in cid_raw:
        if c not in cid_ord:
            cid_ord[c] = len(cid_ord) - 1
    try:
        pk_col = np.fromiter(
            map(pk_ord.__getitem__, pk_raw), np.int64, count=n)
        cid_col = np.fromiter(
            map(cid_ord.__getitem__, cid_raw), np.int64, count=n)
        cl_col = np.fromiter(cl_raw, np.int64, count=n)
        ver_col = np.fromiter(ver_raw, np.int64, count=n)
    except OverflowError:  # hostile out-of-int64 fields
        return None
    del cid_ord[sentinel]
    if int(cl_col.min()) < 0 or int(ver_col.min()) < 0:
        return None
    n_pk, n_cid = len(pk_ord), max(1, len(cid_ord))
    if n_pk * n_cid > MAX_SEED_CELLS:
        return None

    # the row-CL seeds first: per-pk pre-batch causal length (-1 = no
    # row entry), needed below to filter which clock seeds participate
    for v in seed_cls.values():
        if not isinstance(v, int) or not 0 <= v <= _BIG:
            return None
    seed_cl = np.full(n_pk, -1, np.int64)
    if seed_cls:
        for pk, cl in seed_cls.items():
            o = pk_ord.get(pk)
            if o is not None:
                seed_cl[o] = cl

    # pool the DB-view cell values with the batch values so one ranking
    # covers every comparison the LWW tie-break can make.  Seed cells
    # only matter for pks holding a row-CL entry (with no entry the
    # first cell change adopts a fresh generation and the clock view
    # never participates) and for cids the batch references.
    sp = sc = sv = None
    if seed_cell_cols is not None:
        s_pk_raw, s_cid_raw, s_ver_raw, s_val_raw = seed_cell_cols
        if not (all(map(pk_ord.__contains__, s_pk_raw))
                and all(map(cid_ord.__contains__, s_cid_raw))):
            f = ([], [], [], [])
            for pk, cid, sver, sval in zip(
                s_pk_raw, s_cid_raw, s_ver_raw, s_val_raw
            ):
                if pk in pk_ord and cid in cid_ord:
                    f[0].append(pk)
                    f[1].append(cid)
                    f[2].append(sver)
                    f[3].append(sval)
            s_pk_raw, s_cid_raw, s_ver_raw, s_val_raw = f
        m = len(s_pk_raw)
        if m:
            if not all(map(isinstance, s_ver_raw, repeat(int))):
                return None
            try:
                sp = np.fromiter(
                    map(pk_ord.__getitem__, s_pk_raw), np.int64,
                    count=m)
                sc = np.fromiter(
                    map(cid_ord.__getitem__, s_cid_raw), np.int64,
                    count=m)
                sv = np.fromiter(s_ver_raw, np.int64, count=m)
            except OverflowError:
                return None
            if int(sv.min()) < 0:
                return None
            keep = np.flatnonzero(seed_cl[sp] >= 0)
            if len(keep) < m:
                sp, sc, sv = sp[keep], sc[keep], sv[keep]
                s_val_raw = [s_val_raw[i] for i in keep.tolist()]
    # A VALUE is only ever compared on an exact (pk, cid, cl,
    # col_version) tie -- between two batch candidates for the same
    # cell, or a candidate and the cell's DB clock seed.  Everything
    # else is decided by the (cl, ver) bits alone, so only
    # tie-implicated values get ranked (rank 0 otherwise): the common
    # backfill batch skips value ranking entirely, exactly like the
    # dict replay's lazily-called value_cmp.  Tag-hash membership is
    # conservative under collisions (a collision only ranks a value
    # needlessly).
    sent_col = cid_col < 0
    M = np.int64(1_000_003)
    tags = ((pk_col * M + cid_col) * M + cl_col) * M + ver_col
    cells_pos = np.flatnonzero(~sent_col)
    ctags = tags[cells_pos]
    if len(ctags) > 1:
        ss = np.sort(ctags)
        dup_tags = np.unique(ss[1:][ss[1:] == ss[:-1]])
    else:
        dup_tags = np.empty(0, np.int64)
    seed_rank = None
    six = None
    if sp is not None and len(sp):
        seed_tags = ((sp * M + sc) * M + seed_cl[sp]) * M + sv
        seed_tied = np.isin(seed_tags, ctags)
        six = np.flatnonzero(seed_tied)
        tie_tags = np.union1d(dup_tags, seed_tags[six])
        seed_rank = np.zeros(len(sp), np.int64)
    else:
        tie_tags = dup_tags
    rank_col = np.zeros(n, np.int64)
    max_rank = 0
    if len(tie_tags):
        cix = cells_pos[np.isin(ctags, tie_tags)]
        pool = [val_raw[i] for i in cix.tolist()]
        n_cell_pool = len(pool)
        if six is not None and len(six):
            pool.extend(s_val_raw[i] for i in six.tolist())
        try:
            ranks = value_ranks(pool)
        except (TypeError, ValueError):
            return None
        rank_col[cix] = ranks[:n_cell_pool]
        if six is not None and len(six):
            seed_rank[six] = ranks[n_cell_pool:]
        if len(ranks):
            max_rank = int(ranks.max())

    max_cl = int(cl_col.max())
    if seed_cls:
        max_cl = max(max_cl, max(seed_cls.values()))
    max_ver = int(ver_col.max())
    if sv is not None and len(sv):
        max_ver = max(max_ver, int(sv.max()))
    cl_bits = max(1, max_cl.bit_length())
    ver_bits = max(1, max_ver.bit_length())
    val_bits = max(1, max_rank.bit_length())
    if cl_bits + ver_bits + val_bits > 62:
        return None
    cl_shift = ver_bits + val_bits

    key_col = np.where(
        sent_col, NEG_KEY,
        (cl_col << cl_shift) | (ver_col << val_bits) | rank_col,
    )

    seed_key = np.full(n_pk * n_cid, NEG_KEY, np.int64)
    if sp is not None and len(sp):
        seed_key[sp * n_cid + sc] = (
            (seed_cl[sp] << cl_shift) | (sv << val_bits) | seed_rank
        )

    return MergePlan(
        n=n, n_pk=n_pk, n_cid=n_cid,
        pk=pk_col, cid=cid_col, sent=sent_col, cl=cl_col, key=key_col,
        seed_cl=seed_cl, seed_key=seed_key,
        pk_values=list(pk_ord), cid_values=list(cid_ord),
        vals=val_raw, vers=ver_raw,
    )


def _seg_cummax_np(x: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """Segmented inclusive prefix max over contiguous segments
    (Hillis–Steele doubling: O(n log n) vector passes, no Python loop
    over segments)."""
    out = x.copy()
    shift = 1
    n = len(x)
    while shift < n:
        same = seg[shift:] == seg[:-shift]
        np.maximum(
            out[shift:], np.where(same, out[:-shift], NEG_KEY),
            out=out[shift:],
        )
        shift <<= 1
    return out


def _winners_np(plan: MergePlan) -> MergeDecision:
    """The NumPy twin of the winner-selection core.

    Reduction semantics (mirrors the sequential replay exactly):

    1. per pk, a segmented prefix max of causal length (seeded with the
       DB row CL) classifies every change as stale (cl < running max),
       equal-generation (cl == running max) or a generation RAISE
       (cl > running max);
    2. per (pk, cid), live-generation cell changes compete through a
       segmented prefix max over packed ``(cl, col_version,
       value_rank)`` keys seeded with the DB clock view — a strict
       improvement is an accept event (rows-impacted parity), and the
       last accept is the surviving winner;
    3. winners from generations below the pk's final causal length are
       discarded (a later raise wiped them), matching the dict loop's
       cell reset.
    """
    n, n_pk, n_cid = plan.n, plan.n_pk, plan.n_cid
    idx = np.arange(n, dtype=np.int64)
    pk, cid, sent, cl, key = plan.pk, plan.cid, plan.sent, plan.cl, plan.key

    # -- domain A: stream order within each pk ------------------------
    # real batches usually arrive pk-grouped (collect_changes emits
    # (db_version, seq) order, cells of one row adjacent): a sorted
    # input makes the stable sort the identity permutation, so skip it
    if np.all(pk[1:] >= pk[:-1]):
        oA = idx
        pkA, clA, sentA = pk, cl, sent
    else:
        oA = np.argsort(pk, kind="stable")
        pkA, clA, sentA = pk[oA], cl[oA], sent[oA]
    startsA = np.empty(n, bool)
    startsA[0] = True
    startsA[1:] = pkA[1:] != pkA[:-1]
    segA = np.cumsum(startsA) - 1
    cmaxA = _seg_cummax_np(clA, segA)
    prevA = np.empty(n, np.int64)
    prevA[0] = NEG_KEY
    prevA[1:] = cmaxA[:-1]
    seedA = plan.seed_cl[pkA]
    beforeA = np.where(startsA, seedA, np.maximum(seedA, prevA))
    raiseA = clA > beforeA
    oddA = (clA & 1) == 1
    cellA = ~sentA

    final_cl = plan.seed_cl.copy()
    np.maximum.at(final_cl, pk, cl)
    gen = final_cl > plan.seed_cl
    alive = (final_cl & 1) == 1
    sent_flag = np.zeros(n_pk, bool)
    np.logical_or.at(sent_flag, pkA, raiseA & sentA)
    ensure = np.zeros(n_pk, bool)
    np.logical_or.at(ensure, pkA, cellA & oddA & (clA == beforeA))

    # the row-CL stamp comes from the FIRST change attaining the final
    # causal length (the last raise of the sequential replay)
    cand = np.where(cl == final_cl[pk], idx, _BIG)
    clrow = np.full(n_pk, _BIG, np.int64)
    np.minimum.at(clrow, pk, cand)
    clrow_idx = np.where(gen, clrow, -1)

    n_sent_raise = int(np.count_nonzero(raiseA & sentA))
    n_even_raise = int(np.count_nonzero(raiseA & cellA & ~oddA))

    # LWW participants: live-generation cell changes only
    partA = cellA & oddA & (clA >= beforeA)
    part = np.zeros(n, bool)
    part[oA] = partA

    # -- domain B: stream order within each (pk, cid) cell ------------
    compB = pk * (n_cid + 2) + (cid + 1)
    if np.all(compB[1:] >= compB[:-1]):
        oB = idx
        pkB, cidB = pk, cid
        partB = part
        keyB = np.where(partB, key, NEG_KEY)
    else:
        oB = np.lexsort((idx, cid, pk))
        pkB, cidB = pk[oB], cid[oB]
        partB = part[oB]
        keyB = np.where(partB, key[oB], NEG_KEY)
    startsB = np.empty(n, bool)
    startsB[0] = True
    startsB[1:] = (pkB[1:] != pkB[:-1]) | (cidB[1:] != cidB[:-1])
    segB = np.cumsum(startsB) - 1
    cmaxB = _seg_cummax_np(keyB, segB)
    prevB = np.empty(n, np.int64)
    prevB[0] = NEG_KEY
    prevB[1:] = cmaxB[:-1]
    cell_ix = pkB * n_cid + np.maximum(cidB, 0)
    seedB = np.where(cidB >= 0, plan.seed_key[cell_ix], NEG_KEY)
    beforeB = np.where(startsB, seedB, np.maximum(seedB, prevB))
    acceptB = partB & (keyB > beforeB)
    n_accept = int(np.count_nonzero(acceptB))

    winner = np.full(n_pk * n_cid, -1, np.int64)
    np.maximum.at(winner, cell_ix[acceptB], oB[acceptB])
    wcl = np.where(winner >= 0, cl[np.maximum(winner, 0)], -1)
    wpk = np.arange(n_pk * n_cid, dtype=np.int64) // n_cid
    winner = np.where(
        (winner >= 0) & (wcl == final_cl[wpk]), winner, -1
    )

    return MergeDecision(
        final_cl=final_cl, gen=gen, alive=alive, ensure=ensure,
        sent_flag=sent_flag, clrow_idx=clrow_idx, winner_idx=winner,
        impacted=n_sent_raise + n_even_raise + n_accept,
    )




# -- the torch backend ---------------------------------------------------

#: the reference's smallest jitted bucket; ``bucket_pow2`` rounds a size
#: up to the next power of two from here, the shape discipline the
#: device clock cache (ops/devcache.py) shares.  The torch backend takes
#: n at launch and pads nothing.
MIN_BUCKET = 256
#: ``backend="auto"`` sends batches of at least this many changes to the
#: torch backend and smaller ones to the NumPy twin (the reference's
#: ``JAX_AUTO_MIN``)
TORCH_AUTO_MIN = 65536


def bucket_pow2(n: int) -> int:
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def _winners_torch_core(pk, cid, sent, cl, key, seed_cl, seed_key,
                        n_cid: int, plain: bool = False) -> torch.Tensor:
    """The winner selection on tensors of one device: int64 [n] pk /
    cid / cl / key, bool [n] sent, int64 [n_pk] seed_cl and
    [n_pk * n_cid] seed_key.  Returns one int64 buffer, views in order:
    final_cl, clrow, sent_flag, ensure ([n_pk] each), winner
    ([n_pk * n_cid]) and the three counts (sentinel raises, even
    raises, accepts).  ``plain`` calls the kernels' plain versions on
    whatever device the tensors are (the card's yardstick); otherwise
    the wrappers launch the kernels on a card (plain on the CPU)."""
    n, n_pk = pk.shape[0], seed_cl.shape[0]
    mod = (seg_sort.seg_argsort_plain, winners.seg_cummax_plain,
           winners.winners_a_plain, winners.winners_b_plain) if plain else (
           seg_sort.seg_argsort, winners.seg_cummax, winners.winners_a,
           winners.winners_b)
    argsort, cummax, run_a, run_b = mod
    comp = pk * (n_cid + 2) + (cid + 1)
    # stable sorts: index order breaks the ties of lexsort((idx, pk))
    # and lexsort((idx, cid, pk))
    o_a = argsort(pk[None], key_bits=(n_pk - 1).bit_length())[0]
    o_b = argsort(comp[None], key_bits=(
        (n_pk - 1) * (n_cid + 2) + n_cid).bit_length())[0]
    res = torch.empty(4 * n_pk + n_pk * n_cid + 3, dtype=torch.int64,
                      device=pk.device)
    final_cl, clrow, sent_flag, ensure = res[:4 * n_pk].view(4, n_pk)
    winner, counts = res[4 * n_pk:-3], res[-3:]
    final_cl.copy_(seed_cl)
    clrow.fill_(_BIG)
    res[2 * n_pk:4 * n_pk].zero_()
    winner.fill_(-1)
    counts.zero_()
    part = torch.empty(n, dtype=torch.bool, device=pk.device)
    prev_a = cummax(o_a, pk, cl)
    run_a(o_a, prev_a, pk, cl, sent, seed_cl, final_cl, sent_flag, ensure,
          part, counts)
    prev_b = cummax(o_b, comp, key, mask=part)
    run_b(o_b, prev_b, pk, cid, cl, key, part, seed_key, final_cl, n_cid,
          winner, clrow, counts)
    return res


def _winners_torch(plan: MergePlan, device="cuda",
                   plain: bool = False) -> MergeDecision:
    """``_winners_torch_core`` on ``device`` for one plan: one copy to
    the device per input and one fetch of the result buffer."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    res = _winners_torch_core(
        put(plan.pk), put(plan.cid), put(plan.sent), put(plan.cl),
        put(plan.key), put(plan.seed_cl), put(plan.seed_key), plan.n_cid,
        plain=plain).cpu().numpy()
    n_pk = plan.n_pk
    final_cl, clrow, sent_flag, ensure = res[:4 * n_pk].reshape(4, n_pk)
    gen = final_cl > plan.seed_cl
    return MergeDecision(
        final_cl=final_cl, gen=gen, alive=(final_cl & 1) == 1,
        ensure=ensure > 0, sent_flag=sent_flag > 0,
        clrow_idx=np.where(gen, clrow, -1), winner_idx=res[4 * n_pk:-3],
        impacted=int(res[-3:].sum()),
    )


def select_winners(plan: MergePlan, backend: str = "auto",
                   device="cuda") -> MergeDecision:
    """Resolve one encoded table batch to its net merge decision.

    ``backend``: ``"numpy"`` (the twin), ``"torch"`` (the kernels on
    ``device``, a card unless the caller asks for ``"cpu"``), or
    ``"auto"``: torch for batches of at least ``TORCH_AUTO_MIN``
    changes, the twin below.  Both backends return bit-identical
    decisions.  A torch batch that fails raises; nothing falls back."""
    if backend == "numpy":
        return _winners_np(plan)
    if backend == "torch" or (backend == "auto"
                              and plan.n >= TORCH_AUTO_MIN):
        return _winners_torch(plan, device)
    if backend == "auto":
        return _winners_np(plan)
    raise ValueError(f"unknown backend {backend!r}")
