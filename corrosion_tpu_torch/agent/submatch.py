"""Sharded columnar subscription matcher core (port of
``corrosion_tpu/agent/submatch.py``).

At production fan-out (10^5..10^6 standing subscriptions) one scoped
SQL evaluation per subscription per change wave is almost all
redundant work: every subscription on a table re-derives the same
per-pk liveness from the same batch.  The matcher factors it out:

* a table's change wave is resolved ONCE through the columnar CRDT
  winner selection (``ops.merge.encode_change_batch`` +
  ``select_winners``, whose ``"torch"`` backend runs the winner
  kernels on the card): duplicate and superseded changes coalesce to
  one verdict per pk, and liveness falls out of the final causal
  length (odd = live);
* live rows are fetched ONCE per (table, wave), not once per sub;
* subscriptions register predicate specs (:class:`SubSpec`) into a
  per-shard inverted index (:class:`ShardIndex`): pk IN-list
  predicates index ``pk -> subs``, whole-table subscriptions fan out
  to every wave pk.  Matching is set membership, not SQL.

Twins here: ``shard_of`` (submatch.py:41), ``SubSpec`` (:55),
``ShardIndex`` (:70), ``resolve_wave`` (:126) and ``match_wave``
(:149): the whole module, consumed by the pubsub manager
(``agent/pubsub.py``) of the live agent.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, List, Optional, Set, Tuple

from corrosion_tpu_torch.ops import merge as mergeops
from corrosion_tpu_torch.types.change import SENTINEL_CID


def shard_of(sub_id: str, n_shards: int) -> int:
    """Stable shard assignment for a subscription id.

    blake2s, not ``hash()``: the assignment must survive restarts
    (``PYTHONHASHSEED`` randomizes ``hash(str)``) so restored
    subscriptions land on the same shard their persisted state was
    maintained from."""
    if n_shards <= 1:
        return 0
    digest = hashlib.blake2s(sub_id.encode(), digest_size=4).digest()
    return int.from_bytes(digest, "big") % n_shards


@dataclass(frozen=True)
class SubSpec:
    """One columnar-matchable subscription predicate.

    ``proj_idx`` indexes into the table's declared column order (the
    fetch row), ``pk_filter`` is the packed-pk membership set of a pk
    IN-list predicate (None = whole table).  Only shapes whose verdict
    is fully decidable from (pk, liveness, current row) qualify."""

    sub_id: str
    table: str
    proj_idx: Tuple[int, ...]
    pk_filter: Optional[FrozenSet[bytes]] = None


class ShardIndex:
    """Inverted predicate index for one matcher shard.

    ``pk -> subs`` for IN-list predicates plus a broad (whole-table)
    set per table.  Mutated under the owner's lock; read by the shard's
    own worker only after the wave buffer referencing it was routed
    under the same lock."""

    def __init__(self) -> None:
        self.specs: Dict[str, SubSpec] = {}
        self._broad: Dict[str, Set[str]] = {}
        self._by_pk: Dict[str, Dict[bytes, Set[str]]] = {}

    def add(self, spec: SubSpec) -> None:
        self.remove(spec.sub_id)
        self.specs[spec.sub_id] = spec
        if spec.pk_filter is None:
            self._broad.setdefault(spec.table, set()).add(spec.sub_id)
            return
        per = self._by_pk.setdefault(spec.table, {})
        for pk in spec.pk_filter:
            per.setdefault(pk, set()).add(spec.sub_id)

    def remove(self, sub_id: str) -> None:
        spec = self.specs.pop(sub_id, None)
        if spec is None:
            return
        if spec.pk_filter is None:
            broad = self._broad.get(spec.table)
            if broad:
                broad.discard(sub_id)
                if not broad:
                    del self._broad[spec.table]
            return
        per = self._by_pk.get(spec.table)
        if not per:
            return
        for pk in spec.pk_filter:
            subs = per.get(pk)
            if subs:
                subs.discard(sub_id)
                if not subs:
                    del per[pk]
        if not per:
            del self._by_pk[spec.table]

    def has(self, table: str) -> bool:
        return table in self._broad or table in self._by_pk

    def subs_on(self, table: str) -> Set[str]:
        out: Set[str] = set(self._broad.get(table, ()))
        for subs in self._by_pk.get(table, {}).values():
            out |= subs
        return out


def resolve_wave(changes, backend: str = "auto", device=None):
    """Coalesce one table's change wave to per-pk verdicts.

    Returns ``(pks, alive)``: unique pks in first-appearance order and
    their net liveness after the whole wave (final causal length odd).
    The winner selection resolves duplicates and superseded changes in
    one segmented scan, on ``backend`` and ``device`` as
    ``select_winners`` takes them (``"auto"`` answers as the
    reference's does on a host with no card; ``"torch"`` raises there
    unless ``device="cpu"``).  A wave that cannot be encoded (non-int
    clock fields) is resolved by a max-cl dict pass with the same
    semantics."""
    plan = mergeops.encode_change_batch(changes, SENTINEL_CID)
    if plan is None:
        seen: Dict[bytes, int] = {}
        for ch in changes:
            cl = int(ch.cl)
            if cl > seen.get(ch.pk, -1):
                seen[ch.pk] = cl
        return list(seen.keys()), [cl % 2 == 1 for cl in seen.values()]
    dec = mergeops.select_winners(plan, backend=backend, device=device)
    return list(plan.pk_values), [bool(a) for a in dec.alive.tolist()]


def match_wave(
    index: ShardIndex,
    table: str,
    pks: List[bytes],
    fetch: Callable[[List[bytes]], Dict[bytes, tuple]],
) -> Tuple[Dict[str, Dict[bytes, Optional[tuple]]], int]:
    """Fan one resolved wave out to every subscribed predicate.

    ``fetch(pks) -> {pk: row}`` returns the CURRENT rows (post-apply
    database state, declared column order); it is called ONCE with
    every wave pk that reaches at least one subscription, and row
    presence decides the verdict (present -> upsert, absent ->
    delete).  The wave's own liveness bits are deliberately NOT trusted
    for the final verdict: the database may have resolved a buffered
    change differently or moved past the wave, and it is the converged
    truth the per-sub oracle would read.  Returns ``(verdicts,
    n_pairs)`` where ``verdicts[sub_id][pk]`` is the row tuple (upsert)
    or None (delete), and ``n_pairs`` counts delivered (sub, pk)
    verdicts."""
    broad = index._broad.get(table)
    by_pk = index._by_pk.get(table)
    need = [
        pk for pk in pks if broad or (by_pk and pk in by_pk)
    ]
    rows = fetch(need) if need else {}
    verdicts: Dict[str, Dict[bytes, Optional[tuple]]] = {}
    n_pairs = 0
    for pk in need:
        row = rows.get(pk)
        targets = by_pk.get(pk) if by_pk else None
        if targets:
            for sid in targets:
                verdicts.setdefault(sid, {})[pk] = row
            n_pairs += len(targets)
        if broad:
            for sid in broad:
                verdicts.setdefault(sid, {})[pk] = row
            n_pairs += len(broad)
    return verdicts, n_pairs
