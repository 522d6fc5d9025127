"""Carry simulator state and PRNG keys between the reference and the
port.

The simulator has no weights; its state plays that role.  A reference
``EpidemicState`` (with ``sent`` when tracked), ``PackedExactState``,
``FrontierExactState``, calibration-scale ``ExactState`` or
``SwimState`` (any NamedTuple or mapping with its fields, the values
numpy arrays or anything ``np.asarray`` takes), or an anti-entropy
carry ``(bits, msgs)``, becomes the port's tensors on a given device,
and back, so both sides can start from the same state and keys.  A
reference ``MergePlan`` (an encoded change batch) becomes the port's,
so one batch feeds both packages' ``select_winners``, and
``decision_diff`` compares two ``MergeDecision``s.  Reference ``Change``
objects become the port's (``changes_from_reference``), so one stream
feeds both packages' ``CrConn``, and a reference ``DeviceClockCache``
becomes the port's on a device (``devcache_from_reference``), so a
warmed cache carries across.  ``shard_state`` / ``unshard_state`` lay
a port state out over a ``mesh.Mesh`` by a layout (each leaf row-sharded
on an axis or replicated) and back, and ``sharded_state_from_reference``
takes the reference's sharded state (its global arrays) straight to the
port's shards, so both packages' mesh kernels start from one state.  An
exact-sampler state may be one seed's (leaves [N, ...], as
``packed_exact_tick`` holds it) or a seed batch's (leaves [S, N, ...]
and ticks [S], as the vmapped runners hold it); the port's always has
the seed axis.
"""

from __future__ import annotations

from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.mesh import Sharded
from corrosion_tpu_torch.models.swim import SwimState
from corrosion_tpu_torch.ops.devcache import (
    VAL_UNKNOWN,
    DeviceClockCache,
    _TableCache,
)
from corrosion_tpu_torch.ops.merge import MergePlan
from corrosion_tpu_torch.random import key_words
from corrosion_tpu_torch.sim.calibrate import (
    ExactState,
    FrontierExactState,
    PackedExactState,
)
from corrosion_tpu_torch.sim.epidemic import EpidemicState
from corrosion_tpu_torch.types.base import CrsqlDbVersion, CrsqlSeq
from corrosion_tpu_torch.types.change import Change

TENSOR_FIELDS = ("rows", "tx_remaining", "msgs", "hops", "next_send")
# the exact-sampler leaves and their dtypes (``sent`` / ``ring`` by type)
EXACT_FIELDS = {"infected": np.bool_, "tx": np.int32,
                "next_send": np.int32, "msgs": np.int32,
                "pending": np.int32}


def _fields(state) -> dict:
    return dict(state._asdict() if hasattr(state, "_asdict") else state)


def _tensor(x, dtype, device):
    if x is None:
        return None
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def state_from_numpy(state, device="cuda") -> EpidemicState:
    """The port's ``EpidemicState`` on ``device`` from a reference
    state given as numpy arrays (``sent`` [N, N] bool when tracked;
    with a leading seed axis on every leaf for the ``track_sent``
    runner's batched state).  The tick must be one for all seeds."""
    device = resolve_device(device)
    d = _fields(state)
    ticks = np.unique(np.asarray(d["tick"]))
    if ticks.size != 1:
        raise ValueError(f"the seeds of a batch tick together, got ticks "
                         f"{ticks.tolist()}")
    return EpidemicState(
        tick=int(ticks[0]),
        sent=_tensor(d.get("sent"), np.bool_, device),
        **{f: _tensor(d[f], np.int32, device) for f in TENSOR_FIELDS},
    )


def state_to_numpy(state: EpidemicState) -> dict:
    """{field: numpy array (or None)} of a port state, tick as an int."""
    out = {
        f: None if getattr(state, f) is None
        else getattr(state, f).cpu().numpy()
        for f in (*TENSOR_FIELDS, "sent")
    }
    out["tick"] = int(state.tick)
    return out


def exact_state_from_numpy(state, device="cuda") -> ExactState:
    """The port's calibration-scale ``ExactState`` on ``device`` from a
    reference one ([N] leaves, ``sent`` [N, N]) given as numpy arrays;
    ``exact_state_to_numpy`` is its inverse."""
    device = resolve_device(device)
    d = _fields(state)
    return ExactState(
        tick=int(np.asarray(d["tick"])),
        sent=_tensor(d["sent"], np.bool_, device),
        **{f: _tensor(d[f], EXACT_FIELDS[f], device)
           for f in ("infected", "tx", "next_send", "msgs")},
    )


def _exact_from_numpy(cls, memory: str, dtype, state, device):
    device = resolve_device(device)
    d = _fields(state)
    batched = np.ndim(d["infected"]) == 2
    ticks = np.unique(np.asarray(d["tick"]))
    if ticks.size != 1:
        raise ValueError(f"the seeds of a batch tick together, got ticks "
                         f"{ticks.tolist()}")

    def tensor(x, dt):
        a = np.array(x, dtype=dt)
        return torch.from_numpy(a if batched else a[None]).to(device)

    leaves = {f: tensor(d[f], dt) for f, dt in EXACT_FIELDS.items()}
    return cls(tick=int(ticks[0]), **{memory: tensor(d[memory], dtype)},
               **leaves)


def packed_state_from_numpy(state, device="cuda") -> PackedExactState:
    """The port's ``PackedExactState`` on ``device`` from a reference
    one (single-seed or seed-batched) given as numpy arrays."""
    return _exact_from_numpy(PackedExactState, "sent", np.uint8, state,
                             device)


def frontier_state_from_numpy(state, device="cuda") -> FrontierExactState:
    """The port's ``FrontierExactState`` on ``device`` from a reference
    one (single-seed or seed-batched) given as numpy arrays."""
    return _exact_from_numpy(FrontierExactState, "ring", np.int32, state,
                             device)


def exact_state_to_numpy(state) -> dict:
    """{field: numpy array} of a port ``PackedExactState`` or
    ``FrontierExactState`` (with the seed axis) or ``ExactState``, tick
    as an int (the inverse of the ``*_from_numpy`` of each)."""
    out = {f: v.cpu().numpy() for f, v in state._asdict().items()
           if f != "tick"}
    out["tick"] = int(state.tick)
    return out


def anti_entropy_from_numpy(carry, device="cuda") -> tuple:
    """The port's anti-entropy carry (bits [N, S] bool, msgs [N] int32)
    on ``device`` from a reference ``(bits, msgs)``."""
    device = resolve_device(device)
    bits, msgs = carry
    return (torch.from_numpy(np.array(bits, dtype=np.bool_)).to(device),
            torch.from_numpy(np.array(msgs, dtype=np.int32)).to(device))


def anti_entropy_to_numpy(carry) -> tuple:
    """(bits, msgs) numpy arrays of a port anti-entropy carry."""
    return tuple(t.cpu().numpy() for t in carry)


def swim_state_from_numpy(state, device="cuda") -> SwimState:
    """The port's ``SwimState`` on ``device`` from a reference one given
    as numpy arrays (every leaf int32)."""
    device = resolve_device(device)
    d = _fields(state)
    return SwimState(**{
        f: torch.from_numpy(np.array(d[f], dtype=np.int32)).to(device)
        for f in SwimState._fields
    })


def swim_state_to_numpy(state: SwimState) -> dict:
    """{field: numpy array} of a port ``SwimState``."""
    return {f: getattr(state, f).cpu().numpy() for f in SwimState._fields}


def key_from_numpy(key) -> torch.Tensor:
    """A port key (host ``uint32[2]`` tensor) from a reference key."""
    return torch.tensor(key_words(np.asarray(key)), dtype=torch.uint32)


def key_to_numpy(key) -> np.ndarray:
    return np.asarray(key_words(key), dtype=np.uint32)


# the array fields of a MergePlan and their dtypes
PLAN_ARRAYS = {"pk": np.int64, "cid": np.int64, "sent": np.bool_,
               "cl": np.int64, "key": np.int64, "seed_cl": np.int64,
               "seed_key": np.int64}
DECISION_ARRAYS = ("final_cl", "gen", "alive", "ensure", "sent_flag",
                   "clrow_idx", "winner_idx")


def merge_plan_from_reference(plan) -> MergePlan:
    """The port's ``MergePlan`` from a reference one (any object with
    its fields; arrays as numpy or anything ``np.asarray`` takes)."""
    d = {f.name: getattr(plan, f.name) for f in fields(MergePlan)}
    for name, dtype in PLAN_ARRAYS.items():
        d[name] = np.array(d[name], dtype=dtype)
    d["pk_values"], d["cid_values"] = list(d["pk_values"]), list(
        d["cid_values"])
    return MergePlan(**d)


def decision_diff(a, b) -> list:
    """Names of the fields in which two ``MergeDecision``s (the port's
    or the reference's) differ, in value or dtype; ``impacted``
    included.  Empty when they are bitwise equal."""
    diff = []
    for name in DECISION_ARRAYS:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        if x.dtype != y.dtype or not np.array_equal(x, y):
            diff.append(name)
    if int(a.impacted) != int(b.impacted):
        diff.append("impacted")
    return diff


def changes_from_reference(changes) -> list:
    """The port's ``Change`` for each reference ``Change`` (any object
    with its fields), every field value identical."""
    return [
        Change(table=c.table, pk=c.pk, cid=c.cid, val=c.val,
               col_version=c.col_version,
               db_version=CrsqlDbVersion(int(c.db_version)),
               seq=CrsqlSeq(int(c.seq)), site_id=c.site_id, cl=c.cl)
        for c in changes
    ]


def devcache_from_reference(ref_cache, device="cuda") -> DeviceClockCache:
    """The port's ``DeviceClockCache`` (torch store on ``device``) from a
    reference one between transactions (empty shadow): every table's
    slot map, capacities, packed-key index, values (the reference's
    version-only marker mapped to this package's ``VAL_UNKNOWN``), row
    flags and the store arrays (``to_host``), and the counters.  The
    reference cache is left as it was."""
    if ref_cache._shadow:
        raise ValueError("devcache_from_reference: the reference cache "
                         "holds an open transaction's shadow")
    out = DeviceClockCache(slots=ref_cache.slots, backend="torch",
                           device=device)
    store = out.store
    for name, rt in ref_cache._tables.items():
        cols = sorted(rt.cid_ord, key=rt.cid_ord.get)
        info = SimpleNamespace(name=name, data_cols=cols)
        tc = _TableCache(info, store, rt.max_rows, rt.max_cells)
        tc.n_cid = rt.n_cid
        tc.pk_slot = dict(rt.pk_slot)
        tc.next_slot = rt.next_slot
        tc.cap_rows = rt.cap_rows
        tc.row_cl = store.from_host(rt.store.to_host(rt.row_cl))
        tc.row_known = np.array(rt.row_known, dtype=bool)
        tc.row_present = np.array(rt.row_present, dtype=bool)
        tc.cap_cells = rt.cap_cells
        tc.capbits = rt.capbits
        tc.cell_keys = np.array(rt.cell_keys, dtype=np.int64)
        tc.cell_ver = store.from_host(rt.store.to_host(rt.cell_ver))
        # the reference's version-only marker becomes this package's
        tc.cell_val = [VAL_UNKNOWN if type(v).__name__ == "_ValUnknown"
                       else v for v in rt.cell_val]
        tc.cells_used = rt.cells_used
        out._tables[name] = tc
    out.counters = dict(ref_cache.counters)
    out.invalidations = dict(ref_cache.invalidations)
    return out


def shard_state(state, layout, mesh) -> Sharded:
    """Lay ``state`` (a NamedTuple of global tensors; a ``tick`` field
    holds the host tick) out over ``mesh``: ``layout`` is the same
    NamedTuple type holding, for each leaf, the axis it row-shards on
    or None where every shard keeps a replica.  Each local shard gets
    its own copies on the mesh's device."""
    tick = getattr(state, "tick", 0)
    d = mesh.size
    parts = {}
    for sh in mesh.local_shards:
        leaves = {}
        for f, axis in layout._asdict().items():
            x = getattr(state, f)
            if f == "tick":
                leaves[f] = tick
            elif axis is None:
                leaves[f] = x.to(mesh.device, copy=True)
            else:
                if x.shape[axis] % d:
                    raise ValueError(f"{f}: {x.shape[axis]} rows do not "
                                     f"split over {d} shards")
                w = x.shape[axis] // d
                leaves[f] = x.narrow(axis, sh * w, w).to(
                    mesh.device, copy=True).contiguous()
        parts[sh] = type(state)(**leaves)
    return Sharded(mesh, parts, tick)


def unshard_state(sharded: Sharded, layout):
    """The global state of a ``Sharded`` whose shards this process holds
    all of: sharded leaves concatenated in shard order, replicated ones
    from shard 0 (raises where the replicas disagree)."""
    shards = sharded.shards()
    if len(shards) != sharded.mesh.size:
        raise ValueError("unshard_state needs every shard in this process "
                         f"(holds {len(shards)} of {sharded.mesh.size})")
    parts = [sharded[sh] for sh in range(sharded.mesh.size)]
    leaves = {}
    for f, axis in layout._asdict().items():
        if f == "tick":
            leaves[f] = sharded.tick
        elif axis is None:
            x = getattr(parts[0], f)
            for sh, part in enumerate(parts[1:], 1):
                if not torch.equal(getattr(part, f), x):
                    raise ValueError(f"{f}: shard {sh}'s replica differs "
                                     "from shard 0's")
            leaves[f] = x
        else:
            leaves[f] = torch.cat([getattr(p, f) for p in parts], dim=axis)
    return type(parts[0])(**leaves)


def sharded_state_from_reference(state, layout, mesh) -> Sharded:
    """A reference ``PackedExactState`` or ``FrontierExactState`` laid
    out over a JAX mesh (each leaf's global array, as ``np.asarray``
    gives it, or a seed batch of them) as the port's shards on
    ``mesh`` by ``layout``."""
    f = _fields(state)
    port = (frontier_state_from_numpy if "ring" in f
            else packed_state_from_numpy)(f, device=mesh.device)
    return shard_state(port, layout, mesh)
