"""The device mesh of the multi-device layouts and its shard fabrics
(the port's counterpart of ``jax.sharding.Mesh`` plus the ``shard_map``
collectives of ``corrosion_tpu/models/sharded.py``: ``gather_nodes``'
tiled all_gather (:47), ``lax.all_to_all`` (:246-251), ``lax.psum``
(:280) and ``axis_index``).

A :class:`Mesh` names one axis, ``"nodes"`` or ``"hosts"`` as in the
reference, or the two axes ``("seeds", "nodes")`` of the reference's
multi-chip dry run (``__graft_entry__.py`` :161) with a shape
``(seeds_ax, nodes_ax)``: shard ``sh`` sits at ``divmod(sh, nodes_ax)``,
and a collective runs over the ``nodes_ax`` shards of one seeds row
(the seeds axis needs none: its universes are independent).  It
carries one of two fabrics, chosen by the caller:

* :class:`LocalFabric` — D shards in one process on one device.  Each
  shard's leaves are separate tensors and a collective copies into each
  shard's own output buffer on the device.  This is the layout one card
  can run: every shard's bytes, replicas included, share its memory.
* :class:`DistFabric` — one shard per rank of a ``torch.distributed``
  process group (``all_gather_into_tensor``, ``all_to_all_single``,
  ``all_reduce``), with one ``dist.new_group`` a seeds row on a
  two-axis mesh.  Held against the ``LocalFabric`` with gloo on the
  CPU; NCCL across several cards is unverified.

A shard's local function is a generator: it sees only its own leaves
and what the fabric hands it, and asks for a collective by yielding
one (``got = yield all_gather(x, "delta", dim=1)``).
:meth:`Mesh.run` advances every shard this process runs to its next
collective, performs it, and hands each shard its result, so the code
a ``LocalFabric`` shard runs is the code a ``DistFabric`` rank runs.
While a shard's function runs, a :class:`Sharded` state raises
:class:`ForeignLeafError` on any access to another shard's leaves.

Every collective adds the bytes it puts on the wire to ``fabric.bytes``
under the kind its caller names (``fabric.calls`` counts the calls, one
a group): an all_gather or all_reduce counts each shard's operand once
for every other shard of its group, an all_to_all each block sent to
another shard.  A
``DistFabric`` rank counts what it sends; summed over the ranks, that
is the ``LocalFabric``'s count.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

AXES = ("nodes", "hosts")
MESH_AXES = ("seeds", "nodes")  # the two-axis mesh's, in this order


class ForeignLeafError(RuntimeError):
    """A shard's local function reached for another shard's leaves."""


class Collective(NamedTuple):
    """A request a shard's local function yields to the fabric."""

    op: str  # "all_gather" | "all_to_all" | "all_reduce"
    tensor: torch.Tensor
    kind: str  # the byte counter it is charged to
    dim: int = 0
    axis: str = "nodes"  # the mesh axis it runs over


def all_gather(x: torch.Tensor, kind: str, dim: int = 0,
               axis: str = "nodes") -> Collective:
    """Tiled all_gather: every shard's ``x`` concatenated along ``dim``
    in shard order (``gather_nodes``).  ``axis`` names the mesh axis it
    runs over: on a two-axis mesh ``"nodes"``, one seeds row's shards;
    a one-axis mesh takes it over its only axis."""
    return Collective("all_gather", x, kind, dim, axis)


def all_to_all(x: torch.Tensor, kind: str,
               axis: str = "nodes") -> Collective:
    """``x`` [D, ...]: block d goes to shard d; the result's block j
    came from shard j (``lax.all_to_all`` split and concat on axis 0)."""
    return Collective("all_to_all", x, kind, 0, axis)


def all_reduce(x: torch.Tensor, kind: str,
               axis: str = "nodes") -> Collective:
    """Elementwise sum over the shards (``lax.psum``)."""
    return Collective("all_reduce", x, kind, 0, axis)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """Bool travels as its bytes (gloo and NCCL take no bool)."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


class _Fabric:
    """Byte and call counters shared by both fabrics."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a fabric needs at least one shard, got {size}")
        self.size = size
        self.bytes: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}

    def _charge(self, kind: str, nbytes: int) -> None:
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.calls[kind] = self.calls.get(kind, 0) + 1


class LocalFabric(_Fabric):
    """D shards in one process, their leaves on one ``device``."""

    def __init__(self, size: int, device="cuda"):
        from corrosion_tpu_torch import resolve_device

        super().__init__(size)
        self.device = resolve_device(device)
        self.local_shards = tuple(range(size))
        self.colocated = size  # shards whose leaves share one device

    def subgroup(self, members: tuple) -> tuple:
        return members

    def collective(self, req: Collective, parts: dict,
                   group: tuple = None) -> dict:
        """``req`` over the shards of ``group`` (all, in order, when
        None); ``parts`` holds each one's operand."""
        group = tuple(range(self.size)) if group is None else group
        d = len(group)
        xs = [parts[sh] for sh in group]
        if req.op == "all_gather":
            self._charge(req.kind, (d - 1) * sum(x.nbytes for x in xs))
            return {sh: torch.cat(xs, dim=req.dim) for sh in group}
        if req.op == "all_reduce":
            self._charge(req.kind, (d - 1) * sum(x.nbytes for x in xs))
            total = torch.stack(xs).sum(0, dtype=xs[0].dtype)
            return {sh: total.clone() for sh in group}
        if req.op == "all_to_all":
            for x in xs:
                if x.shape[0] != d:
                    raise ValueError(f"all_to_all needs a leading axis of "
                                     f"{d} blocks, got {tuple(x.shape)}")
            self._charge(req.kind, sum(
                xs[src][dst].nbytes for src in range(d) for dst in range(d)
                if dst != src))
            return {sh: torch.stack([xs[src][dst] for src in range(d)])
                    for dst, sh in enumerate(group)}
        raise ValueError(f"unknown collective {req.op!r}")


class DistFabric(_Fabric):
    """One shard per rank of ``group`` (the default group when None),
    its leaves on ``device`` (the card unless the caller asks for the
    CPU, as the gloo tests do)."""

    def __init__(self, group=None, device="cuda"):
        import torch.distributed as dist

        from corrosion_tpu_torch import resolve_device

        device = resolve_device(device)
        if not dist.is_initialized():
            raise RuntimeError("DistFabric needs an initialised "
                               "torch.distributed process group")
        self.group = group
        self.rank = dist.get_rank(group)
        super().__init__(dist.get_world_size(group))
        self.device = device
        self.local_shards = (self.rank,)
        self.colocated = 1
        self._groups = {}  # shards (ranks of ``group``) -> process group

    def subgroup(self, members: tuple):
        """A process group of the ranks ``members`` (every rank must ask
        for every group, in the same order: ``dist.new_group``)."""
        import torch.distributed as dist

        if members not in self._groups:
            ranks = members
            if self.group is not None:
                ranks = [dist.get_global_rank(self.group, m)
                         for m in members]
            self._groups[members] = dist.new_group(ranks=list(ranks))
        return members

    def collective(self, req: Collective, parts: dict,
                   group: tuple = None) -> dict:
        import torch.distributed as dist

        pg = self.group
        d = self.size
        if group is not None:
            pg, d = self._groups[group], len(group)
        x = parts[self.rank]
        send = _wire(x)
        if req.op == "all_gather":
            self._charge(req.kind, (d - 1) * send.nbytes)
            out = torch.empty((d * send.shape[0], *send.shape[1:]),
                              dtype=send.dtype, device=send.device)
            gather = getattr(dist, "all_gather_single", None) or (
                dist.all_gather_into_tensor)
            gather(out, send, group=pg)
            if x.dtype == torch.bool:
                out = out.view(torch.bool)
            got = torch.cat(out.chunk(d), dim=req.dim)
        elif req.op == "all_reduce":
            self._charge(req.kind, (d - 1) * send.nbytes)
            got = send.clone()
            dist.all_reduce(got, group=pg)
        elif req.op == "all_to_all":
            if x.shape[0] != d:
                raise ValueError(f"all_to_all needs a leading axis of {d} "
                                 f"blocks, got {tuple(x.shape)}")
            self._charge(req.kind, send.nbytes // d * (d - 1))
            out = torch.empty_like(send)
            dist.all_to_all_single(out, send, group=pg)
            got = out.view(x.dtype) if x.dtype == torch.bool else out
        else:
            raise ValueError(f"unknown collective {req.op!r}")
        return {self.rank: got}


class Mesh:
    """A device mesh over ``fabric.size`` shards: one axis ``axis``
    (``"nodes"`` or ``"hosts"``), or the two axes ``("seeds", "nodes")``
    with ``shape`` ``(seeds_ax, nodes_ax)``, shard ``sh`` at
    ``divmod(sh, nodes_ax)`` (row-major, as the reference reshapes its
    devices)."""

    def __init__(self, axis, fabric, shape=None):
        self.fabric = fabric
        self.size = fabric.size
        self.device = fabric.device
        self._current = None  # the shard whose local function runs
        if isinstance(axis, str):
            if axis not in AXES:
                raise ValueError(f"mesh axis must be one of {AXES}, got "
                                 f"{axis!r}")
            if shape is not None and tuple(shape) != (fabric.size,):
                raise ValueError(f"a one-axis mesh has shape "
                                 f"({fabric.size},), got {shape}")
            self.axis = axis
            self.axes = (axis,)
            self.shape = (fabric.size,)
            self._groups = None  # a collective joins every shard
            return
        if tuple(axis) != MESH_AXES or shape is None or len(shape) != 2:
            raise ValueError(f"a two-axis mesh names {MESH_AXES} and a "
                             f"shape (seeds_ax, nodes_ax), got {axis!r}, "
                             f"{shape!r}")
        seeds_ax, nodes_ax = (int(x) for x in shape)
        if seeds_ax < 1 or nodes_ax < 1 or seeds_ax * nodes_ax != fabric.size:
            raise ValueError(f"mesh shape {shape} does not cover the "
                             f"fabric's {fabric.size} shards")
        self.axis = None  # no one axis: the one-axis layouts refuse it
        self.axes = MESH_AXES
        self.shape = (seeds_ax, nodes_ax)
        # one group a seeds row, each asked of the fabric in order (a
        # DistFabric makes a process group of each)
        self._groups = tuple(
            fabric.subgroup(tuple(range(s * nodes_ax, (s + 1) * nodes_ax)))
            for s in range(seeds_ax))

    def axis_size(self, name: str) -> int:
        """The number of shards along axis ``name``."""
        if name not in self.axes:
            raise ValueError(f"mesh axes are {self.axes}, not {name!r}")
        return self.shape[self.axes.index(name)]

    def coords(self, sh: int) -> tuple:
        """Shard ``sh``'s coordinates, one an axis."""
        if self._groups is None:
            return (sh,)
        return divmod(sh, self.shape[1])

    @property
    def local_shards(self) -> tuple:
        """The shards this process runs."""
        return self.fabric.local_shards

    def _perform(self, req: Collective, parts: dict) -> dict:
        if self._groups is None:
            return self.fabric.collective(req, parts)
        if req.axis != "nodes":
            raise ValueError(f"a two-axis mesh runs collectives over "
                             f"\"nodes\" only (its seeds are independent "
                             f"universes), got {req.axis!r}")
        out = {}
        for group in self._groups:
            mine = {sh: parts[sh] for sh in group if sh in parts}
            if mine:
                out.update(self.fabric.collective(req, mine, group))
        return out

    def run(self, fn, args: dict) -> dict:
        """Run the generator function ``fn(sh, *args[sh])`` for every
        local shard in lockstep, performing each collective they yield
        together (on a two-axis mesh, each seeds row's shards together);
        returns {shard: fn's return value}."""
        gens = {sh: fn(sh, *args[sh]) for sh in self.local_shards}
        sends = {sh: None for sh in gens}
        results = {}
        while gens:
            reqs = {}
            for sh in list(gens):
                self._current = sh
                try:
                    reqs[sh] = gens[sh].send(sends[sh])
                except StopIteration as stop:
                    results[sh] = stop.value
                    del gens[sh]
                finally:
                    self._current = None
            if not reqs:
                break
            if len(reqs) != len(self.local_shards):
                raise RuntimeError("the shards' local functions took "
                                   "different paths: some ended while "
                                   "others asked for a collective")
            first = next(iter(reqs.values()))
            for req in reqs.values():
                if (req.op, req.kind, req.dim, req.axis) != (
                        first.op, first.kind, first.dim, first.axis):
                    raise RuntimeError(f"the shards asked for different "
                                       f"collectives: {req[0::2]} and "
                                       f"{first[0::2]}")
            sends = self._perform(
                first, {sh: r.tensor for sh, r in reqs.items()})
        return results


class Sharded:
    """Per-shard leaves of a layout on ``mesh``: ``state[sh]`` is shard
    ``sh``'s (a NamedTuple of tensors), ``tick`` the host tick counter
    the shards share.  Only the local shards are held; reading another
    shard's leaves, or any shard's but its own while a local function
    runs, raises :class:`ForeignLeafError`."""

    def __init__(self, mesh: Mesh, parts: dict, tick: int = 0):
        self.mesh = mesh
        self._parts = dict(parts)
        self.tick = tick

    def __getitem__(self, sh: int):
        cur = self.mesh._current
        if cur is not None and cur != sh:
            raise ForeignLeafError(f"shard {cur}'s local function read "
                                   f"shard {sh}'s leaves")
        if sh not in self._parts:
            raise ForeignLeafError(f"shard {sh}'s leaves are not held by "
                                   "this process")
        return self._parts[sh]

    def shards(self) -> tuple:
        return tuple(self._parts)

    def replace(self, parts: dict, tick: int) -> "Sharded":
        return Sharded(self.mesh, parts, tick)
