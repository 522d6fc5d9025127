"""The device mesh of the multi-device layouts and its shard fabrics
(the port's counterpart of ``jax.sharding.Mesh`` plus the ``shard_map``
collectives of ``corrosion_tpu/models/sharded.py``: ``gather_nodes``'
tiled all_gather (:47), ``lax.all_to_all`` (:246-251), ``lax.psum``
(:280) and ``axis_index``).

A :class:`Mesh` names one axis, ``"nodes"`` or ``"hosts"`` as in the
reference, and carries one of two fabrics, chosen by the caller:

* :class:`LocalFabric` — D shards in one process on one device.  Each
  shard's leaves are separate tensors and a collective copies into each
  shard's own output buffer on the device.  This is the layout one card
  can run: every shard's bytes, replicas included, share its memory.
* :class:`DistFabric` — one shard per rank of a ``torch.distributed``
  process group (``all_gather_into_tensor``, ``all_to_all_single``,
  ``all_reduce``).  Held against the ``LocalFabric`` with gloo on the
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
under the kind its caller names (``fabric.calls`` counts the calls):
an all_gather or all_reduce counts each shard's operand once for every
other shard, an all_to_all each block sent to another shard.  A
``DistFabric`` rank counts what it sends; summed over the ranks, that
is the ``LocalFabric``'s count.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

AXES = ("nodes", "hosts")


class ForeignLeafError(RuntimeError):
    """A shard's local function reached for another shard's leaves."""


class Collective(NamedTuple):
    """A request a shard's local function yields to the fabric."""

    op: str  # "all_gather" | "all_to_all" | "all_reduce"
    tensor: torch.Tensor
    kind: str  # the byte counter it is charged to
    dim: int = 0


def all_gather(x: torch.Tensor, kind: str, dim: int = 0) -> Collective:
    """Tiled all_gather: every shard's ``x`` concatenated along ``dim``
    in shard order (``gather_nodes``)."""
    return Collective("all_gather", x, kind, dim)


def all_to_all(x: torch.Tensor, kind: str) -> Collective:
    """``x`` [D, ...]: block d goes to shard d; the result's block j
    came from shard j (``lax.all_to_all`` split and concat on axis 0)."""
    return Collective("all_to_all", x, kind)


def all_reduce(x: torch.Tensor, kind: str) -> Collective:
    """Elementwise sum over the shards (``lax.psum``)."""
    return Collective("all_reduce", x, kind)


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

    def collective(self, req: Collective, parts: dict) -> dict:
        d = self.size
        xs = [parts[sh] for sh in range(d)]
        if req.op == "all_gather":
            self._charge(req.kind, (d - 1) * sum(x.nbytes for x in xs))
            return {sh: torch.cat(xs, dim=req.dim) for sh in range(d)}
        if req.op == "all_reduce":
            self._charge(req.kind, (d - 1) * sum(x.nbytes for x in xs))
            total = torch.stack(xs).sum(0, dtype=xs[0].dtype)
            return {sh: total.clone() for sh in range(d)}
        if req.op == "all_to_all":
            for x in xs:
                if x.shape[0] != d:
                    raise ValueError(f"all_to_all needs a leading axis of "
                                     f"{d} blocks, got {tuple(x.shape)}")
            self._charge(req.kind, sum(
                xs[src][dst].nbytes for src in range(d) for dst in range(d)
                if dst != src))
            return {dst: torch.stack([xs[src][dst] for src in range(d)])
                    for dst in range(d)}
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

    def collective(self, req: Collective, parts: dict) -> dict:
        import torch.distributed as dist

        d = self.size
        x = parts[self.rank]
        send = _wire(x)
        if req.op == "all_gather":
            self._charge(req.kind, (d - 1) * send.nbytes)
            out = torch.empty((d * send.shape[0], *send.shape[1:]),
                              dtype=send.dtype, device=send.device)
            gather = getattr(dist, "all_gather_single", None) or (
                dist.all_gather_into_tensor)
            gather(out, send, group=self.group)
            if x.dtype == torch.bool:
                out = out.view(torch.bool)
            got = torch.cat(out.chunk(d), dim=req.dim)
        elif req.op == "all_reduce":
            self._charge(req.kind, (d - 1) * send.nbytes)
            got = send.clone()
            dist.all_reduce(got, group=self.group)
        elif req.op == "all_to_all":
            if x.shape[0] != d:
                raise ValueError(f"all_to_all needs a leading axis of {d} "
                                 f"blocks, got {tuple(x.shape)}")
            self._charge(req.kind, send.nbytes // d * (d - 1))
            out = torch.empty_like(send)
            dist.all_to_all_single(out, send, group=self.group)
            got = out.view(x.dtype) if x.dtype == torch.bool else out
        else:
            raise ValueError(f"unknown collective {req.op!r}")
        return {self.rank: got}


class Mesh:
    """A one-axis device mesh: ``axis`` (``"nodes"`` or ``"hosts"``)
    over ``fabric.size`` shards."""

    def __init__(self, axis: str, fabric):
        if axis not in AXES:
            raise ValueError(f"mesh axis must be one of {AXES}, got {axis!r}")
        self.axis = axis
        self.fabric = fabric
        self.size = fabric.size
        self.device = fabric.device
        self._current = None  # the shard whose local function runs

    @property
    def local_shards(self) -> tuple:
        """The shards this process runs."""
        return self.fabric.local_shards

    def run(self, fn, args: dict) -> dict:
        """Run the generator function ``fn(sh, *args[sh])`` for every
        local shard in lockstep, performing each collective they yield
        together; returns {shard: fn's return value}."""
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
                if (req.op, req.kind, req.dim) != (first.op, first.kind,
                                                   first.dim):
                    raise RuntimeError(f"the shards asked for different "
                                       f"collectives: {req[0::2]} and "
                                       f"{first[0::2]}")
            sends = self.fabric.collective(
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
