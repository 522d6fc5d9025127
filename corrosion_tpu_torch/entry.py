"""The port's entry module: one protocol round, the placements of the
two core steps over a ``("seeds", "nodes")`` mesh and the multi-device
dry run (the twin of ``__graft_entry__.py``).

* :func:`entry` — one epidemic round at N = 4096 (ref :59);
* :func:`epidemic_shardings` / :func:`swim_shardings` — each leaf's
  spec as the reference places it (ref :87, :109): ``("seeds",
  "nodes")``, ``("seeds",)``, ``("nodes",)`` or ``()`` (replicated), a
  ``None`` leaf ``None``;
* :func:`shard_state` / :func:`unshard_state` — a batched state cut
  into a ``mesh.Sharded`` by those specs and put back together;
* :func:`dryrun_multichip` — the reference's inline dry run (ref
  :161-456) in its order: the vmapped epidemic tick over ``(seeds_ax,
  nodes_ax)``, SWIM over ``nodes``, the all_gather and ring broadcast
  fabrics (bitwise equal), the seq fabric, the sharded exact sampler
  held to ``packed_exact_tick`` for 2 ticks, and the headline-shape
  walls.

The reference provisions a virtual CPU mesh in a subprocess; here the
``n_devices`` shards are a ``LocalFabric`` on one device (or the
caller's fabric, a ``DistFabric`` when it brings ranks).  Every entry
point runs on ``"cuda"`` unless the caller passes ``device="cpu"``;
asking for the card without one raises.

    python -m corrosion_tpu_torch.entry multichip 8
    python -m corrosion_tpu_torch.entry
"""

from __future__ import annotations

import json
import sys
import time

import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.mesh import MESH_AXES, LocalFabric, Mesh, Sharded
from corrosion_tpu_torch.sim.epidemic import batch_state  # noqa: F401


def entry(device="cuda"):
    """(fn, example_args): one protocol round at N = 4096, ``fn(state,
    key)`` the port's ``epidemic_tick`` (ref :59)."""
    from corrosion_tpu_torch.random import PRNGKey
    from corrosion_tpu_torch.sim.epidemic import (
        EpidemicConfig,
        epidemic_init,
        epidemic_tick,
    )

    cfg = EpidemicConfig(n_nodes=4096, n_rows=8, loss=0.05,
                         partition_blocks=2, heal_tick=4, sync_interval=4)

    def step(state, key):
        return epidemic_tick(state, key, cfg)

    return step, (epidemic_init(cfg, device=device), PRNGKey(0))


def _check_axes(mesh, names) -> None:
    missing = [a for a in names if a not in mesh.axes]
    if missing:
        raise ValueError(f"the mesh has axes {mesh.axes}, not {missing}")


def epidemic_shardings(mesh, batched):
    """The spec of each leaf of a [seeds, nodes, ...]-batched
    ``EpidemicState`` (ref :87): ``("seeds", "nodes")`` where a leaf
    has two dims or more and more than one node, ``("seeds",)`` for an
    [S] leaf and the host tick (the seeds advance in lockstep: it stands
    for the reference's [S] tick), ``()`` otherwise; ``None`` for an
    absent leaf (``hops`` or ``sent`` off)."""
    _check_axes(mesh, MESH_AXES)

    def spec_for(x):
        if x is None:
            return None
        if isinstance(x, int):
            return ("seeds",)
        if x.dim() >= 2 and x.shape[1] > 1:
            return ("seeds", "nodes")
        if x.dim() >= 1:
            return ("seeds",)
        return ()

    return type(batched)(*(spec_for(x) for x in batched))


def swim_shardings(mesh, state):
    """The spec of each leaf of a ``SwimState`` (ref :109): every leaf
    leads with the viewer node axis, over ``nodes`` (on a two-axis mesh
    replicated over ``seeds``)."""
    _check_axes(mesh, ("nodes",))
    return type(state)(*(None if x is None
                         else ("nodes",) if isinstance(x, int) or x.dim() >= 1
                         else () for x in state))


def _cut(x, spec, mesh, sh):
    coords = mesh.coords(sh)
    col = coords[-1]
    row = coords[0] if len(coords) == 2 else 0
    for dim, axis in enumerate(spec):
        d = mesh.axis_size(axis)
        if x.shape[dim] % d:
            raise ValueError(f"{x.shape[dim]} rows do not split over {d} "
                             f"{axis} shards")
        w = x.shape[dim] // d
        x = x.narrow(dim, (row if axis == "seeds" else col) * w, w)
    return x.to(mesh.device, copy=True).contiguous()


def shard_state(state, mesh, specs) -> Sharded:
    """``state`` (a NamedTuple of global tensors, its host tick an int)
    laid out over ``mesh`` by ``specs`` (``epidemic_shardings`` /
    ``swim_shardings``): each local shard gets its own copy of its
    block of every leaf on the mesh's device; a ``None`` leaf passes."""
    parts = {}
    for sh in mesh.local_shards:
        parts[sh] = type(state)(*(
            x if x is None or isinstance(x, int) else _cut(x, spec, mesh, sh)
            for x, spec in zip(state, specs)))
    tick = next((x for x in state if isinstance(x, int)), 0)
    return Sharded(mesh, parts, tick)


def unshard_state(sharded: Sharded, specs):
    """The global state of a ``Sharded`` whose shards this process holds
    all of: each leaf's blocks put back together by its spec (raises
    where two replicas of a block differ); the host tick from the
    ``Sharded``."""
    mesh = sharded.mesh
    if len(sharded.shards()) != mesh.size:
        raise ValueError("unshard_state needs every shard in this process "
                         f"(holds {len(sharded.shards())} of {mesh.size})")
    rows, cols = (mesh.shape if len(mesh.shape) == 2 else (1, mesh.shape[0]))
    parts = [[sharded[r * cols + c] for c in range(cols)]
             for r in range(rows)]
    leaves = []
    for f, spec in enumerate(specs):
        x = getattr(parts[0][0], parts[0][0]._fields[f])
        if x is None or isinstance(x, int):
            leaves.append(sharded.tick if isinstance(x, int) else None)
            continue
        grid = [[part[f] for part in row] for row in parts]
        by_row = "seeds" in spec
        by_col = "nodes" in spec
        col_dim = spec.index("nodes") if by_col else None
        blocks = []
        for r in range(rows) if by_row else range(1):
            line = (torch.cat(grid[r], dim=col_dim) if by_col
                    else grid[r][0])
            blocks.append(line)
        whole = torch.cat(blocks, dim=0) if by_row else blocks[0]
        # every replica equals its block
        for r in range(rows):
            for c in range(cols):
                want = _cut(whole, spec, mesh, r * cols + c)
                if not torch.equal(grid[r][c], want):
                    raise ValueError(f"leaf {f}: shard {r * cols + c}'s "
                                     "replica differs")
        leaves.append(whole)
    return type(parts[0][0])(*leaves)


def _mesh_shape(n_devices: int) -> tuple:
    seeds_ax = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return seeds_ax, n_devices // seeds_ax


def leaves_equal(a, b) -> bool:
    """Every leaf of two states of one type equal (tensors where they
    lie, ints and ``None`` as values)."""
    return all((x is None and y is None) or (
        x is not None and y is not None and (
            x == y if isinstance(x, int) else torch.equal(x, y)))
        for x, y in zip(a, b))


def seed_state(state, s: int):
    """Seed ``s``'s state of a batched one."""
    return type(state)(*(x if x is None or isinstance(x, int) else x[s]
                         for x in state))


def dryrun_multichip(n_devices: int = 8, device="cuda") -> dict:
    """Shard the full cluster step over an ``n_devices`` mesh and run it
    (the reference's ``_dryrun_multichip_inline``, :161-456, in its
    order, with its asserts): ``n_devices`` shards of a ``LocalFabric``
    on ``device`` (the sharded steps run over a ``DistFabric`` too:
    ``tests/test_torch_dist.py``).  The epidemic tick and the SWIM step
    are also held bitwise to their single-device forms.  Prints the
    reference's two lines and returns the JSON line's object with the
    fabric's bytes and calls."""
    from corrosion_tpu_torch import convert
    from corrosion_tpu_torch.models.broadcast import BroadcastParams
    from corrosion_tpu_torch.models.sharded import (
        BroadcastShard,
        SeqShard,
        sharded_broadcast_step,
        sharded_broadcast_step_ring,
        sharded_epidemic_tick,
        sharded_seq_sync_step,
        sharded_swim_step,
    )
    from corrosion_tpu_torch.models.swim import (
        SwimParams,
        swim_init,
        swim_step,
    )
    from corrosion_tpu_torch.models.sync import SeqSyncParams
    from corrosion_tpu_torch.ops.keys import DEFAULT_CODEC
    from corrosion_tpu_torch.random import PRNGKey, fold_in, split
    from corrosion_tpu_torch.sim.calibrate import (
        DENSE_LAYOUT,
        HeadlineExactConfig,
        packed_exact_init,
        packed_exact_tick,
        sharded_packed_exact_step,
    )
    from corrosion_tpu_torch.sim.epidemic import (
        EpidemicConfig,
        epidemic_init,
        epidemic_tick,
    )

    dev = resolve_device(device)
    fabric = LocalFabric(n_devices, dev)
    seeds_ax, nodes_ax = _mesh_shape(n_devices)
    mesh = Mesh(MESH_AXES, fabric, (seeds_ax, nodes_ax))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n_seeds = seeds_ax * 2
    n_nodes = nodes_ax * 64
    cfg = EpidemicConfig(n_nodes=n_nodes, n_rows=4, ring0_size=16, loss=0.05,
                         partition_blocks=2, heal_tick=2, sync_interval=2,
                         chunk_ticks=4)

    # --- epidemic step, [seeds, nodes, ...] sharded over both axes ------
    batched = batch_state(epidemic_init(cfg, device=dev), n_seeds)
    specs = epidemic_shardings(mesh, batched)
    keys = list(split(PRNGKey(0), n_seeds))
    out = unshard_state(sharded_epidemic_tick(mesh, cfg)(
        shard_state(batched, mesh, specs), keys), specs)
    assert out.rows.shape == (n_seeds, n_nodes, cfg.n_rows)
    for s, k in enumerate(keys):
        assert leaves_equal(seed_state(out, s), epidemic_tick(
            seed_state(batched, s), k, cfg)), f"sharded epidemic seed {s}"

    # --- SWIM step, [N, N] view sharded over the viewer axis ------------
    sp = SwimParams(n_nodes=n_nodes)
    sw = swim_init(n_nodes, device=dev)
    sw_specs = swim_shardings(mesh, sw)
    alive = torch.ones(n_nodes, dtype=torch.bool, device=dev)
    out2 = unshard_state(sharded_swim_step(mesh, sp)(
        shard_state(sw, mesh, sw_specs), PRNGKey(1), 0, alive), sw_specs)
    assert out2.view.shape == (n_nodes, n_nodes)
    assert leaves_equal(out2, swim_step(sw, PRNGKey(1), 0, sp, alive)), (
        "sharded swim diverged")

    # --- explicit-collective fabric: the broadcast over "nodes" ---------
    nodes_mesh = Mesh("nodes", fabric)
    fabric_n = n_devices * 32
    bp = BroadcastParams(n_nodes=fabric_n, fanout_ring0=0, fanout_global=3,
                         ring0_size=1, max_transmissions=4)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = DEFAULT_CODEC.pack(torch.ones((fabric_n, 4), **i32),
                              torch.ones((fabric_n, 4), **i32),
                              torch.zeros((fabric_n, 4), **i32))
    news = DEFAULT_CODEC.pack(torch.ones((4,), **i32),
                              torch.full((4,), 2, **i32),
                              torch.ones((4,), **i32))
    rows[0] = news  # shard 0 holds distinct knowledge
    tx = torch.zeros(fabric_n, **i32)
    tx[0] = 4
    leaves = BroadcastShard(rows, tx, torch.zeros(fabric_n, **i32))
    layout = BroadcastShard(0, 0, 0)
    key = PRNGKey(2)
    step = sharded_broadcast_step(nodes_mesh, bp)
    f_state = convert.shard_state(leaves, layout, nodes_mesh)
    for t in range(8):
        f_state = step(f_state, fold_in(key, t))
    f_rows = convert.unshard_state(f_state, layout).rows
    infected = (f_rows == news[None, :]).all(dim=1).cpu()
    local = fabric_n // n_devices
    # the distinct row must have crossed shard boundaries
    assert bool(infected[local:].any()), (
        "no cross-shard delivery over all_gather")

    # --- seq-reassembly fabric ------------------------------------------
    sq = SeqSyncParams(n_nodes=fabric_n, n_seqs=32, peers_per_round=2,
                       seqs_per_chunk=4, chunk_budget=3)
    bits = torch.zeros((fabric_n, 32), dtype=torch.bool, device=dev)
    bits[0] = True
    sstep = sharded_seq_sync_step(nodes_mesh, sq)
    s_state = convert.shard_state(SeqShard(bits, torch.zeros(fabric_n, **i32)),
                                  SeqShard(0, 0), nodes_mesh)
    for t in range(6):
        s_state = sstep(s_state, fold_in(key, 100 + t))
    holders = convert.unshard_state(s_state, SeqShard(0, 0)).bits.any(dim=1)
    assert bool(holders[local:].any()), "no cross-shard seq reassembly"

    # --- destination-sorted fabric (all_to_all ring schedule) -----------
    rstep = sharded_broadcast_step_ring(nodes_mesh, bp)
    r_state = convert.shard_state(leaves, layout, nodes_mesh)
    for t in range(8):
        r_state, overflow = rstep(r_state, fold_in(key, t))
    # lossless default cap: bitwise the all_gather fabric's trajectory
    assert overflow == 0
    assert torch.equal(convert.unshard_state(r_state, layout).rows, f_rows), (
        "ring fabric diverged from all_gather fabric")

    # --- mesh-native exact rejection sampler (bitmap row-sharded) -------
    exact_n = max(1024, n_devices * 512)
    ecfg = HeadlineExactConfig(
        n_nodes=exact_n, fanout=4, ring0_size=128, max_transmissions=8,
        loss=0.05, partition_blocks=2, heal_tick=2, sync_interval=2,
        max_ticks=16, chunk_ticks=4)
    e_seeds = 2
    e_base = [PRNGKey(21 + s) for s in range(e_seeds)]
    e_refs = [packed_exact_init(ecfg, fold_in(k, 2**20), device=dev)
              for k in e_base]
    e_state = convert.shard_state(
        packed_exact_init(ecfg, [fold_in(k, 2**20) for k in e_base],
                          device=dev), DENSE_LAYOUT, nodes_mesh)
    e_step = sharded_packed_exact_step(nodes_mesh, ecfg)
    for t in range(2):
        e_refs = [packed_exact_tick(r, fold_in(k, t), ecfg)
                  for r, k in zip(e_refs, e_base)]
        e_state = e_step(e_state, [fold_in(k, t) for k in e_base])
        got = convert.unshard_state(e_state, DENSE_LAYOUT)
        for s in range(e_seeds):
            assert torch.equal(got.infected[s], e_refs[s].infected[0]), (
                f"sharded exact infected diverged at tick {t}")
            assert torch.equal(got.msgs[s], e_refs[s].msgs[0]), (
                f"sharded exact msgs diverged at tick {t}")
    exact_frac = float(got.infected.float().mean())
    assert exact_frac > 0.0

    # --- HEADLINE-shape N over the seeds x nodes mesh (sharded walls) ---
    big_n = max(16384, nodes_ax * 2048)
    big_cfg = EpidemicConfig(
        n_nodes=big_n, n_rows=4, ring0_size=256, max_transmissions=8,
        loss=0.05, partition_blocks=2, heal_tick=4, sync_interval=4,
        track_hops=False, chunk_ticks=4)
    big_batched = batch_state(epidemic_init(big_cfg, device=dev), n_seeds)
    big_specs = epidemic_shardings(mesh, big_batched)
    big_keys = list(split(PRNGKey(5), n_seeds))
    big_step = sharded_epidemic_tick(mesh, big_cfg)
    big = big_step(shard_state(big_batched, mesh, big_specs), big_keys)
    sync()
    before = dict(fabric.bytes)
    t0 = time.perf_counter()
    for _ in range(4):
        big = big_step(big, big_keys)
    sync()
    wall_tick = (time.perf_counter() - t0) / 4
    tick_bytes = {k: (v - before.get(k, 0)) // 4
                  for k, v in fabric.bytes.items() if v != before.get(k, 0)}

    # the ring fabric at the same headline N over the nodes axis
    big_bp = BroadcastParams(n_nodes=big_n, fanout_ring0=2, fanout_global=2,
                             ring0_size=256, max_transmissions=8, loss=0.05)
    big_rows = DEFAULT_CODEC.pack(torch.ones((big_n, 4), **i32),
                                  torch.ones((big_n, 4), **i32),
                                  torch.zeros((big_n, 4), **i32))
    big_rows[0] = news
    big_tx = torch.zeros(big_n, **i32)
    big_tx[0] = 8
    # a reduced cap (half the lossless default): the capped packing path
    big_ring = sharded_broadcast_step_ring(
        nodes_mesh, big_bp, slot_cap=max(64, big_n // n_devices // 2))
    b_state = convert.shard_state(
        BroadcastShard(big_rows, big_tx, torch.zeros(big_n, **i32)), layout,
        nodes_mesh)
    b_state, ov = big_ring(b_state, PRNGKey(6))
    sync()
    t0 = time.perf_counter()
    for t in range(4):
        b_state, ov = big_ring(b_state, fold_in(key, 200 + t))
    sync()
    wall_ring = (time.perf_counter() - t0) / 4

    backend = (f"cuda ({torch.cuda.get_device_name(dev)})"
               if dev.type == "cuda" else dev.type)
    mesh_dict = dict(zip(MESH_AXES, mesh.shape))
    result = {"headline_shape": {
        "n_nodes": big_n, "n_seeds": n_seeds, "mesh": mesh_dict,
        "sharded_tick_wall_s": round(wall_tick, 4),
        "ring_fabric_tick_wall_s": round(wall_ring, 4),
        "ring_overflow_last_tick": int(ov),
        "sharded_tick_bytes": tick_bytes,
        "backend": backend,
        "note": (f"{n_devices} shards on one {dev.type} device (a "
                 "LocalFabric: the collectives are copies): the walls "
                 "validate the sharded step at headline shape, not "
                 "multi-card performance"),
    }}
    print(f"dryrun_multichip ok: mesh={mesh_dict}, epidemic "
          f"N={n_nodes} x seeds={n_seeds}, swim N={n_nodes}, "
          f"collective fabric N={fabric_n} over {n_devices} shards "
          f"(all_gather + destination-sorted ring, bitwise equal), "
          f"seq-reassembly N={fabric_n} x {sq.n_seqs} seqs, "
          f"sharded exact sampler N={exact_n} x seeds={e_seeds} "
          f"(bitwise vs single-device, infected {exact_frac:.2f})",
          flush=True)
    print(json.dumps(result), flush=True)
    result["fabric"] = {"bytes": dict(fabric.bytes),
                        "calls": dict(fabric.calls)}
    return result


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "multichip":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
    else:
        fn, args = entry()
        out = fn(*args)
        torch.cuda.synchronize()
        print("entry ok:", {f: tuple(x.shape) for f, x in
                            out._asdict().items() if torch.is_tensor(x)})
