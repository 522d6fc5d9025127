"""Where the time goes on the card, for the headline, the exact
column, anti-entropy and SWIM churn.

    python -m corrosion_tpu_torch.profile_tick

Times fourteen pieces of work: one chunk (16 ticks; the headline
converges within it) of the headline epidemic (100k nodes x 32 seeds)
from its initial state; the two full-width exact-sampler runs
(``run_exact_headline`` on ``sim.calibrate.EXACT_DENSE`` x 16 seeds and
``EXACT_SPARSE`` x 4 seeds, set-up and all chunks included); the first
chunk of two multi-device layouts over a ``LocalFabric`` on the card
from the initial state (host-sparse, the 10M-node headline config x 2
seeds on 2 hosts, 8 ticks; sharded-dense, ``EXACT_DENSE`` x 4 seeds
over 8 node shards, 16 ticks); the ring broadcast fabric's 12 ticks
(``ring_fabric_100k``: ``sharded_broadcast_step_ring`` at 100k nodes x
R = 8 over a ``LocalFabric`` of 8 shards from ``fabric_state``, as
``chip_smoke.py`` phase 18b runs it, ``route_pack`` 96 launches); the
whole
config #4 run (``run_anti_entropy_seeds``, 10k nodes x 32 seeds); the
first 32-tick chunk of the churn schedule at 64 (config #2) and 4096
nodes from the initial state; one seed of the calibration-scale exact
sampler at 16k nodes (``run_exact(ExactConfig(16000))``, the 16k point
of ``run_msgs_calibration``); the whole ``track_sent`` run of
``sim_trace``'s config at 512 nodes x 8 seeds; one full-width
``select_winners(backend="torch")`` call on a ``resync_batch`` of
2**20 changes (warm, interleaved; the plan is encoded untimed); and two
superseding waves of the device-resident apply (``CrConn`` with
``enable_device_cache()``, its table prefilled to the cache's 65,536
rows untimed): one steady wave of 10,000 changes over 2,500 hot rows
and one wave over all 65,536 rows (262,144 changes), each timed with its
``flush_barrier()``, as ``chip_smoke.py``'s apply phase streams them
(``apply_bench_changes``).  Each is
run first untimed to warm up, then ``REPS`` times with a host clock
around work that ends in ``torch.cuda.synchronize()``, then ``REPS``
times under ``torch.profiler``, each of those with its own host clock.
Prints one JSON object with an entry per piece: the unprofiled walls;
for each profiled run its wall, the device time summed over every
kernel the profiler saw in it, the device's busy time (the union of
those kernels' spans, which kernels chained by programmatic dependent
launch overlap) and its device idle share (1 - busy time / that same
wall); and, from the profiled run of median idle share, the device
time per kernel name with its launches and its share of the busy
time (a chained kernel's time past the one before it).
``--pieces a,b`` runs the named pieces only; ``--parent DIR`` (DIR an
unpacked checkout of the parent commit) runs them on DIR's package and
on this one in turns, parent, change, change, parent, each in its own
process.  Needs a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from corrosion_tpu_torch import kernels, resolve_device
from corrosion_tpu_torch.convert import shard_state
from corrosion_tpu_torch.mesh import LocalFabric, Mesh
from corrosion_tpu_torch.ops import merge
from corrosion_tpu_torch.models import sharded
from corrosion_tpu_torch.models.broadcast import BroadcastParams
from corrosion_tpu_torch.models.swim import swim_init
from corrosion_tpu_torch.random import PRNGKey, fold_in
from corrosion_tpu_torch.sim import antientropy, calibrate, churn
from corrosion_tpu_torch.sim.epidemic import (
    HEADLINE,
    HEADLINE_SEEDS,
    EpidemicConfig,
    _scan_chunk,
    epidemic_init,
    run_epidemic_seeds,
    sent_trace_cfg,
)


REPS = 5
WINNERS_N = 1 << 20  # changes in the full-width winners batch
# value columns as tests/test_merge_columnar.py draws them (every type)
RESYNC_VALUES = (None, 1, -4, 2.5, "x", b"\x01", "yy", "")
ACTIVITIES = (torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA)
# the broadcast fabrics at the headline's width (chip_smoke.py phase
# 18b): one 100k-node universe, R = 8, fanout 2 + 2, ring0 256, 5% loss,
# over 8 node shards, 12 ticks
FABRIC_N, FABRIC_R, FABRIC_D, FABRIC_TICKS = 100_000, 8, 8, 12


def _busy_ms(prof):
    """Device ms during which some kernel, copy or fill ran: the union of
    the device events' spans; and {name: its share of that union}, the
    parts of its spans that no earlier-starting span covers.  Kernels
    under programmatic dependent launch start before the one they wait
    on ends, so the sum of their times counts that overlap twice; a
    chained kernel's share is its time past the one before it."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end, share = 0.0, -float("inf"), {}
    for start, stop, name in spans:
        if stop > end:
            part = stop - max(start, end)
            busy += part
            share[name] = share.get(name, 0.0) + part
            end = stop
    return busy / 1e3, {k: v / 1e3 for k, v in share.items()}


def _timed(prepare, profiled: bool):
    """Wall seconds of the work ``prepare()`` returns (``prepare``
    itself untimed) and, when ``profiled``, {kernel name: device ms,
    launches and busy ms} and the device's busy ms (``_busy_ms``)."""
    work = prepare()
    torch.cuda.synchronize()
    prof = (torch.profiler.profile(activities=list(ACTIVITIES))
            if profiled else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not profiled:
        return wall, None, None
    busy_ms, share = _busy_ms(prof)
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us > 0:
            kernels[e.key] = {"device_ms": us / 1e3, "launches": e.count,
                              "busy_ms": share.get(e.key, 0.0)}
    return wall, kernels, busy_ms


def profile(prepare, **meta) -> dict:
    resolve_device("cuda")
    _timed(prepare, profiled=False)
    walls = [_timed(prepare, profiled=False)[0] * 1e3 for _ in range(REPS)]
    runs = []
    for _ in range(REPS):
        wall, kernels, busy_ms = _timed(prepare, profiled=True)
        device_ms = sum(k["device_ms"] for k in kernels.values())
        runs.append((1.0 - busy_ms / (wall * 1e3), wall * 1e3, device_ms,
                     busy_ms, kernels))
    runs.sort(key=lambda r: r[0])
    idle, wall_ms, device_ms, busy_ms, kernels = runs[len(runs) // 2]
    return {
        "device": torch.cuda.get_device_name(0), **meta,
        "wall_ms_unprofiled": walls,
        "profiled": [{"wall_ms": r[1], "device_ms": r[2], "busy_ms": r[3],
                      "idle_share": r[0]} for r in runs],
        "median": {"wall_ms": wall_ms, "device_ms": device_ms,
                   "busy_ms": busy_ms, "idle_share": idle},
        "kernels": dict(sorted(kernels.items(),
                               key=lambda kv: -kv[1]["device_ms"])),
    }


def headline_chunk(cfg: EpidemicConfig):
    """One chunk of ``cfg`` from its initial state (made untimed)."""
    def prepare():
        state = epidemic_init(cfg, device="cuda")
        return lambda: _scan_chunk(state, PRNGKey(0), state.rows[0], cfg)
    return prepare


def exact_run(cfg, seeds: int, kernel: str):
    """A whole ``run_exact_headline`` call."""
    def prepare():
        return lambda: calibrate.run_exact_headline(
            cfg, n_seeds=seeds, kernel=kernel, device="cuda")
    return prepare


def mesh_chunk(cfg, seeds: int, axis: str, shards: int, sparse: bool,
               host: bool):
    """One chunk of a multi-device layout over a ``LocalFabric`` of
    ``shards`` on the card, from the initial state (made and laid out
    untimed)."""
    def prepare():
        mesh = Mesh(axis, LocalFabric(shards, "cuda"))
        base = [PRNGKey(s) for s in range(seeds)]
        if host:
            leaves, chunk = (calibrate.HOST_LAYOUT,
                             sharded.make_sharded_frontier_host_chunk(mesh,
                                                                      cfg))
        elif sparse:
            leaves, chunk = (calibrate.FRONTIER_LAYOUT,
                             sharded.make_sharded_frontier_chunk(mesh, cfg))
        else:
            leaves, chunk = (calibrate.DENSE_LAYOUT,
                             calibrate.make_sharded_exact_chunk(mesh, cfg))
        init = (calibrate.frontier_exact_init if sparse
                else calibrate.packed_exact_init)
        state = shard_state(init(cfg, [fold_in(k, 2**20) for k in base],
                                 device="cuda"), leaves, mesh)
        diags = {sh: calibrate._zero_diag(mesh.device)
                 for sh in mesh.local_shards}
        return lambda: chunk(state, base, diags)
    return prepare


def fabric_params() -> BroadcastParams:
    return BroadcastParams(n_nodes=FABRIC_N, fanout_ring0=2,
                           fanout_global=2, ring0_size=256,
                           max_transmissions=8, loss=0.05)


def fabric_state(dev):
    """The broadcast fabrics' start: every node's R keys from a seed,
    the writer's ahead of everyone's and budgets on a third of the
    nodes (active senders on every shard)."""
    g = torch.Generator(device="cpu").manual_seed(17)
    rows = torch.randint(0, 1 << 20, (FABRIC_N, FABRIC_R), generator=g,
                         dtype=torch.int32)
    rows[0] += 1 << 22
    tx = torch.where(torch.rand(FABRIC_N, generator=g) < 0.33,
                     torch.randint(1, 9, (FABRIC_N,), generator=g), 0)
    tx[0] = 8
    return (rows.to(dev), tx.to(torch.int32).to(dev),
            torch.zeros(FABRIC_N, dtype=torch.int32, device=dev))


def ring_fabric_run():
    """The ring broadcast fabric's ``FABRIC_TICKS`` ticks over a
    ``LocalFabric`` of ``FABRIC_D`` shards on the card from
    ``fabric_state`` (made and laid out untimed)."""
    def prepare():
        mesh = Mesh("nodes", LocalFabric(FABRIC_D, "cuda"))
        state = shard_state(sharded.BroadcastShard(*fabric_state("cuda")),
                            sharded.BroadcastShard(0, 0, 0), mesh)
        step = sharded.sharded_broadcast_step_ring(mesh, fabric_params())

        def work():
            st = state
            for t in range(FABRIC_TICKS):
                st, _ = step(st, fold_in(PRNGKey(8), t))
        return work
    return prepare


def anti_entropy_run(cfg, seeds: int):
    """A whole ``run_anti_entropy_seeds`` call."""
    def prepare():
        return lambda: antientropy.run_anti_entropy_seeds(
            cfg, n_seeds=seeds, device="cuda")
    return prepare


def churn_chunk(cfg):
    """The first chunk of ``cfg``'s churn schedule from the initial
    state (made untimed)."""
    def prepare():
        state = swim_init(cfg.n_nodes, device="cuda")
        return lambda: churn._scan_chunk(state, PRNGKey(0), 0, cfg)
    return prepare


def calib_seed(cfg):
    """A whole ``run_exact`` call (one seed, host fetch a tick)."""
    def prepare():
        return lambda: calibrate.run_exact(cfg, seed=0, device="cuda")
    return prepare


def track_sent_run(cfg, seeds: int):
    """A whole ``run_epidemic_seeds`` call on a ``track_sent`` config."""
    def prepare():
        return lambda: run_epidemic_seeds(cfg, n_seeds=seeds, seed=0,
                                          device="cuda")
    return prepare


def resync_batch(n: int = WINNERS_N, interleaved: bool = True,
                 warm: bool = True, seed: int = 0):
    """``(records, seed_cls, seed_cells)`` of one table batch for
    ``merge.encode_changes``: a full resync of a table of n / 4 rows x 4
    columns (APPLY_BENCH's shape), each row's changes together
    (pk-grouped) or in a seeded shuffle (``interleaved``).  A change is
    a row sentinel with probability 1/4, else a cell change of a random
    column; cl in 1..5, col_version in 1..4, values of every type, as
    tests/test_merge_columnar.py draws them.  ``warm`` gives every row
    a pre-batch causal length in 1..4 and about half the cells a clock
    seed (col_version 1..4, a value); cold gives none."""
    rng = np.random.default_rng(seed)
    rows = n // 4
    pk = np.repeat(np.arange(rows), 4)[:n]
    sentinel = rng.random(n) < 0.25
    cid = rng.integers(0, 4, n)
    cl = rng.integers(1, 6, n)
    ver = rng.integers(1, 5, n)
    val = rng.integers(0, len(RESYNC_VALUES), n)
    if interleaved:
        perm = rng.permutation(n)
        pk, sentinel, cid, cl, ver, val = (
            a[perm] for a in (pk, sentinel, cid, cl, ver, val))
    cols = [f"c{c}" for c in range(4)]
    records = [
        (p, None, c, 0, None) if s else (p, cols[ci], c, v, RESYNC_VALUES[x])
        for p, s, ci, c, v, x in zip(pk.tolist(), sentinel.tolist(),
                                     cid.tolist(), cl.tolist(), ver.tolist(),
                                     val.tolist())
    ]
    if not warm:
        return records, {}, {}
    seed_cls = dict(zip(range(rows), rng.integers(1, 5, rows).tolist()))
    cells = np.flatnonzero(rng.random(rows * 4) < 0.5)
    sver = rng.integers(1, 5, cells.size).tolist()
    sval = rng.integers(0, 3, cells.size).tolist()
    seed_cells = {
        (c // 4, cols[c % 4]): (v, (None, 1, "z")[x])
        for c, v, x in zip(cells.tolist(), sver, sval)
    }
    return records, seed_cls, seed_cells


def winners_call(plan):
    """One ``select_winners(backend="torch")`` call on the card."""
    def prepare():
        return lambda: merge.select_winners(plan, backend="torch",
                                            device="cuda")
    return prepare


def apply_bench_changes(n: int, site: bytes, col_version: int,
                        row_offset: int = 0) -> list:
    """``n`` cell changes over ``n // 4`` rows x 4 cells (bench.py
    ``_apply_bench_changes``, copied onto this package's types): rows
    ``row_offset`` on, every cell at ``col_version``, causal length 1,
    text values."""
    from corrosion_tpu_torch.agent.pack import pack_values
    from corrosion_tpu_torch.types.base import CrsqlDbVersion, CrsqlSeq
    from corrosion_tpu_torch.types.change import Change

    changes = []
    seq = 0
    for r in range(row_offset, row_offset + max(1, n // 4)):
        pk = pack_values([r])
        for cid in ("a", "b", "c", "d"):
            changes.append(Change(
                table="bench", pk=pk, cid=cid,
                val=f"v{col_version}-{r}-{cid}",
                col_version=col_version,
                db_version=CrsqlDbVersion(col_version),
                seq=CrsqlSeq(seq), site_id=site, cl=1,
            ))
            seq += 1
            if len(changes) >= n:
                return changes
    return changes


APPLY_SITE = b"\x42" * 16
APPLY_ROWS = 65_536  # the default cache's rows (DEFAULT_SLOTS // 4)


def bench_conn(path: str, cache=None):
    """A ``CrConn`` at ``path`` with bench.py's apply table and a
    metrics registry; ``cache`` given (``enable_device_cache``'s
    arguments, ``{}`` for its defaults) switches on the device-resident
    path, ``None`` keeps the plain batched one."""
    from corrosion_tpu_torch.agent.metrics import Metrics
    from corrosion_tpu_torch.agent.storage import CrConn

    db = CrConn(path, site_id=b"\x77" * 16)  # one own site: comparable
    db.conn.execute("CREATE TABLE IF NOT EXISTS bench ("
                    " id INTEGER PRIMARY KEY NOT NULL, a, b, c, d)")
    db.as_crr("bench")
    db.metrics = Metrics()
    if cache is not None:
        db.enable_device_cache(**cache)
    return db


def apply_waves(path: str, n: int):
    """Superseding waves of ``n`` changes (``n // 4`` hot rows) through
    the device-resident apply on the card, its table prefilled to
    ``APPLY_ROWS`` rows (and flushed) once, untimed; each wave's
    changes are made untimed, at the next col_version."""
    db = bench_conn(path, cache={})
    if db.device_cache.backend != "torch":
        raise RuntimeError("the device cache is not on the card")
    db.apply_changes_batched(apply_bench_changes(4 * APPLY_ROWS, APPLY_SITE,
                                                 col_version=1))
    db.flush_barrier()
    version = [1]

    def prepare():
        version[0] += 1
        wave = apply_bench_changes(n, APPLY_SITE, col_version=version[0])

        def work():
            db.apply_changes_batched(wave)
            db.flush_barrier()
        return work
    return prepare


def _devcache(label: str, n: int) -> dict:
    with tempfile.TemporaryDirectory(prefix="devcache-",
                                     dir=kernels.BUILD_DIR) as d:
        return profile(apply_waves(f"{d}/{label}.db", n), changes=n,
                       rows=n // 4, cached_rows=APPLY_ROWS)


def pieces() -> dict:
    """{name: () -> the piece's ``profile`` entry}, in the order a run
    without ``--pieces`` takes them."""
    cfg = replace(HEADLINE, n_universes=HEADLINE_SEEDS)
    table = {"headline_chunk": lambda: profile(
        headline_chunk(cfg), nodes=cfg.n_nodes, seeds=cfg.n_universes,
        ticks=cfg.chunk_ticks)}
    for label, ecfg, seeds, kernel in (
        ("exact_dense_100k", calibrate.EXACT_DENSE,
         calibrate.EXACT_DENSE_SEEDS, "dense"),
        ("exact_sparse_1m", calibrate.EXACT_SPARSE,
         calibrate.EXACT_SPARSE_SEEDS, "sparse"),
    ):
        table[label] = (lambda e=ecfg, s=seeds, k=kernel: profile(
            exact_run(e, s, k), nodes=e.n_nodes, seeds=s, kernel=k))
    for label, ecfg, seeds, axis, shards, sparse, host in (
        ("host_sparse_10m_chunk",
         calibrate.headline_exact_cfg(10_000_000, False), 2, "hosts", 2,
         True, True),
        ("sharded_dense_100k_chunk", calibrate.EXACT_DENSE, 4, "nodes", 8,
         False, False),
    ):
        table[label] = (
            lambda e=ecfg, s=seeds, a=axis, d=shards, sp=sparse, h=host:
            profile(mesh_chunk(e, s, a, d, sp, h), nodes=e.n_nodes,
                    seeds=s, shards=d, axis=a, ticks=e.chunk_ticks))
    table["ring_fabric_100k"] = lambda: profile(
        ring_fabric_run(), nodes=FABRIC_N, shards=FABRIC_D,
        ticks=FABRIC_TICKS)
    table["anti_entropy_config4"] = lambda: profile(
        anti_entropy_run(antientropy.CONFIG4, antientropy.CONFIG4_SEEDS),
        nodes=antientropy.CONFIG4.n_nodes, seeds=antientropy.CONFIG4_SEEDS)
    for n in (64, 4096):
        table[f"churn_{n}_chunk"] = (lambda c=churn.ChurnConfig(n_nodes=n):
                                     profile(churn_chunk(c), nodes=c.n_nodes,
                                             ticks=c.chunk_ticks))
    ecfg = calibrate.ExactConfig(16_000)
    table["calib_exact_16k"] = lambda: profile(
        calib_seed(ecfg), nodes=ecfg.n_nodes, seeds=1)
    table["track_sent_512"] = lambda: profile(
        track_sent_run(sent_trace_cfg(512), 8), nodes=512, seeds=8)

    def winners():
        plan = merge.encode_changes(*resync_batch())
        return profile(winners_call(plan), changes=plan.n, rows=plan.n_pk,
                       cells=plan.n_cid)

    table["winners_1m"] = winners
    for label, n in (("devcache_steady_wave", 10_000),
                     ("devcache_full_wave", 4 * APPLY_ROWS)):
        table[label] = lambda label=label, n=n: _devcache(label, n)
    return table


def in_turns(parent: str, names: list) -> list:
    """The named pieces on the package of the checkout ``parent`` and
    on this one in turns (parent, change, change, parent), each run in
    its own process from its checkout's root by this file."""
    here = str(Path(__file__).resolve().parent.parent)
    code = ("import runpy, sys; from corrosion_tpu_torch import kernels; "
            "kernels.build(); sys.argv = ['profile_tick', '--pieces', "
            f"{','.join(names)!r}]; runpy.run_path({__file__!r}, "
            "run_name='__main__')")
    runs = []
    for tree, root in (("parent", parent), ("change", here),
                       ("change", here), ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"profile_tick on the {tree} tree failed:\n"
                               f"{res.stderr[-4000:]}")
        runs.append({"tree": tree, **json.loads(
            res.stdout.strip().splitlines()[-1])})
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pieces", help="comma-separated piece names "
                    "(default: every piece)")
    ap.add_argument("--parent", help="a checkout of the parent commit: "
                    "profile the pieces on it and on this tree in turns")
    opts = ap.parse_args()
    table = pieces()
    names = opts.pieces.split(",") if opts.pieces else list(table)
    unknown = sorted(set(names) - set(table))
    if unknown:
        ap.error(f"unknown pieces {unknown}; known: {list(table)}")
    if opts.parent:
        print(json.dumps({"in_turns": in_turns(opts.parent, names)}))
        return 0
    print(json.dumps({name: table[name]() for name in names}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
