"""The shard fabric over ``torch.distributed``: 2 and 4 gloo ranks on
the CPU, each a spawned process running one shard through a
``DistFabric``, against the same run over a ``LocalFabric`` in this
process — every shard's leaves after every step bitwise equal, the
overflow counts and ``run_exact_headline``'s results equal, and the
ranks' byte counters summing to the local fabric's.

Covered: the exact sampler's dense, frontier and multi-host layouts,
the all_gather and ring broadcast fabrics (the ring also at a starved
cap) and the seq-sync fabric; and over 4 ranks as a ``("seeds",
"nodes")`` mesh of 2 x 2 (one process group a seeds row), the sharded
epidemic tick and the sharded SWIM step through a churn schedule.  The ranks rendezvous through a file in
the test's temporary directory, import only torch and the port, and
each test fails when its own timeout runs out.
"""

import os
import time

import pytest
import torch
import torch.multiprocessing as mp

from corrosion_tpu_torch import convert, entry
from corrosion_tpu_torch.mesh import (
    MESH_AXES,
    DistFabric,
    ForeignLeafError,
    LocalFabric,
    Mesh,
    all_gather,
)
from corrosion_tpu_torch.models import broadcast as tb
from corrosion_tpu_torch.models import sharded as ts
from corrosion_tpu_torch.models import sync as tsync
from corrosion_tpu_torch.models.swim import SwimParams, swim_init
from corrosion_tpu_torch.random import PRNGKey, fold_in, split
from corrosion_tpu_torch.sim import calibrate as tc
from corrosion_tpu_torch.sim.churn import ChurnConfig, _schedule
from corrosion_tpu_torch.sim.epidemic import EpidemicConfig, epidemic_init

N = 256
TIMEOUT_S = 150
EXACT = dict(n_nodes=N, fanout=4, ring0_size=64, max_transmissions=8,
             loss=0.05, partition_blocks=2, heal_tick=3, sync_interval=2,
             backoff_ticks=0.5, max_ticks=16, chunk_ticks=8)


def _snap(state) -> dict:
    """{shard: its leaves} of the shards this process holds."""
    return {sh: tuple(x.clone() if torch.is_tensor(x) else x
                      for x in state[sh]) for sh in state.shards()}


def _scenario(fabric) -> dict:
    """Every layout and fabric over ``fabric``, recording the held
    shards after each step (the same code for a local and a
    distributed fabric)."""
    out = {}
    nodes, hosts = Mesh("nodes", fabric), Mesh("hosts", fabric)
    base = [PRNGKey(21), PRNGKey(22)]
    cfg = tc.HeadlineExactConfig(**EXACT)
    for name, mesh, sparse, host in (("dense", nodes, False, False),
                                     ("frontier", nodes, True, False),
                                     ("host", hosts, True, True)):
        layout = tc._layout(mesh, cfg, sparse, host)
        init = tc.frontier_exact_init if sparse else tc.packed_exact_init
        state = convert.shard_state(
            init(cfg, [fold_in(k, 2**20) for k in base], device="cpu"),
            layout.leaves, mesh)
        step = tc._mesh_step(mesh, cfg, layout)
        for t in range(4):
            state = step(state, [fold_in(k, t) for k in base])
            out[f"{name} tick {t}"] = _snap(state)
    run = tc.run_exact_headline(cfg, n_seeds=2, kernel="sparse",
                                host_sharded=True, mesh=hosts)
    out["run"] = {k: v for k, v in run.items()
                  if k not in ("wall_s", "fabric", "budget_bytes")}

    rows = (torch.arange(N * 4, dtype=torch.int32).reshape(N, 4) * 7919
            ) % 100_000
    rows[0] += 200_000
    tx = torch.zeros(N, dtype=torch.int32)
    tx[0] = 4
    tx[N // 2:N // 2 + 40] = 3  # active senders past the first shard
    leaves = ts.BroadcastShard(rows, tx, torch.zeros(N, dtype=torch.int32))
    params = tb.BroadcastParams(n_nodes=N, fanout_ring0=1, fanout_global=2,
                                ring0_size=16, max_transmissions=4,
                                loss=0.1)
    for name, step in (
            ("all_gather", ts.sharded_broadcast_step(nodes, params)),
            ("ring", ts.sharded_broadcast_step_ring(nodes, params)),
            ("ring cap 2", ts.sharded_broadcast_step_ring(nodes, params, 2))):
        state = convert.shard_state(leaves, ts.BroadcastShard(0, 0, 0), nodes)
        for t in range(3):
            state = step(state, fold_in(PRNGKey(5), t))
            if name != "all_gather":
                state, out[f"{name} overflow {t}"] = state
            out[f"{name} tick {t}"] = _snap(state)

    bits = torch.zeros((N, 32), dtype=torch.bool)
    bits[0] = True
    bits[N - 3, :16] = True
    seq = convert.shard_state(
        ts.SeqShard(bits, torch.zeros(N, dtype=torch.int32)),
        ts.SeqShard(0, 0), nodes)
    seq_step = ts.sharded_seq_sync_step(nodes, tsync.SeqSyncParams(
        n_nodes=N, n_seqs=32, peers_per_round=2, seqs_per_chunk=4,
        chunk_budget=3, loss=0.1))
    for t in range(3):
        seq = seq_step(seq, fold_in(PRNGKey(9), t))
        out[f"seq tick {t}"] = _snap(seq)

    def nosy(sh, st):
        other = seq[(sh + 1) % nodes.size]
        got = yield all_gather(st.msgs + other.msgs, "nosy")
        return got

    try:
        nodes.run(nosy, {sh: (seq[sh],) for sh in nodes.local_shards})
        out["foreign read refused"] = False
    except ForeignLeafError:
        out["foreign read refused"] = True
    out["bytes"] = dict(fabric.bytes)
    return out


def _two_axis_scenario(fabric) -> dict:
    """The epidemic tick (4 seeds x 64 nodes) and the SWIM step (32
    nodes, a churn schedule) on a ("seeds", "nodes") mesh of 2 x 2 over
    ``fabric``, recording the held shards after each step."""
    out = {}
    mesh = Mesh(MESH_AXES, fabric, (2, 2))
    cfg = EpidemicConfig(n_nodes=64, n_rows=4, ring0_size=16, loss=0.05,
                         partition_blocks=2, heal_tick=2, sync_interval=2)
    batched = entry.batch_state(epidemic_init(cfg, device="cpu"), 4)
    specs = entry.epidemic_shardings(mesh, batched)
    state = entry.shard_state(batched, mesh, specs)
    step = ts.sharded_epidemic_tick(mesh, cfg)
    base = list(split(PRNGKey(7), 4))
    for t in range(4):
        state = step(state, [fold_in(k, t) for k in base])
        out[f"epidemic tick {t}"] = _snap(state)
    churn = ChurnConfig(n_nodes=32, cycles=1, kill_tick=1, revive_tick=7)
    params = SwimParams.scaled(32, loss=0.1, suspect_timeout=2)
    sw = swim_init(32, device="cpu")
    sw_specs = entry.swim_shardings(mesh, sw)
    sw = entry.shard_state(sw, mesh, sw_specs)
    swim = ts.sharded_swim_step(mesh, params)
    flags = torch.zeros(2, dtype=torch.int32)
    for t in range(10):
        victim, dead, rev = _schedule(churn, t)
        alive = torch.ones(32, dtype=torch.bool)
        alive[victim] = not dead
        revived = torch.zeros(32, dtype=torch.bool)
        revived[victim] = rev
        sw = swim(sw, fold_in(PRNGKey(9), t), t, alive, revived,
                  victim=victim, flags=flags)
        out[f"swim tick {t}"] = _snap(sw)
    out["swim flags"] = flags.tolist()
    out["bytes"] = dict(fabric.bytes)
    return out


SCENARIOS = {"one_axis": _scenario, "two_axes": _two_axis_scenario}


def _rank_main(rank, world, init_file, out_dir, scenario="one_axis"):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = SCENARIOS[scenario](DistFabric(device="cpu"))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp_path, scenario="one_axis"):
    ctx = mp.start_processes(
        _rank_main, args=(world, str(tmp_path / "rendezvous"),
                          str(tmp_path), scenario),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"{world} gloo ranks still running after "
                            f"{TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_equal_the_local_fabric(world, tmp_path):
    local = _scenario(LocalFabric(world, "cpu"))
    ranks = _spawn(world, tmp_path)
    assert local["foreign read refused"]
    steps = [k for k in local if "tick" in k]
    assert len(steps) == 3 * 4 + 3 * 3 + 3
    for rank, got in enumerate(ranks):
        assert got["foreign read refused"], rank
        assert got["run"] == local["run"], rank
        for k in steps:
            assert list(got[k]) == [rank], k
            for a, b in zip(got[k][rank], local[k][rank]):
                if torch.is_tensor(a):
                    assert torch.equal(a, b), (rank, k)
                else:
                    assert a == b, (rank, k)
        for k in local:
            if "overflow" in k:
                assert got[k] == local[k], (rank, k)
    assert local["ring cap 2 overflow 0"] > 0
    assert local["run"]["converged_frac"] == 1.0
    kinds = set(local["bytes"])
    for got in ranks:
        assert set(got["bytes"]) == kinds
    for kind in kinds:
        assert sum(got["bytes"][kind] for got in ranks) == (
            local["bytes"][kind]), kind


def test_gloo_two_axes_equal_the_local_fabric(tmp_path):
    """4 gloo ranks as a 2 x 2 ("seeds", "nodes") mesh: every shard of
    the sharded epidemic tick and SWIM step after every step bitwise
    the LocalFabric's, the churn flags equal, the bytes summing per
    kind."""
    local = _two_axis_scenario(LocalFabric(4, "cpu"))
    ranks = _spawn(4, tmp_path, "two_axes")
    steps = [k for k in local if "tick" in k]
    assert len(steps) == 4 + 10
    for rank, got in enumerate(ranks):
        assert got["swim flags"] == local["swim flags"], rank
        for k in steps:
            assert list(got[k]) == [rank], k
            for a, b in zip(got[k][rank], local[k][rank]):
                if torch.is_tensor(a):
                    assert torch.equal(a, b), (rank, k)
                else:
                    assert a == b, (rank, k)
    assert local["swim flags"][0] > 0  # the victim was marked down
    kinds = set(local["bytes"])
    assert {"rows", "hops", "sync", "swim_select", "swim_flags"} <= kinds
    for got in ranks:
        assert set(got["bytes"]) == kinds
    for kind in kinds:
        assert sum(got["bytes"][kind] for got in ranks) == (
            local["bytes"][kind]), kind
