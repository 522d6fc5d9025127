"""The exact sampler's three multi-device layouts in the port against
the reference's on the 8-device virtual JAX mesh.

Per tick and bitwise on every leaf (bitmap or ring included): the
port's dense, frontier and multi-host layouts over a ``LocalFabric`` of
8 shards against ``sharded_packed_exact_step``,
``sharded_frontier_exact_step`` and ``sharded_frontier_host_step`` on
the headline shape and the topology families, and against the port's
single-device ticks, with the fabric's bytes per tick against the
reference's collectives; a seeded corruption of one shard (away from
shard 0) that must break the lockstep; a tick with an empty frontier;
then
``run_exact_headline(mesh=...)`` against the reference's on the same
mesh, and the entry point's refusals.

Run as a script, it is the reference's witness for a host-sparse run's
msgs statistics at a size the tests do not reach:

    python -m tests.test_torch_sharded_exact MSGS.npz

reads the per-node msgs that ``chip_smoke.py`` writes to
``corrosion_tpu_torch/kernels/build/host_msgs_10m.npz`` (each seed's
[N] msgs at its convergence tick) and prints, as one JSON object, the
per-seed float32 mean and p99 that the reference's
``make_sharded_frontier_host_chunk`` computes over them on a CPU mesh of
the run's host count (its gather over ``hosts``, then ``jnp.mean`` and
``jnp.percentile``, inside a scan), beside the exact means.  With
``--reference-run N`` it runs the reference's host-sparse layout itself
at N nodes x 2 seeds on 2 CPU hosts (bench.py's config and seeds, as
``BENCH_FRONTIER.json``'s headline was made at N = 10,000,000) and
prints its statistics.
"""

if __name__ == "__main__":  # the script: the 8-device CPU mesh first
    import tests.conftest  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from corrosion_tpu.models import sharded as js
from corrosion_tpu.sim import calibrate as jc
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.kernels import exact_send as es
from corrosion_tpu_torch.mesh import LocalFabric, Mesh
from corrosion_tpu_torch.models import sharded as ts
from corrosion_tpu_torch.sim import calibrate as tc
from tests.test_torch_exact import DENSE_FIELDS, _cfgs, _tkeys
from tests.test_torch_frontier import RUN_KEYS

D = 8
SEEDS = (11, 12)
UNPARTITIONED = dict(partition_blocks=1, heal_tick=0)
FAMILIES = {
    "headline": {},
    "het_ring": dict(topology="het_ring", **UNPARTITIONED),
    "wan_two_region": dict(topology="wan_two_region", **UNPARTITIONED),
    "wan_latency": dict(topology="wan_two_region", wan_cross_loss=0.0,
                        wan_latency_ticks=2, **UNPARTITIONED),
}
# layout: (reference step, reference shardings, axis, port step, memory)
LAYOUTS = {
    "dense": (jc.sharded_packed_exact_step, jc.exact_shardings, "nodes",
              tc.sharded_packed_exact_step, "sent"),
    "frontier": (js.sharded_frontier_exact_step, jc.frontier_shardings,
                 "nodes", ts.sharded_frontier_exact_step, "ring"),
    "host": (js.sharded_frontier_host_step, jc.frontier_host_shardings,
             "hosts", ts.sharded_frontier_host_step, "ring"),
}
TICKS = 4


def _layout_of(name):
    return {"dense": tc.DENSE_LAYOUT, "frontier": tc.FRONTIER_LAYOUT,
            "host": tc.HOST_LAYOUT}[name]


class Lockstep:
    """One layout in both packages and the port's single device, from
    the same init keys."""

    def __init__(self, name, n=256, **over):
        self.name = name
        self.jstep_of, shardings, axis, tstep_of, self.memory = LAYOUTS[name]
        self.jcfg, self.tcfg = _cfgs(n=n, **over)
        sparse = name != "dense"
        jinit = jc.frontier_exact_init if sparse else jc.packed_exact_init
        tinit = tc.frontier_exact_init if sparse else tc.packed_exact_init
        self.single_tick = (tc.frontier_exact_tick if sparse
                            else tc.packed_exact_tick)
        self.base = [jax.random.PRNGKey(s) for s in SEEDS]
        init_keys = [jax.random.fold_in(k, 2**20) for k in self.base]
        jmesh = JaxMesh(np.array(jax.devices()[:D]), (axis,))
        self.ref = jax.device_put(
            jax.vmap(lambda k: jinit(self.jcfg, k))(jnp.stack(init_keys)),
            shardings(jmesh))
        self.jstep = self.jstep_of(jmesh, self.jcfg)
        self.mesh = Mesh(axis, LocalFabric(D, "cpu"))
        self.layout = _layout_of(name)
        self.port = convert.shard_state(
            tinit(self.tcfg, _tkeys(init_keys), device="cpu"), self.layout,
            self.mesh)
        self.single = tinit(self.tcfg, _tkeys(init_keys), device="cpu")
        self.step = tstep_of(self.mesh, self.tcfg)
        self.t = 0

    def advance(self, check=True, diag=None):
        """One tick of all three; ``diag`` takes the single-device
        tick's rejection counters."""
        keys = [jax.random.fold_in(k, self.t) for k in self.base]
        self.ref = self.jstep(self.ref, jnp.stack(keys))
        self.port = self.step(self.port, _tkeys(keys))
        self.single = self.single_tick(self.single, _tkeys(keys), self.tcfg,
                                       diag=diag)
        self.t += 1
        if check:
            self.check()

    def check(self):
        got = convert.unshard_state(self.port, self.layout)
        for f in DENSE_FIELDS + (self.memory,):
            g = getattr(got, f).numpy()
            np.testing.assert_array_equal(
                g, np.asarray(getattr(self.ref, f)),
                err_msg=f"{self.name} tick {self.t}: {f} vs the reference")
            np.testing.assert_array_equal(
                g, getattr(self.single, f).numpy(),
                err_msg=f"{self.name} tick {self.t}: {f} vs one device")


def _tick_wire(run, name, rounds: int, active: bool, sync: bool):
    """(the port's, the reference's) bytes of one tick by kind: each
    still-bad round one all_gather of S x N bools (the host layout:
    bits), ``rounds`` of them (the tick's most rejection rounds); the
    dense layout adds its active mask, and its infected mask on sync
    ticks (the reference: every tick, and at least one round)."""
    s, n = len(SEEDS), run.tcfg.n_nodes
    row = (s * n // 8 if name == "host" else s * n) * (D - 1)
    delta = rounds if active else 0
    if name == "host":
        want = {"delta": row * (1 + delta)}
        return want, want
    if name == "frontier":
        want = {"delta": row * delta}
        return want, want
    want = {"active": row, "delta": row * delta,
            "infected": row if sync else 0}
    return want, {"active": row, "delta": row * max(1, rounds),
                  "infected": row}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_matches_reference_and_one_device_bitwise(name, family):
    """Every leaf per tick against the reference's layout and the
    port's single device; and what crossed the fabric that tick
    against the reference's collectives for the same tick: only masks
    (no bitmap row, ring row or tuple), no more bytes."""
    run = Lockstep(name, **FAMILIES[family])
    run.check()
    for _ in range(TICKS):
        sync = run.t % run.tcfg.sync_interval == run.tcfg.sync_interval - 1
        before = dict(run.mesh.fabric.bytes)
        diag = torch.zeros(4, dtype=torch.int64)
        run.advance(diag=diag)
        moved = {k: v - before.get(k, 0)
                 for k, v in run.mesh.fabric.bytes.items()}
        want, ref = _tick_wire(run, name, int(diag[2]), int(diag[0]) > 0,
                               sync)
        assert {k: v for k, v in moved.items() if v} == {
            k: v for k, v in want.items() if v}, f"tick {run.t - 1}"
        assert sum(moved.values()) <= sum(ref.values())
    assert np.asarray(run.ref.infected).sum() > 64  # real spread


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_corrupted_shard_breaks_the_lockstep(name):
    """Negative control: once shard 3 owns a sender with budget left,
    silence it (its remaining budget zeroed in the port only: on its shard,
    or in every replica where tx is replicated).  Its sends stop, so the
    lockstep must fail within a few ticks."""
    run = Lockstep(name, loss=0.0, **UNPARTITIONED)
    n_local = run.tcfg.n_nodes // D
    run.advance()
    while not np.asarray(run.ref.tx)[0, 3 * n_local:4 * n_local].any():
        run.advance()
    tx = np.asarray(run.ref.tx)[0]
    row = 3 * n_local + int(np.flatnonzero(tx[3 * n_local:4 * n_local])[0])
    for sh in run.port.shards():
        leaf = run.port[sh].tx
        if leaf.shape[1] == n_local:
            if sh == 3:
                leaf[0, row - 3 * n_local] = 0
        else:
            leaf[0, row] = 0
    with pytest.raises(AssertionError):
        for _ in range(6):
            run.advance()


@pytest.mark.parametrize("name", ["frontier", "host"])
def test_empty_frontier_tick_exchanges_no_round(name):
    """Every budget spent and a sync tick: the frontier layouts skip the
    broadcast phase (no draw, no still-bad mask; the host layout still
    sends its round-0 active bits), sync still heals, and the state
    equals the reference's."""
    run = Lockstep(name, sync_interval=4)
    for _ in range(3):
        run.advance()
    run.ref = run.ref._replace(tx=jnp.zeros_like(run.ref.tx))
    run.single = run.single._replace(tx=torch.zeros_like(run.single.tx))
    # the reference's state, as is, becomes the port's shards
    run.port = convert.sharded_state_from_reference(
        jax.tree.map(np.asarray, run.ref), run.layout, run.mesh)
    assert run.port.tick == run.t
    before = dict(run.mesh.fabric.bytes)
    assert run.t % 4 == 3  # a sync tick
    run.advance()
    moved = {k: v - before.get(k, 0) for k, v in run.mesh.fabric.bytes.items()}
    s, n = len(SEEDS), run.tcfg.n_nodes
    want = {"frontier": 0, "host": (D - 1) * s * n // 8}[name]
    assert moved.get("delta", 0) == want
    assert sum(moved.values()) == want


@pytest.mark.parametrize("name,n,sparse,host", [
    ("dense", 256, False, False), ("frontier", 256, True, False),
    ("host", 256, True, True)])
def test_run_exact_headline_on_a_mesh_matches_reference(name, n, sparse,
                                                        host):
    """The reference's keys (kernel tag, n_shards, n_hosts included),
    ints and ticks exact, msgs/node to rtol 1e-6, as the single-device
    twin test holds them; the per-seed values equal the port's
    single-device run."""
    jcfg, tcfg = _cfgs(n=n, heal_tick=6, sync_interval=4,
                       backoff_ticks=0.0, max_ticks=48)
    axis = "hosts" if host else "nodes"
    kernel = "sparse" if sparse else "dense"
    want = jc.run_exact_headline(
        jcfg, n_seeds=2, seed=0, kernel=kernel, host_sharded=host,
        mesh=JaxMesh(np.array(jax.devices()[:D]), (axis,)))
    mesh = Mesh(axis, LocalFabric(D, "cpu"))
    got = tc.run_exact_headline(tcfg, n_seeds=2, seed=0, kernel=kernel,
                                host_sharded=host, mesh=mesh)
    assert {k: got[k] for k in RUN_KEYS} == {k: want[k] for k in RUN_KEYS}
    for k in ("msgs_per_node_mean", "msgs_per_node_p99"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    one = tc.run_exact_headline(tcfg, n_seeds=2, seed=0, kernel=kernel,
                                device="cpu")
    for k in ("seed_ticks", "seed_msgs_mean", "seed_msgs_p99", "rejection",
              "converged_frac"):
        assert got[k] == one[k], k
    assert got["kernel"] == {"dense": "sharded-dense",
                             "frontier": "sharded-sparse",
                             "host": "host-sparse"}[name]
    kinds = {"dense": {"active", "delta", "infected", "stats"},
             "frontier": {"delta", "stats"}, "host": {"delta", "stats"}}
    assert set(got["fabric"]) <= kinds[name]


def test_batch_policy_counts_replicas_on_one_device():
    """Under a LocalFabric the card's budget is split over the shards:
    the same budget batches fewer seeds than D separate devices would."""
    _, tcfg = _cfgs(n=256, max_ticks=8)
    budget = 3 * 2 * (256 // D * tc.frontier_ring_cap(tcfg) * 4 + 256 * 20)
    kw = dict(n_seeds=3, kernel="sparse", hbm_budget_bytes=budget)
    per_device = tc.frontier_seed_batch(tcfg, 3, D, budget)
    got = tc.run_exact_headline(tcfg, mesh=Mesh("nodes", LocalFabric(
        D, "cpu")), **kw)
    assert got["seed_batch"] == tc.frontier_seed_batch(tcfg, 3, D,
                                                       budget // D)
    assert got["seed_batch"] < per_device


def test_entry_point_refusals_match_reference():
    jcfg, tcfg = _cfgs(n=264, ring0_size=16)
    nodes = Mesh("nodes", LocalFabric(D, "cpu"))
    hosts = Mesh("hosts", LocalFabric(D, "cpu"))
    for kw in (dict(host_sharded=True, kernel="sparse"),
               dict(host_sharded=True, kernel="dense", mesh=hosts)):
        with pytest.raises(ValueError, match="host_sharded needs") as ref:
            jc.run_exact_headline(jcfg, n_seeds=1, **{
                **kw, "mesh": object() if "mesh" in kw else None})
        with pytest.raises(ValueError) as port:
            tc.run_exact_headline(tcfg, n_seeds=1, device="cpu", **kw)
        assert str(port.value) == str(ref.value)
    # n % (8 * H): the reference's guard, word for word
    with pytest.raises(ValueError, match="byte-aligned") as ref:
        js.sharded_frontier_host_step(
            JaxMesh(np.array(jax.devices()[:D]), ("hosts",)), jcfg)
    with pytest.raises(ValueError) as port:
        tc.run_exact_headline(tcfg, n_seeds=1, kernel="sparse",
                              host_sharded=True, mesh=hosts)
    assert str(port.value) == str(ref.value)
    # n % D over node shards
    _, odd = _cfgs(n=260, ring0_size=16)
    with pytest.raises(ValueError, match="must divide over 8 node shards"):
        tc.run_exact_headline(odd, n_seeds=1, mesh=nodes)
    with pytest.raises(ValueError, match="'hosts' axis"):
        tc.run_exact_headline(tcfg, n_seeds=1, kernel="sparse", mesh=nodes,
                              host_sharded=True)
    with pytest.raises(ValueError, match="mesh must be"):
        tc.run_exact_headline(tcfg, n_seeds=1, mesh=object())


def test_mesh_entry_points_run_on_the_card_unless_asked():
    """Both fabrics default to the card and raise without one; a
    ``device`` beside a mesh that is not the mesh's device is refused
    instead of being ignored."""
    from corrosion_tpu_torch.mesh import DistFabric

    _, tcfg = _cfgs(n=264, ring0_size=16)
    nodes = Mesh("nodes", LocalFabric(D, "cpu"))
    with pytest.raises(ValueError, match="differs from the mesh's"):
        tc.run_exact_headline(tcfg, n_seeds=1, mesh=nodes, device="cuda")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the fabrics would run")
    for make in (lambda: LocalFabric(D), lambda: DistFabric()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def reference_host_stats(msgs: np.ndarray, hosts: int):
    """Per-seed (mean, p99) float32 of [S, N] per-node ``msgs`` as the
    reference's multi-host chunk computes them: msgs sharded over
    ``hosts``, gathered, cast to float32, reduced inside a scan."""
    from jax.sharding import PartitionSpec as P

    mesh = JaxMesh(np.array(jax.devices()[:hosts]), ("hosts",))

    def local(m_l):
        def body(carry, _):
            m = js.gather_nodes(carry, axis=1, axis_name="hosts"
                                ).astype(jnp.float32)
            return carry, (jnp.mean(m, axis=1),
                           jnp.percentile(m, 99, axis=1))

        return jax.lax.scan(body, m_l, xs=None, length=1)[1]

    fn = jax.jit(js._shard_map(local, mesh, in_specs=(P(None, "hosts"),),
                               out_specs=(P(), P())))
    mean, p99 = fn(jax.device_put(
        jnp.asarray(msgs, dtype=jnp.int32),
        jax.sharding.NamedSharding(mesh, P(None, "hosts"))))
    return np.asarray(mean)[0], np.asarray(p99)[0]


def test_reference_host_statistics_equal_the_ports():
    """The witness above against the port's ``tick_stats`` mean and p99
    on the same seeded msgs, 2 and 8 hosts."""
    msgs = np.random.default_rng(7).integers(0, 289, size=(2, 4096))
    out = torch.zeros((2, len(tc.STATS)), dtype=torch.float32)
    tc._stats_into(torch.ones((2, 4096), dtype=torch.bool),
                   torch.from_numpy(msgs.astype(np.int32)), out)
    for hosts in (2, D):
        mean, p99 = reference_host_stats(msgs, hosts)
        assert mean.tolist() == out[:, tc.MSGS_MEAN].tolist()
        assert p99.tolist() == out[:, tc.MSGS_P99].tolist()


def test_shard_kernels_plain_rounds_and_window_checks():
    """``shard_round`` counts rounds as the single-device sampler does
    (the same active rows, rounds and maximum over the shards), and
    ``shard_commit`` refuses a window that is neither all rows nor
    mine."""
    from corrosion_tpu_torch.kernels import shard_exact as sx

    _, tcfg = _cfgs(n=256, loss=0.0, **UNPARTITIONED)
    state = tc.packed_exact_init(tcfg, [(0, 5), (0, 6)], device="cpu")
    keys = [(0, 7), (0, 8)]
    args, _, _ = tc._send_inputs(state, keys, tcfg)
    one = torch.zeros(4, dtype=torch.int64)
    es.exact_send_plain(**{**args, **{f: args[f].clone() for f in (
        "tx", "next_send", "msgs", "sent")}}, diag=one)
    active = args["infected"] & (args["tx"] > 0) & (args["next_send"] <= 0)
    n_local = 256 // D
    total = torch.zeros(4, dtype=torch.int64)
    for sh in range(D):
        w = slice(sh * n_local, (sh + 1) * n_local)
        d = torch.zeros(4, dtype=torch.int64)
        sx.shard_round(active[:, w].contiguous(),
                       args["sent"][:, w].contiguous(), args["keys"],
                       sh * n_local, 256, args["p"], d)
        total[:2] += d[:2]
        total[2] = max(total[2], d[2])
    assert total.tolist()[:3] == one.tolist()[:3]
    with pytest.raises(ValueError, match="must hold 256 or 32 rows"):
        sx.shard_commit(active, torch.zeros((2, 256), dtype=torch.int32),
                        args["infected"][:, :10], None, args["tx"],
                        args["next_send"], args["msgs"],
                        args["sent"][:, :n_local].contiguous(), args["keys"],
                        0, 0, args["p"], None)


def _shard_commit_inputs(name, family, tick=4, sh=3):
    """Shard ``sh``'s ``shard_commit`` operands under layout ``name`` at
    ``tick`` of the port's single-device run of ``family`` (n = 256, 8
    shards): the activity of all rows, every row's accepted round from
    the shards' ``shard_round``, the target window, the budget window
    and my memory rows."""
    from corrosion_tpu_torch.kernels import shard_exact as sx
    from corrosion_tpu_torch.random import PRNGKey, fold_in

    _, cfg = _cfgs(n=256, **FAMILIES[family])
    sparse = name != "dense"
    init = tc.frontier_exact_init if sparse else tc.packed_exact_init
    tick_fn = tc.frontier_exact_tick if sparse else tc.packed_exact_tick
    base = [PRNGKey(s) for s in SEEDS]
    state = init(cfg, [fold_in(k, 2**20) for k in base], device="cpu")
    while state.tick < tick:
        state = tick_fn(state, [fold_in(k, state.tick) for k in base], cfg)
    args, _, _ = tc._send_inputs(state, [fold_in(k, tick) for k in base],
                                 cfg)
    n = cfg.n_nodes
    nl = n // D
    active = args["infected"] & (args["tx"] > 0) & (args["next_send"]
                                                     <= tick)
    rounds = [sx.shard_round(active[:, w:w + nl].contiguous(),
                             args["sent"][:, w:w + nl].contiguous(),
                             args["keys"], w, n, args["p"],
                             torch.zeros(4, dtype=torch.int64))
              for w in range(0, n, nl)]
    w = slice(sh * nl, (sh + 1) * nl)

    def win(x):
        return None if x is None else x[:, w].contiguous()

    infected, pending = ((win(args["infected"]), win(args["pending"]))
                         if name == "dense"
                         else (args["infected"], args["pending"]))
    budget = [args[f] if name == "frontier" else win(args[f])
              for f in ("tx", "next_send", "msgs")]
    return dict(active=active,
                accepted=(torch.cat(rounds, dim=1) - 1).clamp_min(0),
                infected=infected, pending=pending, budget=budget,
                sent=win(args["sent"]), keys=args["keys"], lo=sh * nl,
                tick=tick, p=args["p"], tier=args["tier"])


@pytest.mark.parametrize("family", ["headline", "wan_latency"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_shard_commit_of_a_split_equals_the_commit_of_the_union(name,
                                                                family):
    """The invariant a kernel that runs the active rows in any order and
    any grouping relies on: the active rows split by a seeded random
    partition and committed in sequence (``shard_commit_plain``, the
    second call on the first's new infected window, pending, budget and
    marks carried over in place), in both orders, leave every leaf equal
    to the commit of the union.  Each part alone must not (the split is
    not vacuous), and the WAN-latency variant must queue deliveries."""
    from corrosion_tpu_torch.kernels import shard_exact as sx

    x = _shard_commit_inputs(name, family)
    pick = torch.from_numpy(np.random.default_rng(13).random(
        tuple(x["active"].shape)) < 0.5)
    parts = (x["active"] & pick, x["active"] & ~pick)
    nl = x["sent"].shape[1]
    for part in parts:
        assert part[:, x["lo"]:x["lo"] + nl].any() and part.sum() > 32

    def commit(active, infected, leaves):
        return sx.shard_commit_plain(
            active, x["accepted"], infected, leaves["pending"],
            *leaves["budget"], leaves["sent"], x["keys"], x["lo"],
            x["tick"], x["p"], x["tier"])

    def fresh():
        return dict(pending=None if x["pending"] is None
                    else x["pending"].clone(),
                    budget=[b.clone() for b in x["budget"]],
                    sent=x["sent"].clone())

    def leaves(infected, c):
        return [infected, c["pending"], *c["budget"], c["sent"]]

    union = fresh()
    want = leaves(commit(x["active"], x["infected"], union), union)
    if family == "wan_latency":
        assert not torch.equal(union["pending"], x["pending"])
    for first, second in (parts, parts[::-1]):
        c = fresh()
        got = leaves(commit(second, commit(first, x["infected"], c), c), c)
        for f, a, b in zip(("infected", "pending", "tx", "next_send",
                            "msgs", "sent"), got, want):
            assert (a is None and b is None) or torch.equal(a, b), f
    half = fresh()
    got = leaves(commit(parts[0], x["infected"], half), half)
    assert not all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(got, want))


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="the reference's witness "
                                 "for a host-sparse run's statistics")
    ap.add_argument("msgs", nargs="?", help="the npz of per-node msgs")
    ap.add_argument("--reference-run", type=int, metavar="N", default=None,
                    help="instead run the reference's host-sparse layout "
                         "itself, bench.py's exact config at N nodes x 2 "
                         "seeds on 2 CPU hosts, and print its stats")
    args = ap.parse_args(argv)
    if args.reference_run:
        from bench import _frontier_exact_cfg

        res = jc.run_exact_headline(
            _frontier_exact_cfg(args.reference_run, partitioned=False),
            n_seeds=2, seed=0, kernel="sparse", host_sharded=True,
            mesh=JaxMesh(np.array(jax.devices()[:2]), ("hosts",)))
        print(json.dumps({k: res[k] for k in (
            "n_nodes", "kernel", "n_hosts", "converged_frac", "ticks_p50",
            "ticks_p99", "msgs_per_node_mean", "msgs_per_node_p99",
            "wall_s")}))
        return 0
    data = np.load(args.msgs)
    msgs, hosts = data["msgs"], int(data["n_hosts"])
    mean, p99 = reference_host_stats(msgs, hosts)
    print(json.dumps({
        "n": int(msgs.shape[1]), "n_hosts": hosts,
        "reference_seed_msgs_mean": [float(x) for x in mean],
        "reference_seed_msgs_p99": [float(x) for x in p99],
        "reference_msgs_per_node_mean": float(np.mean(mean)),
        "exact_seed_msgs_mean": [float(m.mean(dtype=np.float64))
                                 for m in msgs],
        "run_seed_msgs_mean": [float(x) for x in data["seed_msgs_mean"]],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
