#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``corrosion_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package.  Phases, each ending the run with a non-zero exit on failure:

1. print the card's name and power limit, build the eight kernel sources
   of this checkout (one ``nvcc`` per source, in parallel) and record
   threefry's opcode counts (``cuobjdump -sass``);
2. hold the perm-fanout kernels against their plain PyTorch versions
   on the card, on the inputs the headline's tick 7 (a sync tick,
   partition in force) gives them, and time both with CUDA events; time
   the stable ``torch.sort`` the headline leaves to PyTorch;
3. run the headline — 100k nodes x 32 seeds, R = 8, 5% loss, two
   partition blocks healing at tick 12 — on the card, require every
   seed to converge, and require every kernel's launch counter (zeroed
   just before) to have risen;
4. run the same config at 4096 nodes x 4 seeds on the card (kernels)
   and on the CPU (plain versions) and require per-tick rows / tx /
   msgs / hops / next_send and the stats dicts to be equal; the same
   for five 1024-node variants that take the kernels' other paths;
5. hold ``exact_send`` (bitmap and ring) and ``exact_commit`` against
   their plain versions (max |diff| 0 on every output leaf and the
   rejection counters) at ticks 1 and 6 of the exact column's
   full-width configs at their own seed counts (16 x 100k, 4 x 1M) and
   of a WAN-latency variant of each, and time them at tick 6;
6. run the exact column at full width through ``run_exact_headline``:
   dense 100k nodes x 16 seeds (a 20 GB bitmap, partitioned) and
   sparse 1M nodes x 4 seeds, each with the launch counters zeroed just
   before; require convergence and that ``exact_send``, ``exact_commit``,
   ``sync_pull``, ``tick_stats`` and ``threefry_bits`` all ran; then
   run the 100k config through the sparse kernel and require per-seed
   statistics identical to the dense run's;
7. run both exact kernels at 1024 nodes x 2 seeds on the card and on
   the CPU, on tests/test_frontier.py's headline shape and four
   scenario families, and require every leaf (bitmap or ring included),
   the per-tick statistics and the run's stats dict to be equal;
8. hold ``seq_sync`` and ``seq_stats`` against their plain versions at
   config #4's full width (10k nodes x 32 seeds, 64 seqs) at ticks 1
   and 20, and the SWIM kernels (``swim_tick``: probe/select, spread,
   gather, settle) at N = 64 and 4096 at a tick during suspicion, the
   revive tick, a 15%-loss tick, a tick without gossip targets and a
   crafted-tie state at 8 gossip entries, every leaf bitwise; time each
   kernel with CUDA events;
9. run config #4 (``run_anti_entropy_seeds``, 10k x 32 seeds), config
   #2 (``run_churn``, 64 nodes) and the 4096-node churn cycle on the
   card, each with the launch counters zeroed just before, and hold
   them to the reference's numbers (converged 1.0, ticks 32/37,
   msgs/node 73.2255; detect 15, rejoin 4, 4.982421875 msgs/node/tick;
   detect and rejoin None, 4.99986 msgs/node/tick);
10. run anti-entropy at 1000 nodes x 4 seeds (default, and 3 peers with
    a budget of 2) and SWIM at 256 nodes over two 128-tick churn cycles
    (lossless and 15% loss) on the card and on the CPU, and require
    every leaf per tick and the stats to be equal;
11. hold ``sent_select`` and ``sent_commit`` (the exact ``sent_to``
    sampler) against their plain versions, every output leaf bitwise
    (``sent`` included): calibration mode at ``ExactConfig(16000)``
    seed 0 at tick 1 and at its busiest tick, which must hold active
    rows with tied scores in their k + 1 smallest; broadcast mode at
    512 nodes x 8 seeds on ``sim_trace``'s config (with int32 keys and
    with int64 keys) and on two variants (10% loss, a one-way partition
    in force, hops; WAN drop or RTT tiers); time both kernels behind a
    GPU-side sleep;
12. run ``run_msgs_calibration(ns=(1000, 4000, 16000), seeds=3)``, the
    ``sim_trace`` config at 64, 256 and 512 nodes x 8 seeds and
    ``sim_obs_trace``'s (sync every 8 ticks) at 512 x 8 on the card,
    each with the launch counters zeroed just before, and hold them to
    ``CALIB_MSGS.json``'s points, ``SIMDIFF_N*.json``'s sim numbers and
    the reference's numbers (hard-coded here);
13. run ``exact_tick`` at 2000 nodes (a short last sender chunk,
    backoff 1.5) and the ``track_sent`` runner at 256 nodes x 4 seeds
    (phase 11's variants and ``sim_obs_trace``'s) on the card and on
    the CPU, and require every leaf per tick and the results to be
    equal.

Prints the card line, the ``kernels`` JSON line and, last, the
``{"ok": true, "device": ...}`` line; writes the full record (with
the compiler's register report) to
``corrosion_tpu_torch/kernels/build/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# the INT32 pipe: 64 lanes per SM x 132 SMs x 1.98 GHz (the float32
# 67 TFLOP/s rate is 128 lanes x 2 flops x the same)
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# threefry2x32 operations per uniform word that only the INT32 pipe
# runs: 20 funnel-shift rotates and 20 xors of the rounds, the output
# xor and the epilogue's shift.  Its 32 adds (2 input, 20 round, 10 key
# injections; the key words are uniform, so k + 1 ... k + 5 cost nothing
# per thread) and the epilogue's OR of disjoint bits can issue as IMAD
# on the float32 pipe beside them, 33 / 64 lane-clocks per word against
# these 42 / 64, and the epilogue's float subtract runs there too.
INT_PIPE_OPS_PER_UNIFORM = 20 + 20 + 1 + 1


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the card (CUDA events, warm)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def max_abs_err(a, b) -> float:
    """Largest |a - b| over paired tensors (NaN where both are NaN
    counts as equal); 0.0 means bitwise-equal integers.  Unequal
    tensors are compared in float64 slices, so a 20 GB bitmap needs no
    160 GB copy."""
    worst = 0.0
    step = 1 << 26
    for x, y in zip(a, b):
        if x is None and y is None or torch.equal(x, y):
            continue
        x, y = x.reshape(-1), y.reshape(-1)
        for i in range(0, x.numel(), step):
            xs, ys = x[i:i + step].double(), y[i:i + step].double()
            both_nan = torch.isnan(xs) & torch.isnan(ys)
            d = torch.where(both_nan, torch.zeros_like(xs), (xs - ys).abs())
            worst = max(worst,
                        float(torch.nan_to_num(d, nan=math.inf).max()))
    return worst


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sass_mix(kernels, name: str) -> dict:
    """Opcode counts in library ``name``'s machine code (``cuobjdump
    -sass``, written beside the library as ``<name>.sass``): the record
    of which pipe the compiler gave each operation."""
    lib = kernels.library_path(name)
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode:
        return {"error": out.stderr.strip()[-500:]}
    (kernels.BUILD_DIR / f"{name}.sass").write_text(out.stdout)
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     out.stdout)
    counts: dict = {}
    for op in ops:
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def kernel_checks(cfg, mods, dev):
    """Phase 2: each kernel against its plain version at tick 7 of the
    headline (state reached through the port on the card)."""
    from corrosion_tpu_torch.models.broadcast import (
        _perm_senders,
        _rtt_tier,
        _wan_region,
    )
    from corrosion_tpu_torch.random import (
        PRNGKey,
        fold_in,
        key_words,
        randint_span,
        split,
    )
    from corrosion_tpu_torch.sim.epidemic import (
        _partition_ids,
        epidemic_init,
        epidemic_tick,
    )

    threefry, deliver, sync_pull, tick_stats = mods
    seed_key = PRNGKey(0)
    state = epidemic_init(cfg, device=dev)
    for _ in range(7):
        state = epidemic_tick(state, fold_in(seed_key, state.tick), cfg)
    tick = state.tick
    bp, sp = cfg.broadcast_params, cfg.sync_params
    n, k, u = bp.n_nodes, bp.fanout, bp.universe
    key = fold_in(seed_key, tick)
    k_b, k_s = split(key)
    key_t, key_l = split(k_b)
    part = _partition_ids(cfg, dev)
    results = []

    # -- threefry_bits: loss uniforms [N, K] (timed), column scores,
    #    sync offsets and raw bits (checked)
    def fill(dtype, shape, plain, key_=key_l, **epi):
        out = torch.empty(shape, dtype=dtype, device=dev)
        fn = threefry.threefry_bits_plain if plain else threefry.threefry_bits
        return fn(out, key_words(key_), **epi)

    span, mult = randint_span(1, u)
    kh, kl = (key_words(x) for x in split(k_s))
    cases = [
        (torch.float32, (n, k), key_l, {}),
        (torch.float32, (n // u, u), fold_in(key_t, 2), {}),
        (torch.uint32, (n // 250, 250), fold_in(key_t, 0), {}),
        (torch.int32, (n, sp.peers_per_round), None,
         dict(key2=kl, span=span, mult=mult, minval=1)),
    ]
    err = 0.0
    for dtype, shape, key_, epi in cases:
        if key_ is None:  # randint: the hi key goes as the first key
            a = torch.empty(shape, dtype=dtype, device=dev)
            b = torch.empty(shape, dtype=dtype, device=dev)
            threefry.threefry_bits(a, kh, **epi)
            threefry.threefry_bits_plain(b, kh, **epi)
        else:
            a = fill(dtype, shape, False, key_)
            b = fill(dtype, shape, True, key_)
        if dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        err = max(err, max_abs_err([a], [b]))
    loss_out = torch.empty((n, k), dtype=torch.float32, device=dev)
    kw = key_words(key_l)
    results.append(dict(
        name="threefry_bits", route="cuda",
        source="corrosion_tpu_torch/kernels/csrc/threefry.cu",
        replaces="jax/_src/prng.py:1184",
        max_abs_err=err,
        ms=time_ms(lambda: threefry.threefry_bits(loss_out, kw), 50),
        plain_ms=time_ms(
            lambda: threefry.threefry_bits_plain(loss_out, kw), 5),
        bound=(nbytes(loss_out),
               loss_out.numel() * INT_PIPE_OPS_PER_UNIFORM),
        library_ms=None,
        shape=f"uniform float32 [{n}, {k}]",
    ))

    # -- deliver_perm: the tick's K sender maps and loss draws
    senders = torch.stack([
        _perm_senders(key_t, j, n, u, j < bp.fanout_ring0, bp.ring0_size,
                      device=dev)
        for j in range(k)
    ])
    loss_u = torch.empty((n, k), dtype=torch.float32, device=dev)
    threefry.threefry_bits(loss_u, key_words(key_l))
    dargs = dict(
        hops=state.hops, next_send=state.next_send, tick=tick,
        loss_u=loss_u, wan_u=None, region=_wan_region(bp, dev),
        partition_id=part, sev=None, partition_active=tick < cfg.heal_tick,
        tier=_rtt_tier(bp, dev), loss=bp.loss, wan_loss=bp.wan_cross_loss,
        max_tx=bp.max_transmissions, backoff=bp.backoff_ticks,
    )
    inputs = (state.rows, state.tx_remaining, state.msgs, senders)
    got = deliver.deliver_perm(*inputs, **dargs)
    want = deliver.deliver_perm_plain(*inputs, **dargs)
    results.append(dict(
        name="deliver_perm", route="cuda",
        source="corrosion_tpu_torch/kernels/csrc/deliver_perm.cu",
        replaces="corrosion_tpu/models/broadcast.py:327",
        max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: deliver.deliver_perm(*inputs, **dargs), 20),
        plain_ms=time_ms(
            lambda: deliver.deliver_perm_plain(*inputs, **dargs), 3),
        bound=(nbytes(*inputs, state.hops, state.next_send, loss_u, part,
                      *got), 0),
        library_ms=None,
        shape=f"rows int32 [{n}, {cfg.n_rows}], K={k}",
    ))

    # -- sync_pull: this sync tick's pull on the delivered state
    rows_b, msgs_b = got[0], got[2]
    offs = torch.empty((n, sp.peers_per_round), dtype=torch.int32,
                       device=dev)
    threefry.threefry_bits(offs, kh, key2=kl, span=span, mult=mult,
                           minval=1)
    sargs = dict(partition_id=part, sev=None,
                 partition_active=tick < cfg.heal_tick,
                 cells_per_chunk=sp.cells_per_chunk,
                 handshake_msgs=sp.handshake_msgs)
    got_s = sync_pull.sync_pull(rows_b, msgs_b, offs, u, **sargs)
    want_s = sync_pull.sync_pull_plain(rows_b, msgs_b, offs, u, **sargs)
    results.append(dict(
        name="sync_pull", route="cuda",
        source="corrosion_tpu_torch/kernels/csrc/sync_pull.cu",
        replaces="corrosion_tpu/models/sync.py:90",
        max_abs_err=max_abs_err(got_s, want_s),
        ms=time_ms(lambda: sync_pull.sync_pull(rows_b, msgs_b, offs, u,
                                               **sargs), 20),
        plain_ms=time_ms(lambda: sync_pull.sync_pull_plain(
            rows_b, msgs_b, offs, u, **sargs), 3),
        bound=(nbytes(rows_b, msgs_b, offs, part, *got_s), 0),
        library_ms=None,
        shape=f"rows int32 [{n}, {cfg.n_rows}], P={sp.peers_per_round}",
    ))

    # -- tick_stats: the state after the tick; a series too wide for the
    #    kernel's histogram must be flagged, never clipped
    rows_t, msgs_t, hops_t = got_s[0], got_s[1], got[3]
    target = state.rows[0].clone()
    s = cfg.n_universes
    got_t = tick_stats.tick_stats(rows_t, target, msgs_t, hops_t, s)
    want_t = tick_stats.tick_stats_plain(
        rows_t, target, msgs_t, hops_t, s, torch.empty_like(got_t))
    if not torch.allclose(got_t, want_t, rtol=1e-6, atol=0.0, equal_nan=True):
        fail(f"tick_stats disagrees with its plain version:\n{got_t}\n"
             f"{want_t}")
    wide = msgs_t.clone()
    wide[0] += tick_stats.NBINS
    flagged = tick_stats.tick_stats(rows_t, target, wide, hops_t, s)
    if not torch.equal(flagged[1:], got_t[1:]):
        fail("tick_stats: one wide universe changed the others' stats")
    try:
        tick_stats.raise_on_overflow(flagged.cpu().numpy())
    except ValueError:
        pass
    else:
        fail("tick_stats did not flag a series wider than its bins")
    out_t = torch.empty_like(got_t)
    results.append(dict(
        name="tick_stats", route="cuda",
        source="corrosion_tpu_torch/kernels/csrc/tick_stats.cu",
        replaces="corrosion_tpu/sim/epidemic.py:272",
        max_abs_err=max_abs_err([got_t], [want_t]),
        ms=time_ms(lambda: tick_stats.tick_stats(
            rows_t, target, msgs_t, hops_t, s, out=out_t), 20),
        plain_ms=time_ms(lambda: tick_stats.tick_stats_plain(
            rows_t, target, msgs_t, hops_t, s, out_t), 3),
        bound=(nbytes(rows_t, target, msgs_t, hops_t, out_t), 0),
        library_ms=None,
        shape=f"{s} universes x {n // s}, R={cfg.n_rows}",
    ))

    for r in results:
        set_bound(r)
        if r["name"] != "tick_stats" and r["max_abs_err"] != 0.0:
            fail(f"{r['name']} differs from its plain version "
                 f"(max |diff| {r['max_abs_err']})")
    return results


def set_bound(r: dict) -> None:
    """Replace ``r["bound"]`` (bytes, INT32-pipe operations) by the
    least time of the two on the card and which one it is."""
    b, ops = r.pop("bound")
    t_bytes = b / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def states_equal(a, b) -> bool:
    """Every leaf of two states of one type equal (tensors compared on
    the host; ints and None as values)."""
    for x, y in zip(a, b):
        tx, ty = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
        if tx or ty:
            if not (tx and ty and torch.equal(x.cpu(), y.cpu())):
                return False
        elif x != y:
            return False
    return True


# phase 4's variants of the headline at 1024 nodes: the kernel paths
# the headline itself never takes (RTT tiers and backoff, WAN drops,
# one-way severance with two sync peers, R % 4 != 0 without hops and a
# prime universe's ring0 fallback)
VARIANTS = {
    "het_ring": dict(topology="het_ring", rtt_tiers=3, backoff_ticks=1.5),
    "wan_two_region": dict(topology="wan_two_region", partition_blocks=1),
    "measured_ring": dict(topology="measured_ring",
                          rtt_tier_weights=(2.0, 1.0, 1.0),
                          backoff_ticks=2.5),
    "oneway": dict(oneway_blocks=((0, 1),), sync_peers=2),
    "r5_nohops_prime": dict(n_nodes=1021, n_rows=5, track_hops=False),
}


def run_equal(cfg, seeds: int, dev, label: str) -> dict:
    """The port's kernels on the card equal its plain versions on the
    CPU, tick by tick (state and tick stats) until every universe has
    converged, and in the stats dict of ``run_epidemic_seeds``."""
    from corrosion_tpu_torch.kernels.tick_stats import CONVERGED, tick_stats
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim.epidemic import (
        epidemic_init,
        epidemic_tick,
        run_epidemic_seeds,
    )

    flat = replace(cfg, n_universes=seeds)
    key = PRNGKey(0)
    gpu = epidemic_init(flat, device=dev)
    cpu = epidemic_init(flat, device="cpu")
    target_g, target_c = gpu.rows[0].clone(), cpu.rows[0].clone()
    ticks = 0
    while ticks < cfg.max_ticks:
        k = fold_in(key, ticks)
        gpu = epidemic_tick(gpu, k, flat)
        cpu = epidemic_tick(cpu, k, flat)
        ticks += 1
        if not states_equal(gpu, cpu):
            fail(f"{label}: card and CPU states differ at tick {ticks}")
        sg = tick_stats(gpu.rows, target_g, gpu.msgs, gpu.hops, seeds).cpu()
        sc = tick_stats(cpu.rows, target_c, cpu.msgs, cpu.hops, seeds)
        if not torch.equal(torch.nan_to_num(sg), torch.nan_to_num(sc)):
            fail(f"{label}: tick stats differ at tick {ticks}")
        if bool((sc[:, CONVERGED] == 1.0).all()):
            break
    a = run_epidemic_seeds(cfg, n_seeds=seeds, seed=0, device=dev)
    b = run_epidemic_seeds(cfg, n_seeds=seeds, seed=0, device="cpu")
    a.pop("wall_s")
    b.pop("wall_s")
    if a != b:
        fail(f"{label}: stats differ:\ncard {a}\ncpu  {b}")
    return {"ticks_compared": ticks, "stats": a}


# -- the exact sampler ----------------------------------------------------

# threefry2x32 operations per hash that only the INT32 pipe runs: the
# 20 rotates and 20 xors of the rounds and the output xor (see
# INT_PIPE_OPS_PER_UNIFORM)
INT_PIPE_OPS_PER_HASH = 41
SECTOR = 32  # bytes a random access moves at least
BUSY_TICK = 6  # most rows of the writer's block are active by then
# a GPU-side wait queued before a timed call, so the host's enqueue of
# the call hides behind it (about 1 ms at 1.98 GHz)
SLEEP_CYCLES = 2_000_000


def exact_cfgs():
    """The full-width exact configs (``sim.calibrate.EXACT_DENSE`` and
    ``EXACT_SPARSE``: bench.py ``_frontier_exact_cfg`` at 100k
    partitioned and 1M loss-only, bench.py:2538-2553) and their seeds
    (``_exact_seed_policy``, bench.py:3576-3584)."""
    from corrosion_tpu_torch.sim import calibrate as cal

    return ((cal.EXACT_DENSE, cal.EXACT_DENSE_SEEDS),
            (cal.EXACT_SPARSE, cal.EXACT_SPARSE_SEEDS))


def frontier_cap(cfg) -> int:
    return cfg.max_transmissions * cfg.fanout


def time_inplace_ms(restore, fn, reps: int, warm: int = 2) -> float:
    """Mean ms of ``fn`` on the card (a CUDA event pair around each
    call) when ``fn`` updates its inputs in place: ``restore`` puts the
    inputs back before every call, outside the timed pair (its copies
    also evict the L2 cache, as a tick's other work would).  A GPU-side
    sleep before the pair keeps the host's enqueue of ``fn`` out of
    the time."""
    for _ in range(warm):
        restore()
        fn()
    pairs = []
    for _ in range(reps):
        restore()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def exact_advance(state, base, cfg, tick: int, sparse: bool):
    """Tick ``state`` (seed keys ``base``) on through ``tick - 1``."""
    from corrosion_tpu_torch.random import fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    tick_fn = cal.frontier_exact_tick if sparse else cal.packed_exact_tick
    while state.tick < tick:
        state = tick_fn(state, [fold_in(k, state.tick) for k in base], cfg)
    return state


def exact_state_at(cfg, seeds: int, tick: int, sparse: bool, dev):
    """The first ``seeds`` seeds of ``run_exact_headline(seed=0)`` at
    ``tick``, reached through the port on ``dev``; and the seed keys."""
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    base = [PRNGKey(s) for s in range(seeds)]
    init = cal.frontier_exact_init if sparse else cal.packed_exact_init
    state = init(cfg, [fold_in(k, 2**20) for k in base], device=dev)
    return exact_advance(state, base, cfg, tick, sparse), base


MUTATED = ("tx", "next_send", "msgs", "pending", "sent")


def exact_kernel_checks(dev):
    """``exact_send`` (both representations) and ``exact_commit``
    against their plain versions on the card, on the inputs of ticks 1
    and ``BUSY_TICK`` of the full-width runs at their own seed counts
    (the shapes the main path launches), and of a WAN latency variant
    of each (which fills the queue); timed at ``BUSY_TICK``.  The dense
    check holds three copies of the 20 GB bitmap (the state, the
    kernel's and the plain version's); the timed calls reuse the
    kernel's."""
    from corrosion_tpu_torch.kernels import exact_send as es
    from corrosion_tpu_torch.random import fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    (dense, dense_seeds), (sparse, sparse_seeds) = exact_cfgs()
    latency = dict(topology="wan_two_region", partition_blocks=1,
                   heal_tick=0, wan_latency_ticks=2)
    cases = (
        ("bitmap", dense, dense_seeds, False),
        ("bitmap", replace(dense, **latency), 2, False),
        ("ring", sparse, sparse_seeds, True),
        ("ring", replace(sparse, **latency), sparse_seeds, True),
    )
    errs = {"bitmap": 0.0, "ring": 0.0, "commit": 0.0}
    timed, checks = {}, []

    def diag():
        return torch.zeros(len(es.DIAG), dtype=torch.int64, device=dev)

    for rep, cfg, seeds, ring in cases:
        state, base = exact_state_at(cfg, seeds, 0, ring, dev)
        for tick in (1, BUSY_TICK):
            state = exact_advance(state, base, cfg, tick, ring)
            args, _, _ = cal._send_inputs(
                state, [fold_in(k, tick) for k in base], cfg)
            saved = {f: args[f] for f in MUTATED if args[f] is not None}
            got = {**args, **{f: v.clone() for f, v in saved.items()}}
            want = {**args, **{f: v.clone() for f, v in saved.items()}}
            got_d, want_d = diag(), diag()
            got_inf = es.exact_send(**got, diag=got_d)
            want_inf = es.exact_send_plain(**want, diag=want_d)
            names = ["new_infected", *saved, "diag"]
            a = [got_inf, *(got[f] for f in saved), got_d]
            b = [want_inf, *(want[f] for f in saved), want_d]
            err = max_abs_err(a, b)
            errs[rep] = max(errs[rep], err)
            bad = [nm for nm, x, y in zip(names, a, b)
                   if not torch.equal(x, y)]
            del a, b, want, want_inf
            # the commit on the kernel's send results
            c_got = [got["tx"].clone(), got["next_send"].clone()]
            c_want = [t.clone() for t in c_got]
            es.exact_commit(args["infected"], got_inf, *c_got, tick,
                            cfg.max_transmissions, args["tier"])
            es.exact_commit_plain(args["infected"], got_inf, *c_want,
                                  tick, cfg.max_transmissions, args["tier"])
            c_err = max_abs_err(c_got, c_want)
            errs["commit"] = max(errs["commit"], c_err)
            d = got_d.tolist()
            learned = int((got_inf & ~args["infected"]).sum())
            checks.append(dict(
                rep=rep, n=cfg.n_nodes, seeds=seeds, tick=tick,
                topology=cfg.topology, max_abs_err=err, differs=bad,
                commit_max_abs_err=c_err, active_rows=d[0],
                rounds_mean=d[1] / max(1, d[0]), rounds_max=d[2],
                learned=learned))
            if cfg.topology == "uniform" and tick == BUSY_TICK:
                timed.update(exact_times(es, cfg, seeds, ring, rep, tick,
                                         args, saved, got, got_inf, d,
                                         learned, diag()))
            del got, got_inf, args, saved, c_got, c_want
            torch.cuda.empty_cache()
        del state
        torch.cuda.empty_cache()
    for c in checks:
        if c["differs"] or c["commit_max_abs_err"] != 0.0:
            fail(f"exact kernels differ from their plain versions: {c}")
    source = "corrosion_tpu_torch/kernels/csrc/exact_send.cu"
    results = []
    for name, key, replaces in (
        ("exact_send<Bitmap>", "bitmap",
         "corrosion_tpu/sim/calibrate.py:587"),
        ("exact_send<Ring>", "ring", "corrosion_tpu/sim/calibrate.py:1157"),
        ("exact_commit", "commit", "corrosion_tpu/sim/calibrate.py:658"),
    ):
        results.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=errs[key], library_ms=None, **timed[key]))
        set_bound(results[-1])
    return results, checks


def exact_times(es, cfg, seeds, ring, rep, tick, args, saved, work,
                new_infected, d, learned, t_diag) -> dict:
    """Times of ``exact_send`` (and for the bitmap ``exact_commit``) on
    one tick's inputs, with their bounds.  ``work`` is the kernel's
    copy of the inputs; ``restore`` puts ``saved`` back into it before
    every call."""
    def restore():
        for f, v in saved.items():
            work[f].copy_(v)

    total = seeds * cfg.n_nodes
    k = cfg.fanout
    # every row's activity test; an active row's own leaves (17 bytes
    # read, 12 written), its infection stores, and its bitmap sectors
    # read and marked, or its ring row read and its slots written
    memory = 4 * frontier_cap(cfg) + SECTOR if ring else 2 * k * SECTOR
    send_bytes = total * 9 + d[0] * (17 + 12 + k * SECTOR + memory)
    hashes = d[1] * (3 + 2 * k) + d[0] * k * (cfg.loss > 0)
    out = {rep: dict(
        ms=time_inplace_ms(
            restore, lambda: es.exact_send(**work, diag=t_diag), 20),
        plain_ms=time_inplace_ms(
            restore, lambda: es.exact_send_plain(**work, diag=t_diag), 1, 1),
        bound=(send_bytes, hashes * INT_PIPE_OPS_PER_HASH),
        shape=f"{rep} {seeds} seeds x {cfg.n_nodes}, tick {tick}, "
              f"{d[0]} active rows",
    )}
    if ring:
        return out
    cw = [work["tx"].clone(), work["next_send"].clone()]
    c_src = [t.clone() for t in cw]

    def c_restore():
        for x, y in zip(cw, c_src):
            x.copy_(y)

    def commit(fn):
        return lambda: fn(args["infected"], new_infected, *cw, tick,
                          cfg.max_transmissions, args["tier"])

    out["commit"] = dict(
        ms=time_inplace_ms(c_restore, commit(es.exact_commit), 20),
        plain_ms=time_inplace_ms(c_restore, commit(es.exact_commit_plain),
                                 3),
        bound=(total * 2 + learned * 8, 0),
        shape=f"{seeds} seeds x {cfg.n_nodes}, tick {tick}, "
              f"{learned} learners",
    )
    return out


def sort_times(dev) -> list:
    """``torch.sort(stable=True)`` of ``_perm_senders`` at the
    headline's two shapes, with its bytes bound (keys read, sorted keys
    and int64 indices written)."""
    from corrosion_tpu_torch.random import PRNGKey, uniform

    out = []
    for shape in ((32, 100_000), (12_800, 250)):
        scores = uniform(PRNGKey(1), shape, dev)
        ms = time_ms(lambda: torch.sort(scores, dim=1, stable=True), 20)
        b = scores.numel() * (4 + 4 + 8)
        out.append(dict(shape=list(shape), ms=ms,
                        bound_ms=b / HBM_BYTES_PER_S * 1e3,
                        bound_by="bytes"))
    return out


EXACT_COUNTED = ("exact_send", "exact_commit", "sync_pull", "tick_stats",
                 "threefry_bits")


def exact_full_width(counted) -> dict:
    """The dense 100k x 16-seed and sparse 1M x 4-seed runs through
    ``run_exact_headline`` on the card, each with the launch counters
    zeroed just before; then the 100k partitioned config through the
    sparse kernel, whose per-seed statistics must equal the dense
    run's."""
    from corrosion_tpu_torch.sim.calibrate import run_exact_headline

    (dense, dense_seeds), (sparse, sparse_seeds) = exact_cfgs()
    runs = {}
    for label, cfg, seeds, kernel in (
        ("dense_100k", dense, dense_seeds, "dense"),
        ("sparse_1m", sparse, sparse_seeds, "sparse"),
        ("sparse_100k", dense, dense_seeds, "sparse"),
    ):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_exact_headline(cfg, n_seeds=seeds, seed=0, kernel=kernel,
                                 device="cuda")
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t0
        res["launches"] = {name: counted[name].launches
                           for name in EXACT_COUNTED}
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        runs[label] = res
        print(f"exact {label}: " + json.dumps({k: res[k] for k in (
            "converged_frac", "ticks_p50", "ticks_p99",
            "msgs_per_node_mean", "msgs_per_node_p99", "seed_batch",
            "budget_bytes", "budget_source", "wall_s", "peak_mem_gb",
            "rejection", "launches")}), flush=True)
        if res["converged_frac"] != 1.0:
            fail(f"exact {label} did not converge: {res}")
        idle = [n for n, c in res["launches"].items() if c == 0]
        if idle:
            fail(f"exact {label}: kernels never launched: {idle}")
    for key in ("seed_ticks", "seed_msgs_mean", "seed_msgs_p99"):
        if runs["dense_100k"][key] != runs["sparse_100k"][key]:
            fail(f"dense and sparse differ at 100k in {key}")
    return runs


# card against CPU at 1024 nodes: tests/test_frontier.py's headline
# shape (ring0 64, loss, partition healing at tick 3, sync every 2
# ticks, backoff 0.5) and the scenario families
UNPARTITIONED = dict(partition_blocks=1, heal_tick=0)
EXACT_VARIANTS = {
    "headline": {},
    "het_ring": dict(topology="het_ring", **UNPARTITIONED),
    "wan_two_region": dict(topology="wan_two_region", **UNPARTITIONED),
    "measured_ring": dict(topology="measured_ring",
                          rtt_tier_weights=(0, 0, 2, 2, 6, 1),
                          **UNPARTITIONED),
    "wan_latency": dict(topology="wan_two_region", wan_latency_ticks=3,
                        **UNPARTITIONED),
}


def exact_equal(cfg, seeds: int, sparse: bool, dev, label: str) -> dict:
    """The exact kernels on the card equal the plain versions on the CPU
    tick by tick (every leaf, bitmap or ring, and the tick statistics)
    until every seed has converged, and in ``run_exact_headline``."""
    from corrosion_tpu_torch.convert import exact_state_to_numpy
    from corrosion_tpu_torch.kernels.tick_stats import CONVERGED, tick_stats
    from corrosion_tpu_torch.random import fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    gpu, base = exact_state_at(cfg, seeds, 0, sparse, dev)
    cpu, _ = exact_state_at(cfg, seeds, 0, sparse, "cpu")
    tick_fn = cal.frontier_exact_tick if sparse else cal.packed_exact_tick
    one = torch.ones(1, dtype=torch.int32)
    while gpu.tick < cfg.max_ticks:
        keys = [fold_in(k, gpu.tick) for k in base]
        gpu, cpu = tick_fn(gpu, keys, cfg), tick_fn(cpu, keys, cfg)
        a, b = exact_state_to_numpy(gpu), exact_state_to_numpy(cpu)
        for f in a:
            if not np.array_equal(a[f], b[f]):
                fail(f"{label}: card and CPU differ in {f} at tick "
                     f"{gpu.tick}")
        st = [tick_stats(s.infected.to(torch.int32).reshape(-1, 1),
                         one.to(s.infected.device), s.msgs.reshape(-1),
                         None, seeds).cpu() for s in (gpu, cpu)]
        if not torch.equal(torch.nan_to_num(st[0]), torch.nan_to_num(st[1])):
            fail(f"{label}: tick stats differ at tick {gpu.tick}")
        if bool((st[1][:, CONVERGED] == 1.0).all()):
            break
    kernel = "sparse" if sparse else "dense"
    runs = [cal.run_exact_headline(cfg, n_seeds=seeds, kernel=kernel,
                                   device=d) for d in (dev, "cpu")]
    for r in runs:
        for k in ("wall_s", "budget_bytes", "budget_source"):
            r.pop(k)
    if runs[0] != runs[1]:
        fail(f"{label}: run stats differ:\ncard {runs[0]}\ncpu  {runs[1]}")
    return {"ticks_compared": gpu.tick, "stats": runs[0]}


# -- anti-entropy (config #4) and SWIM churn (config #2) ------------------

# the reference's numbers on the CPU (seed 0): config #4 at 10k x 32
# seeds, config #2 at 64 nodes, and the 4096-node churn cycle, whose
# detection does not finish in the reference either
CONFIG4_WANT = dict(converged_frac=1.0, ticks_p50=32.0, ticks_p99=37.0,
                    msgs_per_node_mean=73.22553253173828, ticks_run=40)
CONFIG2_WANT = dict(detect_latency=15, rejoin_latency=4,
                    msgs_per_node_per_tick=4.982421875, ticks_run=64)
CHURN4096_WANT = dict(detect_latency=None, rejoin_latency=None,
                      msgs_per_node_per_tick=4.999860763549805,
                      ticks_run=128)
AE_TICKS = (1, 20)  # phase 8's anti-entropy ticks
SWIM_SIZES = (64, 4096)  # phase 8's SWIM clusters; the last is timed
SWIM_KERNELS = ("swim_probe_select", "swim_spread", "swim_gather",
                "swim_settle")


def ae_state_at(cfg, seeds: int, tick: int, dev):
    """Config ``cfg``'s seed-flattened carry after ``tick`` ticks of
    ``run_anti_entropy_seeds(seed=0)``, reached through the port on
    ``dev``."""
    from corrosion_tpu_torch.models.sync import seq_sync_step
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import antientropy as ae

    flat = replace(cfg, n_universes=seeds)
    bits, msgs = ae.anti_entropy_init(flat, device=dev)
    for t in range(tick):
        bits, msgs = seq_sync_step(bits, msgs, fold_in(PRNGKey(0), t),
                                   flat.params)
    return flat, bits, msgs


def seq_sync_checks(dev) -> list:
    """Phase 8a: ``seq_sync`` and ``seq_stats`` against their plain
    versions at config #4's full width (10k x 32 seeds) on the inputs
    of ticks ``AE_TICKS``, timed at the last (each call behind a
    GPU-side sleep, so the host's enqueue stays out of the time)."""
    from corrosion_tpu_torch.kernels import seq_sync as ks
    from corrosion_tpu_torch.random import (
        PRNGKey,
        fold_in,
        key_words,
        randint_span,
        split,
    )
    from corrosion_tpu_torch.sim.antientropy import CONFIG4, CONFIG4_SEEDS

    err_sync = err_stats = 0.0
    for tick in AE_TICKS:
        flat, bits, msgs = ae_state_at(CONFIG4, CONFIG4_SEEDS, tick - 1, dev)
        p = flat.params
        k_peers, k_drop = split(fold_in(PRNGKey(0), tick - 1))
        peer_keys = tuple(key_words(k) for k in split(k_peers))
        span, mult = randint_span(1, p.universe)
        args = (bits, msgs, peer_keys, key_words(k_drop), p.universe, span,
                mult)
        kw = dict(peers_per_round=p.peers_per_round,
                  seqs_per_chunk=p.seqs_per_chunk,
                  chunk_budget=p.chunk_budget, loss=p.loss,
                  handshake_msgs=p.handshake_msgs)
        got = ks.seq_sync(*args, **kw)
        want = ks.seq_sync_plain(*args, **kw)
        err_sync = max(err_sync, max_abs_err(got, want))
        s_got = ks.seq_stats(got[0], got[1], CONFIG4_SEEDS)
        s_want = ks.seq_stats_plain(got[0], got[1], CONFIG4_SEEDS,
                                    torch.empty_like(s_got))
        err_stats = max(err_stats, max_abs_err([s_got], [s_want]))
    # the kernel's other paths on random bitmaps: byte loads (S % 16 !=
    # 0), two 64-bit masks, several peers, lost chunks, budget cuts
    g = torch.Generator().manual_seed(3)
    for seqs, peers, budget, spc, loss in ((40, 3, 2, 4, 0.3),
                                           (128, 2, 32, 3, 0.5),
                                           (100, 1, 5, 8, 0.15)):
        n_small = 2000
        rb = (torch.rand((n_small, seqs), generator=g) < 0.4).to(dev)
        rm = torch.randint(0, 50, (n_small,), generator=g,
                           dtype=torch.int32).to(dev)
        span_s, mult_s = randint_span(1, 500)
        sargs = (rb, rm, peer_keys, key_words(k_drop), 500, span_s, mult_s)
        skw = dict(peers_per_round=peers, seqs_per_chunk=spc,
                   chunk_budget=budget, loss=loss, handshake_msgs=3)
        err_sync = max(err_sync, max_abs_err(
            ks.seq_sync(*sargs, **skw), ks.seq_sync_plain(*sargs, **skw)))
        s_got = ks.seq_stats(rb, rm, 4)
        err_stats = max(err_stats, max_abs_err(
            [s_got], [ks.seq_stats_plain(rb, rm, 4, torch.empty_like(s_got))]))
    if err_sync != 0.0 or err_stats != 0.0:
        fail(f"seq_sync / seq_stats differ from their plain versions "
             f"(max |diff| {err_sync}, {err_stats})")
    n, seqs = bits.shape
    s_got = ks.seq_stats(got[0], got[1], CONFIG4_SEEDS)
    out = torch.empty_like(s_got)
    shape = (f"{CONFIG4_SEEDS} seeds x {CONFIG4.n_nodes}, {seqs} seqs, "
             f"tick {AE_TICKS[-1]}")
    res = [
        dict(name="seq_sync", route="cuda",
             source="corrosion_tpu_torch/kernels/csrc/seq_sync.cu",
             replaces="corrosion_tpu/models/sync.py:167",
             max_abs_err=err_sync,
             ms=time_inplace_ms(lambda: None,
                                lambda: ks.seq_sync(*args, **kw), 20),
             plain_ms=time_ms(lambda: ks.seq_sync_plain(*args, **kw), 3),
             # own row, one peer row per draw, the written row; msgs read
             # and written
             bound=(n * seqs * (2 + p.peers_per_round) + 8 * n, 0),
             library_ms=None, shape=shape),
        dict(name="seq_stats", route="cuda",
             source="corrosion_tpu_torch/kernels/csrc/seq_sync.cu",
             replaces="corrosion_tpu/sim/antientropy.py:77",
             max_abs_err=err_stats,
             ms=time_inplace_ms(lambda: None, lambda: ks.seq_stats(
                 got[0], got[1], CONFIG4_SEEDS, out=out), 20),
             plain_ms=time_ms(lambda: ks.seq_stats_plain(
                 got[0], got[1], CONFIG4_SEEDS, out), 3),
             bound=(nbytes(got[0], got[1], out), 0),
             library_ms=None, shape=shape),
    ]
    for r in res:
        set_bound(r)
    return res


def churn_state_at(cfg, tick: int, dev, **overrides):
    """``run_churn(cfg)``'s state before tick ``tick`` (through the port
    on ``dev``, ``cfg.params`` with ``overrides``), the params, and the
    tick's (key, alive, revived, victim)."""
    from corrosion_tpu_torch.models.swim import swim_init, swim_step
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim.churn import _schedule

    params = replace(cfg.params, **overrides)

    def inputs(t):
        victim, dead, rev = _schedule(cfg, t)
        alive = torch.ones(cfg.n_nodes, dtype=torch.bool, device=dev)
        revived = torch.zeros(cfg.n_nodes, dtype=torch.bool, device=dev)
        alive[victim] = not dead
        revived[victim] = rev
        return fold_in(PRNGKey(0), t), alive, revived, victim

    state = swim_init(cfg.n_nodes, device=dev)
    for t in range(tick):
        key, alive, revived, _ = inputs(t)
        state = swim_step(state, key, t, params, alive, revived=revived)
    return state, params, inputs(tick)


def crafted_tie_state(n: int):
    """A state whose update_tx + uniform scores tie in most entries
    (update_tx at 2**24 and 2**24 + 2, a limit far above): the selection
    must break ties by the lower index first."""
    from corrosion_tpu_torch.models.swim import SwimState

    g = torch.Generator().manual_seed(11)
    base = 2**24
    return SwimState(
        view=torch.randint(0, 3, (n, n), generator=g, dtype=torch.int32),
        suspect_since=torch.full((n, n), 2**31 - 1, dtype=torch.int32),
        incarnation=torch.zeros(n, dtype=torch.int32),
        msgs=torch.zeros(n, dtype=torch.int32),
        update_tx=base + 2 * torch.randint(0, 2, (n, n), generator=g,
                                           dtype=torch.int32),
    )


def swim_kernel_checks(dev):
    """Phase 8b: the SWIM kernels against their plain version on the
    card, every leaf and the victim counters bitwise, at N = 64 and
    4096: a tick during suspicion, the revive tick, a loss = 0.15 run,
    a run without gossip targets (no gossip pass) and a crafted-tie
    state at the widest gossip the kernel takes (``MAX_ENTRIES``); each
    kernel timed at N = 4096's suspicion tick (CUDA events around each
    launch, the host's enqueue hidden behind a GPU-side sleep)."""
    from corrosion_tpu_torch.kernels import swim as ksw
    from corrosion_tpu_torch.models.swim import SwimState
    from corrosion_tpu_torch.sim.churn import ChurnConfig

    checks, timed = [], None
    for n in SWIM_SIZES:
        cfg = ChurnConfig(n_nodes=n)
        cases = [("suspicion", cfg.kill_tick + 3, {}),
                 ("revive", cfg.revive_tick, {}),
                 ("loss_0.15", cfg.kill_tick + 6, dict(loss=0.15)),
                 ("no_gossip_targets", cfg.kill_tick + 3,
                  dict(gossip_targets=0))]
        for label, tick, overrides in cases:
            state, params, (key, alive, revived, victim) = churn_state_at(
                cfg, tick, dev, **overrides)
            fa = torch.zeros(2, dtype=torch.int32, device=dev)
            fb = torch.zeros_like(fa)
            got = ksw.swim_tick(*state, key, tick, params, alive, revived,
                                victim=victim, flags=fa)
            want = ksw.swim_tick_plain(*state, ksw.tick_keys(key), tick,
                                       params, alive, revived, victim, fb)
            err = max_abs_err([*got, fa], [*want, fb])
            checks.append(dict(n=n, case=label, tick=tick, max_abs_err=err,
                               differs=[f for f, x, y in zip(
                                   SwimState._fields, got, want)
                                   if not torch.equal(x, y)],
                               flags=fa.tolist()))
            if n == SWIM_SIZES[-1] and label == "suspicion":
                timed = swim_times(ksw, state, key, tick, params, alive,
                                   revived)
        tie = SwimState(*(t.to(dev) for t in crafted_tie_state(n)))
        params = replace(cfg.params, update_tx_limit=2**30, loss=0.15,
                         gossip_entries=ksw.MAX_ENTRIES)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        got = ksw.swim_tick(*tie, key, 3, params, alive)
        want = ksw.swim_tick_plain(*tie, ksw.tick_keys(key), 3, params,
                                   alive)
        checks.append(dict(n=n, case="crafted_ties", tick=3,
                           max_abs_err=max_abs_err(got, want),
                           differs=[f for f, x, y in zip(
                               SwimState._fields, got, want)
                               if not torch.equal(x, y)]))
    for c in checks:
        if c["max_abs_err"] != 0.0 or c["differs"]:
            fail(f"swim kernels differ from their plain version: {c}")
    err = max(c["max_abs_err"] for c in checks)
    res = []
    for name, line in (("swim_probe_select", 108), ("swim_spread", 233),
                       ("swim_gather", 253), ("swim_settle", 277)):
        t = timed[name]
        res.append(dict(
            name=name, route="cuda",
            source="corrosion_tpu_torch/kernels/csrc/swim.cu",
            replaces=f"corrosion_tpu/models/swim.py:{line}",
            max_abs_err=err, ms=t["ms"], plain_ms=timed["plain_ms"],
            bound=t["bound"], library_ms=None,
            shape=f"N = {SWIM_SIZES[-1]}, tick {cfg.kill_tick + 3}, "
                  f"{t['launches']} launch(es) a tick; plain_ms is the "
                  "whole tick's"))
        set_bound(res[-1])
    return res, checks, timed


def swim_times(ksw, state, key, tick, params, alive, revived,
               reps: int = 10) -> dict:
    """Device ms of each kernel's launch (mean over ``reps`` ticks on the
    same inputs and over its launches in a tick), the whole tick's ms
    and the plain version's, with each kernel's bound from this tick's
    data (bytes, INT32-pipe operations; a launch's mean where a tick
    launches it more than once)."""
    from corrosion_tpu_torch.kernels.threefry import threefry_bits_plain
    from corrosion_tpu_torch.models.common import peers_from_offsets
    from corrosion_tpu_torch.random import randint_span

    n = state.view.shape[0]
    keys = ksw.tick_keys(key)
    order = ksw.launch_order(params.gossip_targets)
    names = [fn.__name__ for fn, _ in order]
    per = dict.fromkeys(SWIM_KERNELS, 0.0)
    tick_ms = 0.0
    for r in range(reps + 1):
        launch = ksw.prepare(*state, keys, tick, params, alive, revived)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(order) + 1)]
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)  # covers the seven enqueues
        events[0].record()
        for (fn, extra), ev in zip(order, events[1:]):
            fn(launch, *extra)
            ev.record()
        torch.cuda.synchronize()
        if r == 0:
            continue  # warm
        for name, a, b in zip(names, events, events[1:]):
            per[name] += a.elapsed_time(b) / reps
        tick_ms += events[0].elapsed_time(events[-1]) / reps
    plain_ms = time_ms(lambda: ksw.swim_tick_plain(
        *state, keys, tick, params, alive, revived), 3)

    # what this tick's data makes each kernel move
    w = launch.work
    mat = 4 * n * n  # one [N, N] int32 leaf
    entries = w["ge"].numel()
    sendable = w["sendable"].bool()
    g = params.gossip_targets
    span, mult = randint_span(1, max(n, 2))
    offs = torch.empty((n, g), dtype=torch.int32, device=state.view.device)
    threefry_bits_plain(offs, *keys["gt"], span=span, mult=mult, minval=1)
    gt = peers_from_offsets(offs, n).long()
    ok = (alive[:, None, None] & alive[gt][:, :, None]
          & sendable[:, None, :])
    if params.loss > 0.0:
        u = torch.empty(ok.shape, dtype=torch.float32, device=ok.device)
        ok &= threefry_bits_plain(u, keys["gloss"]) >= params.loss
    probe = w["probe"].long()
    per_row = sendable.sum(dim=1)
    scatters = {  # cells each pass scatters into
        ksw.GOSSIP: int(ok.sum()),
        ksw.PING: int(((probe & 1) * per_row).sum()),
        ksw.ACK: int((((probe >> 1) & 1) * per_row[w["target"].long()]).sum()),
    }
    spreads = [extra[0] for fn, extra in order if fn is ksw.swim_spread]
    hashed = int((state.update_tx < params.update_tx_limit).sum())
    bounds = {
        # the three inputs read, the view written, the selection written;
        # a tie uniform for each cell under the retransmission limit
        "swim_probe_select": (4 * mat + entries * 9,
                              hashed * INT_PIPE_OPS_PER_UNIFORM),
        # the selection and payload read (ge, sendable, pay), a sector
        # for each cell scattered into
        "swim_spread": (sum(entries * 9 + scatters[mode] * SECTOR
                            for mode in spreads) / len(spreads), 0),
        # ge read, the payload written, a sector for each gathered cell
        "swim_gather": (entries * (8 + SECTOR), 0),
        # the tick's and the input view, suspect_since and update_tx
        # read, suspect_since and update_tx written, the selection read
        "swim_settle": (6 * mat + entries * 5, 0),
    }
    launches = {name: names.count(name) for name in SWIM_KERNELS}
    return {
        **{name: dict(ms=per[name] / launches[name], bound=bounds[name],
                      launches=launches[name]) for name in SWIM_KERNELS},
        "tick_ms": tick_ms, "plain_ms": plain_ms, "scatters": scatters,
    }


def full_width_paths(counted) -> dict:
    """Phase 9: config #4 (10k x 32 seeds), config #2 (64 nodes) and the
    4096-node churn cycle through their entry points on the card, the
    launch counters zeroed just before each; each held to the
    reference's numbers."""
    from corrosion_tpu_torch.sim.antientropy import (
        CONFIG4,
        CONFIG4_SEEDS,
        run_anti_entropy_seeds,
    )
    from corrosion_tpu_torch.sim.churn import ChurnConfig, run_churn

    runs = {}
    for label, run, want, kernels_ in (
        ("config4", lambda: run_anti_entropy_seeds(
            CONFIG4, n_seeds=CONFIG4_SEEDS, seed=0, device="cuda"),
         CONFIG4_WANT, ("seq_sync", "seq_stats")),
        ("config2", lambda: run_churn(ChurnConfig(n_nodes=64), seed=0,
                                      device="cuda"),
         CONFIG2_WANT, SWIM_KERNELS),
        ("churn4096", lambda: run_churn(ChurnConfig(n_nodes=4096), seed=0,
                                        device="cuda"),
         CHURN4096_WANT, SWIM_KERNELS),
    ):
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t0
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["launches"] = {name: counted[name].launches
                           for name in kernels_}
        runs[label] = res
        print(f"{label}: " + json.dumps(res), flush=True)
        for k, v in want.items():
            ok = (res[k] == v if not isinstance(v, float)
                  else math.isclose(res[k], v, rel_tol=1e-6))
            if not ok:
                fail(f"{label}: {k} = {res[k]}, the reference gives {v}")
        idle = [name for name, c in res["launches"].items() if c == 0]
        if idle:
            fail(f"{label}: kernels never launched: {idle}")
    return runs


def ae_equal(cfg, seeds: int, dev, label: str) -> dict:
    """Anti-entropy on the card == the plain path on the CPU: carry and
    statistics every tick until every seed has converged, and the run's
    stats."""
    from corrosion_tpu_torch.kernels.seq_sync import CONVERGED, seq_stats
    from corrosion_tpu_torch.models.sync import seq_sync_step
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import antientropy as ae

    flat = replace(cfg, n_universes=seeds)
    gpu = ae.anti_entropy_init(flat, device=dev)
    cpu = ae.anti_entropy_init(flat, device="cpu")
    tick = 0
    while tick < cfg.max_ticks:
        key = fold_in(PRNGKey(0), tick)
        gpu = seq_sync_step(*gpu, key, flat.params)
        cpu = seq_sync_step(*cpu, key, flat.params)
        tick += 1
        for x, y in zip(gpu, cpu):
            if not torch.equal(x.cpu(), y):
                fail(f"{label}: card and CPU differ at tick {tick}")
        sg, sc = seq_stats(*gpu, seeds).cpu(), seq_stats(*cpu, seeds)
        if not torch.equal(sg, sc):
            fail(f"{label}: tick stats differ at tick {tick}")
        if bool((sc[:, CONVERGED] == 1.0).all()):
            break
    runs = [ae.run_anti_entropy_seeds(cfg, n_seeds=seeds, device=d)
            for d in (dev, "cpu")]
    for r in runs:
        r.pop("wall_s")
    if runs[0] != runs[1]:
        fail(f"{label}: stats differ:\ncard {runs[0]}\ncpu  {runs[1]}")
    return {"ticks_compared": tick, "stats": runs[0]}


def churn_equal(cfg, dev, label: str) -> dict:
    """SWIM on the card == the plain path on the CPU: every leaf and the
    detection flags every tick of ``run_churn_cycles``' schedule, and
    the run's stats."""
    from corrosion_tpu_torch.models.swim import swim_init
    from corrosion_tpu_torch.random import PRNGKey
    from corrosion_tpu_torch.sim import churn as ch

    total = cfg.cycles * cfg.cycle_period + cfg.cycle_period // 2
    total = -(-total // cfg.chunk_ticks) * cfg.chunk_ticks
    key = PRNGKey(0)
    gpu = swim_init(cfg.n_nodes, device=dev)
    cpu = swim_init(cfg.n_nodes, device="cpu")
    one = replace(cfg, chunk_ticks=1)
    for t in range(total):
        gpu, fg = ch._scan_chunk(gpu, key, t, one)
        cpu, fc = ch._scan_chunk(cpu, key, t, one)
        for f, x, y in zip(gpu._fields, gpu, cpu):
            if not torch.equal(x.cpu(), y):
                fail(f"{label}: card and CPU differ in {f} at tick {t}")
        if any((a != b).any() for a, b in zip(fg, fc)):
            fail(f"{label}: detection flags differ at tick {t}")
    runs = [ch.run_churn_cycles(cfg, device=d) for d in (dev, "cpu")]
    for r in runs:
        r.pop("wall_s")
    if runs[0] != runs[1]:
        fail(f"{label}: stats differ:\ncard {runs[0]}\ncpu  {runs[1]}")
    return {"ticks_compared": total, "stats": runs[0]}


# -- the exact sent_to sampler (calibration and track_sent) ---------------

SENT_SOURCE = "corrosion_tpu_torch/kernels/csrc/sent_sampler.cu"
SENT_KERNELS = ("sent_select", "sent_commit")
# CALIB_MSGS.json's points, which the reference reproduces digit for digit
CALIB_WANT = [
    dict(n=1000, msgs_exact=10.04, msgs_perm=6.26, exact_over_perm=1.604,
         exact_converged_ticks=[7, 7, 7], perm_ticks_p50=6.0, seeds=3),
    dict(n=4000, msgs_exact=10.6, msgs_perm=6.8, exact_over_perm=1.558,
         exact_converged_ticks=[8, 8, 8], perm_ticks_p50=7.0, seeds=3),
    dict(n=16000, msgs_exact=12.41, msgs_perm=7.34, exact_over_perm=1.69,
         exact_converged_ticks=[10, 9, 9], perm_ticks_p50=8.0, seeds=3),
]
# SIMDIFF_N64/256/512.json's "sim" numbers (sim_trace, 8 seeds, no sync)
SIMDIFF_WANT = {
    64: dict(converged_frac=1.0, ticks_p50=6.0, ticks_p99=7.0,
             msgs_per_node_mean=4.53515625, hops_p50=3.0,
             hops_p99=4.921249866485596),
    256: dict(converged_frac=1.0, ticks_p50=12.0, ticks_p99=13.0,
              msgs_per_node_mean=6.9990234375, hops_p50=4.0, hops_p99=6.0),
    512: dict(converged_frac=1.0, ticks_p50=12.5, ticks_p99=14.0,
              msgs_per_node_mean=7.301513671875, hops_p50=4.125,
              hops_p99=6.875),
}
# sim_obs_trace's config (sync every 8 ticks, 16-tick chunks) at 512
# nodes x 8 seeds: the reference's numbers on the CPU (seed 0)
OBS512_WANT = dict(converged_frac=1.0, ticks_p50=8.0, ticks_p99=8.0,
                   msgs_per_node_mean=6.52197265625,
                   msgs_per_node_p99=10.361244201660156, hops_p50=4.125,
                   hops_p99=6.875, hops_broadcast_frac=0.9912109375)
SENT_CHECK_TICK = 4  # phase 11's broadcast tick: the partition holds
SENT_FAULTS = dict(loss=0.1, partition_blocks=2, heal_tick=8,
                   oneway_blocks=((0, 1),))


def sent_variants(n: int) -> dict:
    """The track_sent configs of phases 11 and 13 at ``n`` nodes:
    sim_trace's, two variants with 10% loss, a one-way partition in
    force until tick 8 and hops, on the WAN and the tiered topology,
    and sim_obs_trace's (sync every 8 ticks)."""
    from corrosion_tpu_torch.sim.epidemic import sent_trace_cfg

    base = sent_trace_cfg(n)
    return {
        "sim_trace": base,
        "wan_faults": replace(base, topology="wan_two_region",
                              **SENT_FAULTS),
        "het_ring_faults": replace(base, topology="het_ring",
                                   **SENT_FAULTS),
        "obs_sync": sent_trace_cfg(n, sync_interval=8, chunk_ticks=16),
    }


def clone_state(state):
    return type(state)(*(x.clone() if isinstance(x, torch.Tensor) else x
                         for x in state))


def calib_check_states(cfg, dev):
    """Seed 0 of ``run_exact(cfg)`` advanced on the card: the inputs of
    tick 1 and of the tick with the most active rows (clones)."""
    from corrosion_tpu_torch.kernels.sent_sampler import active_rows
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    key = PRNGKey(0)
    state = cal.exact_init(cfg, device=dev)
    picked, best = {}, (-1, None)
    while not bool(state.infected.all()) and state.tick < cfg.max_ticks:
        active = int(active_rows(state.tx, state.next_send, state.tick,
                                 state.infected).sum())
        if state.tick == 1:
            picked[1] = clone_state(state)
        if active > best[0]:
            best = (active, clone_state(state))
        state = cal.exact_tick(state, fold_in(key, state.tick), cfg)
    picked[best[1].tick] = best[1]
    return key, picked


def tied_rows(select) -> int:
    """Active rows of a calibration tick whose k + 1 smallest scores
    hold a tie (the order among equal scores decides a target)."""
    from corrosion_tpu_torch.kernels.sent_sampler import (
        active_rows,
        chunk_scores,
    )

    sent = select["sent"][0]
    keys = select["keys"][0].tolist()
    c, k = select["chunk"], select["fanout"]
    active = active_rows(select["tx"], select["next_send"], select["tick"],
                         select["infected"])[0]
    ties = 0
    for ck, start in enumerate(range(0, sent.shape[0], c)):
        sc = chunk_scores(sent[start:start + c], tuple(keys[ck]), start)
        v = torch.topk(sc, k + 1, dim=1, largest=False).values
        tie = ((v[:, 1:] == v[:, :-1]) & (v[:, 1:] < math.inf)).any(dim=1)
        ties += int((tie & active[start:start + c]).sum())
        del sc, v
    return ties


def sent_kernel_checks(dev):
    """Phase 11: ``sent_select`` and ``sent_commit`` against their plain
    versions on the card at the main path's shapes, every output leaf
    bitwise (``sent``, the counts and the fresh buffers included):
    calibration at ``ExactConfig(16000)`` seed 0, ticks 1 and the
    busiest tick (which must hold tied scores); broadcast at 512 nodes x
    8 seeds on the sim_trace config and two fault variants at a tick
    where the partition holds.  Times both kernels behind a GPU-side
    sleep."""
    from corrosion_tpu_torch.kernels import sent_sampler as ss
    from corrosion_tpu_torch.models.broadcast import sent_inputs
    from corrosion_tpu_torch.random import PRNGKey, fold_in, split
    from corrosion_tpu_torch.sim import calibrate as cal
    from corrosion_tpu_torch.sim.epidemic import (
        _partition_ids,
        sent_seeds_init,
        sent_seeds_tick,
    )

    errs = {name: 0.0 for name in SENT_KERNELS}
    checks, timed = [], {}

    def compare(label, kernel, got, want, names):
        err = max_abs_err(got, want)
        errs[kernel] = max(errs[kernel], err)
        bad = [nm for nm, x, y in zip(names, got, want)
               if (x is None) != (y is None)
               or x is not None and not torch.equal(x, y)]
        return err, bad

    def run_pair(mode, select, commit):
        sent_k, sent_p = select["sent"].clone(), select["sent"].clone()
        got = ss.sent_select(**{**select, "sent": sent_k})
        want = ss.sent_select_plain(**{**select, "sent": sent_p})
        sel_names = (("new_infected", "counts") if mode == "calibration"
                     else ("new_rows", "cand", "counts"))
        err, bad = compare(mode, "sent_select", [*got, sent_k],
                           [*want, sent_p], [*sel_names, "sent"])
        if mode == "calibration":
            extra = dict(new_infected=got[0])
        else:
            extra = dict(new_rows=got[0], cand=got[1])
        c_got = ss.sent_commit(got[-1], **extra, **commit)
        c_want = ss.sent_commit_plain(got[-1], **extra, **commit)
        c_names = (("tx", "next_send", "msgs") if mode == "calibration"
                   else ("tx", "msgs", "hops", "next_send"))
        c_err, c_bad = compare(mode, "sent_commit", list(c_got),
                               list(c_want), c_names)
        active = int(ss.active_rows(select["tx"], select["next_send"],
                                    select["tick"],
                                    select.get("infected")).sum())
        return dict(max_abs_err=err, differs=bad, commit_max_abs_err=c_err,
                    commit_differs=c_bad, active_rows=active,
                    sends=int(got[-1].sum())), got

    # -- calibration mode: ExactConfig(16000), seed 0
    ccfg = cal.ExactConfig(16000)
    key, states = calib_check_states(ccfg, dev)
    ties_total = 0
    for tick, state in sorted(states.items()):
        select, commit = cal.exact_inputs(state, fold_in(key, tick), ccfg)
        ties = tied_rows(select)
        ties_total += ties
        rec, got = run_pair("calibration", select, commit)
        rec.update(mode="calibration", n=ccfg.n_nodes, seeds=1, tick=tick,
                   tied_rows=ties)
        checks.append(rec)
        if tick > 1:
            timed.update(sent_times(ss, "calibration", select, commit, got,
                                    rec, ccfg.n_nodes, 1))
        del select, commit, got
        torch.cuda.empty_cache()
    del states
    if ties_total == 0:
        fail("phase 11: no active row held a tied score in its k + 1 "
             "smallest: the tie path did not run")

    # -- broadcast mode: 512 nodes x 8 seeds at SENT_CHECK_TICK
    for label, cfg in sent_variants(512).items():
        if label == "obs_sync":
            continue  # its broadcast phase is sim_trace's; phase 13 runs it
        seed_keys = list(split(PRNGKey(0), 8))
        state = sent_seeds_init(cfg, 8, device=dev)
        while state.tick < SENT_CHECK_TICK:
            state = sent_seeds_tick(
                state, [fold_in(k, state.tick) for k in seed_keys], cfg)
        pairs = []
        for k in seed_keys:
            k_b, _ = split(fold_in(k, state.tick))
            pairs.append(tuple(split(k_b)))
        select, commit = sent_inputs(
            state.rows, state.tx_remaining, state.msgs, state.hops,
            state.tick, state.next_send, state.sent, pairs,
            cfg.broadcast_params, _partition_ids(cfg, dev),
            state.tick < cfg.heal_tick)
        rec, got = run_pair("broadcast", select, commit)
        rec.update(mode="broadcast", variant=label, n=cfg.n_nodes, seeds=8,
                   tick=state.tick,
                   partition_in_force=state.tick < cfg.heal_tick)
        checks.append(rec)
        if label == "sim_trace":
            timed.update(sent_times(ss, "broadcast", select, commit, got,
                                    rec, cfg.n_nodes, 8))
            # the int64 keys of a wide codec (WIDE_CODEC), on the same
            # inputs moved into the high word
            wide = select["rows"].to(torch.int64) * (1 << 32) + 7
            rec, _ = run_pair("broadcast", {**select, "rows": wide},
                              {**commit, "rows": wide})
            rec.update(mode="broadcast", variant="sim_trace_int64",
                       n=cfg.n_nodes, seeds=8, tick=state.tick)
            checks.append(rec)
    for c in checks:
        if c["differs"] or c["commit_differs"]:
            fail(f"sent kernels differ from their plain versions: {c}")
    results = []
    for name, replaces in (
        ("sent_select", "corrosion_tpu/sim/calibrate.py:71"),
        ("sent_commit", "corrosion_tpu/sim/calibrate.py:105"),
    ):
        t = timed[f"{name}/calibration"]
        results.append(dict(
            name=name, route="cuda", source=SENT_SOURCE, replaces=replaces,
            max_abs_err=errs[name], library_ms=None,
            ms=t["ms"], plain_ms=t["plain_ms"], bound=t["bound"],
            shape=t["shape"]))
        set_bound(results[-1])
    for t in timed.values():
        b, ops = t["bound"]
        t["bound_ms"] = max(b / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
    return results, checks, timed


def sent_times(ss, mode, select, commit, got, rec, n, seeds) -> dict:
    """Times of ``sent_select`` and ``sent_commit`` (kernel and plain) on
    one tick's inputs, with their bounds: (bytes, INT32-pipe
    operations)."""
    work = select["sent"].clone()

    def restore():
        work.copy_(select["sent"])

    sel = {**select, "sent": work}
    total, active, sends = seeds * n, rec["active_rows"], rec["sends"]
    k = select["fanout"]
    calib = mode == "calibration"
    if calib:
        extra = dict(new_infected=got[0])
        # activity reads, new_infected and counts written, the active
        # rows' sent rows, and a sector each for a mark and an infection
        sel_bytes = total * (9 + 5) + active * n + sends * 2 * SECTOR
        draws = active * n
        com_bytes = total * (18 + 12)
    else:
        r = select["rows"].shape[2] * select["rows"].element_size()
        extra = dict(new_rows=got[0], cand=got[1])
        # activity reads; new rows, counts and hop candidates written;
        # the active rows' sent rows and own keys; a sector for a mark
        # and one for each merged row
        sel_bytes = (total * (8 + r + 8) + active * (n + r + 4)
                     + sends * 2 * SECTOR)
        draws = active * n + active * k * ((select["loss"] > 0)
                                           + (select["region"] is not None))
        com_bytes = total * (2 * r + 24 + 16)
    out = {}
    out[f"sent_select/{mode}"] = dict(
        ms=time_inplace_ms(restore, lambda: ss.sent_select(**sel), 20),
        plain_ms=time_inplace_ms(restore,
                                 lambda: ss.sent_select_plain(**sel), 1, 1),
        bound=(sel_bytes, draws * INT_PIPE_OPS_PER_UNIFORM),
        shape=f"{mode} {seeds} x {n}, tick {select['tick']}, "
              f"{active} active rows, {sends} sends")
    out[f"sent_commit/{mode}"] = dict(
        ms=time_inplace_ms(lambda: None,
                           lambda: ss.sent_commit(got[-1], **extra, **commit),
                           20),
        plain_ms=time_inplace_ms(
            lambda: None,
            lambda: ss.sent_commit_plain(got[-1], **extra, **commit), 3),
        bound=(com_bytes, 0),
        shape=f"{mode} {seeds} x {n}, tick {select['tick']}")
    return out


# every run of phase 12 launches these; the calibration's perm column
# and the sync variant also draw through threefry_bits
SENT_COUNTED = ("sent_select", "sent_commit", "tick_stats")


def sent_full_width(counted) -> dict:
    """Phase 12: ``run_msgs_calibration`` at N = 1000, 4000 and 16000 x 3
    seeds, the sim_trace config at 64, 256 and 512 nodes x 8 seeds and
    sim_obs_trace's (sync) at 512 x 8 through their entry points on the
    card, the launch counters zeroed just before each; each held to the
    reference's numbers."""
    from corrosion_tpu_torch.sim.calibrate import run_msgs_calibration
    from corrosion_tpu_torch.sim.epidemic import (
        run_epidemic_seeds,
        sent_trace_cfg,
    )

    jobs = [("calibration", lambda: run_msgs_calibration(
        ns=(1000, 4000, 16000), seeds=3, device="cuda"), None,
        ("threefry_bits",))]
    for n in SIMDIFF_WANT:
        jobs.append((f"sim_trace_{n}", lambda n=n: run_epidemic_seeds(
            sent_trace_cfg(n), n_seeds=8, seed=0, device="cuda"),
            SIMDIFF_WANT[n], ()))
    jobs.append(("obs_sync_512", lambda: run_epidemic_seeds(
        sent_trace_cfg(512, sync_interval=8, chunk_ticks=16), n_seeds=8,
        seed=0, device="cuda"), OBS512_WANT, ("threefry_bits", "sync_pull")))
    runs = {}
    for label, run, want, more in jobs:
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t0
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["launches"] = {name: counted[name].launches
                           for name in SENT_COUNTED + more}
        runs[label] = res
        print(f"{label}: " + json.dumps(res), flush=True)
        if want is None:
            if res["points"] != CALIB_WANT:
                fail(f"calibration points differ from CALIB_MSGS.json: "
                     f"{res['points']}")
        else:
            for k, v in want.items():
                if not math.isclose(res[k], v, rel_tol=1e-6):
                    fail(f"{label}: {k} = {res[k]}, the reference gives {v}")
        idle = [name for name, c in res["launches"].items() if c == 0]
        if idle:
            fail(f"{label}: kernels never launched: {idle}")
    return runs


def calib_equal(cfg, dev, label: str) -> dict:
    """``exact_tick`` on the card == on the CPU, every leaf every tick
    of seed 0's run, and the ``run_exact`` results."""
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    key = PRNGKey(0)
    gpu = cal.exact_init(cfg, device=dev)
    cpu = cal.exact_init(cfg, device="cpu")
    while not bool(cpu.infected.all()) and cpu.tick < cfg.max_ticks:
        k = fold_in(key, cpu.tick)
        gpu, cpu = cal.exact_tick(gpu, k, cfg), cal.exact_tick(cpu, k, cfg)
        if not states_equal(gpu, cpu):
            fail(f"{label}: card and CPU differ at tick {cpu.tick}")
    runs = [cal.run_exact(cfg, seed=0, device=d) for d in (dev, "cpu")]
    for r in runs:
        r.pop("wall_s")
    if runs[0] != runs[1]:
        fail(f"{label}: results differ:\ncard {runs[0]}\ncpu  {runs[1]}")
    return {"ticks_compared": cpu.tick, "stats": runs[0]}


def track_sent_equal(cfg, seeds: int, dev, label: str) -> dict:
    """The ``track_sent`` runner's tick on the card == on the CPU, every
    leaf and the tick statistics every tick until every seed has
    converged, and the ``run_epidemic_seeds`` stats."""
    from corrosion_tpu_torch.kernels.tick_stats import CONVERGED, tick_stats
    from corrosion_tpu_torch.random import PRNGKey, fold_in, split
    from corrosion_tpu_torch.sim.epidemic import (
        run_epidemic_seeds,
        sent_seeds_init,
        sent_seeds_tick,
    )

    seed_keys = list(split(PRNGKey(0), seeds))
    gpu = sent_seeds_init(cfg, seeds, device=dev)
    cpu = sent_seeds_init(cfg, seeds, device="cpu")
    n, r = cfg.n_nodes, cfg.n_rows
    target = cpu.rows[0, 0].clone()

    def stats(st):
        hops = None if st.hops is None else st.hops.reshape(-1)
        return tick_stats(st.rows.reshape(-1, r), target.to(st.rows.device),
                          st.msgs.reshape(-1), hops, seeds).cpu()

    while cpu.tick < cfg.max_ticks:
        keys = [fold_in(k, cpu.tick) for k in seed_keys]
        gpu = sent_seeds_tick(gpu, keys, cfg)
        cpu = sent_seeds_tick(cpu, keys, cfg)
        if not states_equal(gpu, cpu):
            fail(f"{label}: card and CPU differ at tick {cpu.tick}")
        sg, sc = stats(gpu), stats(cpu)
        if not torch.equal(torch.nan_to_num(sg), torch.nan_to_num(sc)):
            fail(f"{label}: tick stats differ at tick {cpu.tick}")
        if bool((sc[:, CONVERGED] == 1.0).all()):
            break
    runs = [run_epidemic_seeds(cfg, n_seeds=seeds, seed=0, device=d)
            for d in (dev, "cpu")]
    for x in runs:
        x.pop("wall_s")
    if runs[0] != runs[1]:
        fail(f"{label}: stats differ:\ncard {runs[0]}\ncpu  {runs[1]}")
    return {"ticks_compared": cpu.tick, "nodes": n, "stats": runs[0]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.kernels import deliver, exact_send, seq_sync
    from corrosion_tpu_torch.kernels import sent_sampler, swim, sync_pull
    from corrosion_tpu_torch.kernels import threefry, tick_stats
    from corrosion_tpu_torch.sim.epidemic import (
        HEADLINE,
        HEADLINE_SEEDS,
        run_epidemic_seeds,
    )

    mods = (threefry, deliver, sync_pull, tick_stats)
    counted = {fn.__name__: fn for fn in (
        threefry.threefry_bits, deliver.deliver_perm, sync_pull.sync_pull,
        tick_stats.tick_stats, exact_send.exact_send,
        exact_send.exact_commit, seq_sync.seq_sync, seq_sync.seq_stats,
        swim.swim_probe_select, swim.swim_spread, swim.swim_gather,
        swim.swim_settle, sent_sampler.sent_select,
        sent_sampler.sent_commit)}
    headline_counted = ("threefry_bits", "deliver_perm", "sync_pull",
                        "tick_stats")
    record = {}
    cuda = torch.device("cuda")

    # phase 1: the card, then the build
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    logs = kernels.build()
    record["build_s"] = time.perf_counter() - t0
    record["ptxas"] = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for name, log in logs.items()
    }
    print(f"built {sorted(logs)} in {record['build_s']:.1f} s", flush=True)
    record["threefry_sass"] = sass_mix(kernels, "threefry")

    headline, seeds = HEADLINE, HEADLINE_SEEDS

    # phase 2: the perm-fanout kernels against their plain versions, and
    # the stable sort they leave to torch.sort
    results = kernel_checks(replace(headline, n_universes=seeds), mods,
                            cuda)
    record["sort"] = sort_times(cuda)
    print("kernels match their plain versions: "
          + ", ".join(f"{r['name']} {r['max_abs_err']}" for r in results)
          + "; torch.sort " + json.dumps(record["sort"]), flush=True)

    # phase 3: the headline on the card, counters from this run only
    run_epidemic_seeds(replace(headline, n_nodes=1000, max_ticks=16),
                       n_seeds=2, device="cuda")  # warm the allocator
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = run_epidemic_seeds(headline, n_seeds=seeds, seed=0,
                               device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: counted[name].launches for name in headline_counted}
    stats["device"] = torch.cuda.get_device_name(0)
    stats["card"] = card
    stats["run_s"] = wall
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for r in results:
        r["launches"] = launches[r["name"]]
    record.update(card=card, headline=stats)
    if stats["converged_frac"] != 1.0:
        fail(f"headline did not converge: {stats}")
    idle = [name for name, c in launches.items() if c == 0]
    if idle:
        fail(f"kernels never launched on the main path: {idle}")

    # phase 4: kernels on the card == plain versions on the CPU
    record["small"] = run_equal(replace(headline, n_nodes=4096), 4, cuda,
                                "4096-node run")
    for name, kw in VARIANTS.items():
        record[f"variant_{name}"] = run_equal(
            replace(headline, **{"n_nodes": 1024, "max_ticks": 64, **kw}),
            3, cuda, f"variant {name}")
    ticks = record["small"]["ticks_compared"]
    print(f"card == CPU per tick: 4096 x 4 headline ({ticks} ticks) and "
          f"{len(VARIANTS)} variants", flush=True)

    # phase 5: the exact sampler's kernels against their plain versions
    exact_results, record["exact_checks"] = exact_kernel_checks(cuda)
    print("exact kernels match their plain versions: "
          + ", ".join(f"{r['name']} {r['max_abs_err']}"
                      for r in exact_results), flush=True)

    # phase 6: the exact column at full width, dense against sparse
    runs = exact_full_width(counted)
    record["exact_runs"] = runs
    dense, sparse = (runs[k]["launches"] for k in ("dense_100k",
                                                   "sparse_1m"))
    for r, n in zip(exact_results, (dense["exact_send"],
                                    sparse["exact_send"],
                                    dense["exact_commit"]
                                    + sparse["exact_commit"])):
        r["launches"] = n
    print("exact dense == sparse per seed at 100k x 16", flush=True)

    # phase 7: the exact kernels on the card == plain versions on the CPU
    from corrosion_tpu_torch.sim.calibrate import HeadlineExactConfig

    for name, kw in EXACT_VARIANTS.items():
        cfg = HeadlineExactConfig(**{
            "n_nodes": 1024, "fanout": 4, "ring0_size": 64,
            "max_transmissions": 8, "loss": 0.05, "partition_blocks": 2,
            "heal_tick": 3, "sync_interval": 2, "backoff_ticks": 0.5,
            "max_ticks": 48, "chunk_ticks": 8, **kw})
        for sp in (False, True):
            label = f"exact {name} {'sparse' if sp else 'dense'}"
            record[label] = exact_equal(cfg, 2, sp, cuda, label)
    print(f"exact card == CPU per tick: 1024 x 2, {len(EXACT_VARIANTS)} "
          "variants, both kernels", flush=True)

    # phase 8: the anti-entropy and SWIM kernels against their plain
    # versions
    ae_results = seq_sync_checks(cuda)
    swim_results, record["swim_checks"], record["swim_times"] = (
        swim_kernel_checks(cuda))
    print("seq_sync / swim kernels match their plain versions: "
          + ", ".join(f"{r['name']} {r['max_abs_err']}"
                      for r in ae_results + swim_results), flush=True)

    # phase 9: config #4, config #2 and the 4096-node churn cycle
    paths = full_width_paths(counted)
    record["paths"] = paths
    for r in ae_results:
        r["launches"] = paths["config4"]["launches"][r["name"]]
    for r in swim_results:
        r["launches"] = (paths["config2"]["launches"][r["name"]]
                         + paths["churn4096"]["launches"][r["name"]])

    # phase 10: card == CPU per tick for both paths
    from corrosion_tpu_torch.sim.antientropy import AntiEntropyConfig
    from corrosion_tpu_torch.sim.churn import ChurnConfig

    for label, kw in (("default", {}),
                      ("three_peers_budget_2", dict(peers_per_round=3,
                                                    chunk_budget=2))):
        record[f"ae_equal_{label}"] = ae_equal(
            AntiEntropyConfig(n_nodes=1000, **kw), 4, cuda,
            f"anti-entropy {label}")
    churn_cfg = ChurnConfig(n_nodes=256, cycles=2, cycle_period=128,
                            kill_tick=4, revive_tick=96)
    for label, cfg in (
        ("lossless", churn_cfg),
        ("loss_0.15", replace(churn_cfg, params=replace(churn_cfg.params,
                                                        loss=0.15))),
    ):
        record[f"churn_equal_{label}"] = churn_equal(cfg, cuda,
                                                     f"churn {label}")
    print("anti-entropy and churn card == CPU per tick", flush=True)

    sent_results = sent_phases(record, counted, cuda)
    results += exact_results + ae_results + swim_results + sent_results
    record["kernels"] = results
    with open(kernels.BUILD_DIR / "chip_smoke.json", "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(json.dumps({"headline": stats}), flush=True)
    print(json.dumps({"exact": {k: {f: v[f] for f in (
        "converged_frac", "ticks_p50", "ticks_p99", "msgs_per_node_mean",
        "msgs_per_node_p99", "seed_batch", "wall_s", "peak_mem_gb")}
        for k, v in runs.items()}}), flush=True)
    print(json.dumps({"paths": {k: {f: v.get(f) for f in (
        "converged_frac", "ticks_p50", "ticks_p99", "msgs_per_node_mean",
        "detect_latency", "rejoin_latency", "msgs_per_node_per_tick",
        "ticks_run", "wall_s", "peak_mem_gb")}
        for k, v in paths.items()}}), flush=True)
    sent_runs = dict(record["sent_runs"])
    calib = sent_runs.pop("calibration")
    print(json.dumps({"sent": {
        "calibration": {f: calib[f] for f in ("points", "run_s",
                                              "launches")},
        **{k: {f: v[f] for f in (
            "converged_frac", "ticks_p50", "ticks_p99",
            "msgs_per_node_mean", "hops_p50", "hops_p99", "wall_s",
            "launches")} for k, v in sent_runs.items()}}}), flush=True)
    line = {"kernels": [
        {key: r[key] for key in (
            "name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        for r in results
    ]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def sent_phases(record: dict, counted: dict, cuda) -> list:
    """Phases 11-13, the exact ``sent_to`` sampler; returns the kernels'
    results with the main path's launches (phase 12's runs summed)."""
    # phase 11: sent_select / sent_commit against their plain versions
    results, record["sent_checks"], record["sent_times"] = (
        sent_kernel_checks(cuda))
    ties = sum(c.get("tied_rows", 0) for c in record["sent_checks"])
    print("sent kernels match their plain versions: "
          + ", ".join(f"{r['name']} {r['max_abs_err']}" for r in results)
          + f"; {ties} active rows with tied scores", flush=True)

    # phase 12: run_msgs_calibration and the track_sent runs at full
    # width, each held to the reference's numbers
    runs = sent_full_width(counted)
    record["sent_runs"] = runs
    for r in results:
        r["launches"] = sum(v["launches"][r["name"]] for v in runs.values())

    # phase 13: card == CPU per tick, calibration and track_sent
    from corrosion_tpu_torch.sim.calibrate import ExactConfig

    record["calib_equal"] = calib_equal(
        ExactConfig(2000, sender_chunk=512, backoff_ticks=1.5), cuda,
        "exact_tick 2000")
    for label, cfg in sent_variants(256).items():
        record[f"track_sent_equal_{label}"] = track_sent_equal(
            cfg, 4, cuda, f"track_sent {label}")
    print("exact_tick and track_sent card == CPU per tick", flush=True)
    return results


if __name__ == "__main__":
    sys.exit(main())
