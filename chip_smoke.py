#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``corrosion_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package.  Phases, each ending the run with a non-zero exit on failure:

1. print the card's name and power limit, build the four kernels from
   this checkout's sources (one ``nvcc`` per source, in parallel) and
   record threefry's opcode counts (``cuobjdump -sass``);
2. hold each kernel against its plain PyTorch version on the card, on
   the inputs the headline's tick 7 (a sync tick, partition in force)
   gives it, and time both with CUDA events;
3. run the headline — 100k nodes x 32 seeds, R = 8, 5% loss, two
   partition blocks healing at tick 12 — on the card, require every
   seed to converge, and require every kernel's launch counter (zeroed
   just before) to have risen;
4. run the same config at 4096 nodes x 4 seeds on the card (kernels)
   and on the CPU (plain versions) and require per-tick rows / tx /
   msgs / hops / next_send and the stats dicts to be equal; the same
   for five 1024-node variants that take the kernels' other paths.

Prints the ``kernels`` JSON line, the headline stats and, last, the
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
    counts as equal); 0.0 means bitwise-equal integers."""
    worst = 0.0
    for x, y in zip(a, b):
        if x is None and y is None:
            continue
        x, y = x.double(), y.double()
        both_nan = torch.isnan(x) & torch.isnan(y)
        d = torch.where(both_nan, torch.zeros_like(x), (x - y).abs())
        worst = max(worst, float(torch.nan_to_num(d, nan=math.inf).max()))
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
        replaces="corrosion_tpu/models/sync.py:89",
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
        b, ops = r.pop("bound")
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        if r["name"] != "tick_stats" and r["max_abs_err"] != 0.0:
            fail(f"{r['name']} differs from its plain version "
                 f"(max |diff| {r['max_abs_err']})")
    return results


def states_equal(a, b) -> bool:
    for f in ("rows", "tx_remaining", "msgs", "hops", "next_send"):
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None):
            return False
        if x is not None and not torch.equal(x.cpu(), y.cpu()):
            return False
    return a.tick == b.tick


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.kernels import deliver, sync_pull, threefry
    from corrosion_tpu_torch.kernels import tick_stats
    from corrosion_tpu_torch.sim.epidemic import (
        HEADLINE,
        HEADLINE_SEEDS,
        run_epidemic_seeds,
    )

    mods = (threefry, deliver, sync_pull, tick_stats)
    counted = (threefry.threefry_bits, deliver.deliver_perm,
               sync_pull.sync_pull, tick_stats.tick_stats)
    record = {}

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

    # phase 2: kernels against their plain versions
    results = kernel_checks(replace(headline, n_universes=seeds), mods,
                            torch.device("cuda"))
    print("kernels match their plain versions: "
          + ", ".join(f"{r['name']} {r['max_abs_err']}" for r in results),
          flush=True)

    # phase 3: the headline on the card, counters from this run only
    run_epidemic_seeds(replace(headline, n_nodes=1000, max_ticks=16),
                       n_seeds=2, device="cuda")  # warm the allocator
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = run_epidemic_seeds(headline, n_seeds=seeds, seed=0,
                               device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    stats["device"] = torch.cuda.get_device_name(0)
    stats["card"] = card
    stats["run_s"] = wall
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for r in results:
        r["launches"] = launches[r["name"]]
    line = {"kernels": [
        {key: r[key] for key in (
            "name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        for r in results
    ]}
    record.update(card=card, kernels=results, headline=stats)
    if stats["converged_frac"] != 1.0:
        fail(f"headline did not converge: {stats}")
    idle = [name for name, c in launches.items() if c == 0]
    if idle:
        fail(f"kernels never launched on the main path: {idle}")

    # phase 4: kernels on the card == plain versions on the CPU
    cuda = torch.device("cuda")
    record["small"] = run_equal(replace(headline, n_nodes=4096), 4, cuda,
                                "4096-node run")
    for name, kw in VARIANTS.items():
        record[f"variant_{name}"] = run_equal(
            replace(headline, **{"n_nodes": 1024, "max_ticks": 64, **kw}),
            3, cuda, f"variant {name}")
    ticks = record["small"]["ticks_compared"]
    print(f"card == CPU per tick: 4096 x 4 headline ({ticks} ticks) and "
          f"{len(VARIANTS)} variants", flush=True)

    with open(kernels.BUILD_DIR / "chip_smoke.json", "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(json.dumps({"headline": stats}), flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
