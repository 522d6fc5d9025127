"""Where the time goes on the card, for the headline, the exact
column, anti-entropy and SWIM churn.

    python -m corrosion_tpu_torch.profile_tick

Times eight pieces of work: one chunk (16 ticks; the headline
converges within it) of the headline epidemic (100k nodes x 32 seeds)
from its initial state; the two full-width exact-sampler runs
(``run_exact_headline`` on ``sim.calibrate.EXACT_DENSE`` x 16 seeds and
``EXACT_SPARSE`` x 4 seeds, set-up and all chunks included); the whole
config #4 run (``run_anti_entropy_seeds``, 10k nodes x 32 seeds); the
first 32-tick chunk of the churn schedule at 64 (config #2) and 4096
nodes from the initial state; one seed of the calibration-scale exact
sampler at 16k nodes (``run_exact(ExactConfig(16000))``, the 16k point
of ``run_msgs_calibration``); the whole ``track_sent`` run of
``sim_trace``'s config at 512 nodes x 8 seeds; and one full-width
``select_winners(backend="torch")`` call on a ``resync_batch`` of
2**20 changes (warm, interleaved; the plan is encoded untimed).  Each is
run first untimed to warm up, then ``REPS`` times with a host clock
around work that ends in ``torch.cuda.synchronize()``, then ``REPS``
times under ``torch.profiler``, each of those with its own host clock.
Prints one JSON object with an entry per piece: the unprofiled walls;
for each profiled run its wall, the device time summed over every
kernel the profiler saw in it, and its device idle share (1 - device
time / that same wall); and, from the profiled run of median idle
share, the device time per kernel name with its launches.  Takes no
arguments; needs a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from dataclasses import replace

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.ops import merge
from corrosion_tpu_torch.models.swim import swim_init
from corrosion_tpu_torch.random import PRNGKey
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


def _timed(prepare, profiled: bool):
    """Wall seconds of the work ``prepare()`` returns (``prepare``
    itself untimed) and, when ``profiled``, {kernel name: device ms and
    launches}."""
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
        return wall, None
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us > 0:
            kernels[e.key] = {"device_ms": us / 1e3, "launches": e.count}
    return wall, kernels


def profile(prepare, **meta) -> dict:
    resolve_device("cuda")
    _timed(prepare, profiled=False)
    walls = [_timed(prepare, profiled=False)[0] * 1e3 for _ in range(REPS)]
    runs = []
    for _ in range(REPS):
        wall, kernels = _timed(prepare, profiled=True)
        device_ms = sum(k["device_ms"] for k in kernels.values())
        runs.append((1.0 - device_ms / (wall * 1e3), wall * 1e3, device_ms,
                     kernels))
    runs.sort(key=lambda r: r[0])
    idle, wall_ms, device_ms, kernels = runs[len(runs) // 2]
    return {
        "device": torch.cuda.get_device_name(0), **meta,
        "wall_ms_unprofiled": walls,
        "profiled": [{"wall_ms": r[1], "device_ms": r[2], "idle_share": r[0]}
                     for r in runs],
        "median": {"wall_ms": wall_ms, "device_ms": device_ms,
                   "idle_share": idle},
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


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    cfg = replace(HEADLINE, n_universes=HEADLINE_SEEDS)
    out = {"headline_chunk": profile(
        headline_chunk(cfg), nodes=cfg.n_nodes, seeds=cfg.n_universes,
        ticks=cfg.chunk_ticks)}
    for label, ecfg, seeds, kernel in (
        ("exact_dense_100k", calibrate.EXACT_DENSE,
         calibrate.EXACT_DENSE_SEEDS, "dense"),
        ("exact_sparse_1m", calibrate.EXACT_SPARSE,
         calibrate.EXACT_SPARSE_SEEDS, "sparse"),
    ):
        out[label] = profile(exact_run(ecfg, seeds, kernel),
                             nodes=ecfg.n_nodes, seeds=seeds, kernel=kernel)
    out["anti_entropy_config4"] = profile(
        anti_entropy_run(antientropy.CONFIG4, antientropy.CONFIG4_SEEDS),
        nodes=antientropy.CONFIG4.n_nodes, seeds=antientropy.CONFIG4_SEEDS)
    for n in (64, 4096):
        ccfg = churn.ChurnConfig(n_nodes=n)
        out[f"churn_{n}_chunk"] = profile(churn_chunk(ccfg), nodes=n,
                                          ticks=ccfg.chunk_ticks)
    ecfg = calibrate.ExactConfig(16_000)
    out["calib_exact_16k"] = profile(calib_seed(ecfg), nodes=ecfg.n_nodes,
                                     seeds=1)
    out["track_sent_512"] = profile(track_sent_run(sent_trace_cfg(512), 8),
                                    nodes=512, seeds=8)
    plan = merge.encode_changes(*resync_batch())
    out["winners_1m"] = profile(winners_call(plan), changes=plan.n,
                                rows=plan.n_pk, cells=plan.n_cid)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
