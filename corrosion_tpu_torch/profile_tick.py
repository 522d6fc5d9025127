"""Where the time goes on the card, for the headline and the exact
column.

    python -m corrosion_tpu_torch.profile_tick

Times three pieces of work: one chunk (16 ticks; the headline
converges within it) of the headline epidemic (100k nodes x 32 seeds)
from its initial state, and the two full-width exact-sampler runs
(``run_exact_headline`` on ``sim.calibrate.EXACT_DENSE`` x 16 seeds and
``EXACT_SPARSE`` x 4 seeds, set-up and all chunks included).  Each is
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

import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.random import PRNGKey
from corrosion_tpu_torch.sim import calibrate
from corrosion_tpu_torch.sim.epidemic import (
    HEADLINE,
    HEADLINE_SEEDS,
    EpidemicConfig,
    _scan_chunk,
    epidemic_init,
)


REPS = 5
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
