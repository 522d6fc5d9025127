"""The harness twins' prediction halves against the reference's on the
CPU: ``sim/simdiff.py``, ``sim/obs.py``, ``sim/chaos.py``,
``sim/churndiff.py``, ``sim/timeline.py`` and ``sim/scenarios.py`` of
``corrosion_tpu_torch`` (``device="cpu"``, the plain PyTorch path)
against ``corrosion_tpu``'s functions (JAX on the CPU) on the same
arguments.  Tick and integer fields equal, floats to rel_tol 1e-6, the
coverage lists (rounded to 4 places) entry by entry within 1e-4
(``chip_smoke.harness_diff``); ``wall_s`` (each side's host clock) left
out."""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# the comparison chip_smoke.py's phase 21 holds the card's results by
from chip_smoke import HARNESS_WANT, harness_diff
from corrosion_tpu.sim import chaos as ref_chaos
from corrosion_tpu.sim import churndiff as ref_churndiff
from corrosion_tpu.sim import obs as ref_obs
from corrosion_tpu.sim import scenarios as ref_scenarios
from corrosion_tpu.sim import simdiff as ref_simdiff
from corrosion_tpu.sim import timeline as ref_timeline
from corrosion_tpu_torch.sim import chaos, churndiff, obs, scenarios
from corrosion_tpu_torch.sim import simdiff, timeline

ROOT = Path(__file__).resolve().parents[1]
CPU = {"device": "cpu"}


def no_wall(res: dict) -> dict:
    return {k: v for k, v in res.items() if k != "wall_s"}


# each call is made once a process: several tests read the same result
@functools.lru_cache(maxsize=None)
def both(name: str, *args, **kw):
    """(the reference's result, the port's on the CPU) of ``name`` on
    the same arguments, ``wall_s`` left out."""
    ref_mod, mod = CALLS[name]
    return (no_wall(getattr(ref_mod, name)(*args, **kw)),
            no_wall(getattr(mod, name)(*args, **kw, **CPU)))


CALLS = {
    "sim_trace": (ref_simdiff, simdiff),
    "sim_obs_trace": (ref_obs, obs),
    "sim_chaos_trace": (ref_chaos, chaos),
    "sim_prediction": (ref_scenarios, scenarios),
    "kernel_coverage_prediction": (ref_timeline, timeline),
    "model_churn_trace": (ref_churndiff, churndiff),
}

CASES = [
    ("sim_trace", (16,), ()),
    ("sim_trace", (32,), (("sync", True),)),
    ("sim_obs_trace", (32,), ()),
    ("sim_chaos_trace", (32,), ()),
    ("sim_chaos_trace", (32,), (("oneway_blocks", ((0, 1),)),)),
    ("kernel_coverage_prediction", (32, 64), ()),
    ("kernel_coverage_prediction", (16, 16), ()),
    ("model_churn_trace", (64,), ()),
    ("model_churn_trace", (64,), (("cycles", 3),)),
]


@pytest.mark.parametrize(
    "name,args,kw", CASES,
    ids=[f"{n}{a}{dict(k) or ''}" for n, a, k in CASES])
def test_twin_equals_reference(name, args, kw):
    want, got = both(name, *args, **dict(kw))
    assert harness_diff(got, want, name) == []
    assert got["runtime"] == "tpu-sim"


@pytest.mark.parametrize("family", ref_scenarios.FAMILIES)
def test_sim_prediction_equals_reference(family):
    want, got = both("sim_prediction", family, 32, 0.64)
    assert harness_diff(got, want, family) == []
    # asym_partition's directed prediction carries no residual
    assert got.get("residual") == want.get("residual")
    assert ("residual" in got) == (family != "asym_partition")


def test_constants_equal_reference():
    assert scenarios.FAMILIES == ref_scenarios.FAMILIES
    for a, b in ((obs, ref_obs), (scenarios, ref_scenarios),
                 (timeline, ref_timeline)):
        assert a.TICK_S == b.TICK_S
    for name in ("PLATEAU_GUARD_S", "PLATEAU_PROBE_MIN_S", "PLATEAU_TOL",
                 "FULL_COV", "RECOVERY_FACTOR", "RECOVERY_SLACK_S"):
        assert getattr(timeline, name) == getattr(ref_timeline, name)


def test_sim_trace_config_is_sent_trace_cfg(monkeypatch):
    """``sim_trace`` and ``sim_obs_trace`` build their config through
    ``sent_trace_cfg``, the one source, which takes their parameters."""
    from corrosion_tpu_torch.sim import epidemic

    cfg = epidemic.sent_trace_cfg(48, 8, 16, fanout=4, max_transmissions=6,
                                  backoff_ticks=1.5)
    assert (cfg.fanout_global, cfg.max_transmissions, cfg.backoff_ticks,
            cfg.sync_interval, cfg.chunk_ticks, cfg.track_sent) == (
                4, 6, 1.5, 8, 16, True)
    seen = []

    def spy(cfg, **kw):
        seen.append(cfg)
        return epidemic.run_epidemic_seeds(cfg, **kw)

    monkeypatch.setattr(simdiff, "run_epidemic_seeds", spy)
    monkeypatch.setattr(obs, "run_epidemic_seeds", spy)
    simdiff.sim_trace(12, fanout=2, max_transmissions=3, seeds=1,
                      sync=True, backoff_ticks=1.0, device="cpu")
    obs.sim_obs_trace(12, fanout=2, max_transmissions=3, seeds=1,
                      device="cpu")
    assert seen == [
        epidemic.sent_trace_cfg(12, 8, 8, 2, 3, 1.0),
        epidemic.sent_trace_cfg(12, 8, 16, 2, 3),
    ]


def test_curve_value_at_equals_reference():
    want, got = both("kernel_coverage_prediction", 32, 64)
    times, cov = want["times_s"], want["coverage"]
    for t in (-1.0, 0.0, 0.019, 0.02, 0.5, 1.27, 1.28, 1.3, times[-1], 99.0):
        assert timeline.curve_value_at(times, cov, t) == (
            ref_timeline.curve_value_at(times, cov, t))
        assert timeline.curve_value_at(got["times_s"], got["coverage"],
                                       t) == pytest.approx(
            ref_timeline.curve_value_at(times, cov, t), abs=1e-4)


def test_trajectory_gates_equal_reference():
    """The gates of TIMELINE_N32.json's live cell against each side's
    prediction and the record's own."""
    rec = json.loads((ROOT / "TIMELINE_N32.json").read_text())
    live, heal = rec["agents"], rec["agents"]["heal_after_s"]
    want, got = both("kernel_coverage_prediction", 32, 64)
    for pred in (want, got, rec["sim"]):
        assert timeline.trajectory_gates(live, pred, heal) == (
            ref_timeline.trajectory_gates(live, pred, heal))
    # a live cell that never completed: no full-coverage offset
    stalled = dict(live, converged=False,
                   coverage=dict(live["coverage"], t_at_coverage={}))
    assert timeline.trajectory_gates(stalled, got, heal) == (
        ref_timeline.trajectory_gates(stalled, got, heal))


def test_diff_traces_equal_reference():
    rec = json.loads((ROOT / "SIMDIFF_N64.json").read_text())
    agents = rec["agents"]
    want, got = both("sim_trace", 16)
    for sim in (rec["sim"], want, got):
        assert simdiff.diff_traces(sim, agents) == (
            ref_simdiff.diff_traces(sim, agents))
    # a hop percentile the agents could not measure: no ratio
    unmeasured = dict(agents, hops_p50=None, converged_frac=0.75)
    out = simdiff.diff_traces(rec["sim"], unmeasured)
    assert out == ref_simdiff.diff_traces(rec["sim"], unmeasured)
    assert out["diff"]["hops_p50_ratio"] is None
    assert out["diff"]["both_converged"] is False


def test_finite_and_percentile_equal_reference():
    for v in (None, math.inf, -math.inf, math.nan, 0.0, 7.5):
        a, b = simdiff._finite(v), ref_simdiff._finite(v)
        assert a == b or (a is None and b is None)
    for vals, q in (([], 50), ([3], 99), ([0, 4, 2, 2, 9, 1], 50),
                    ([0, 4, 2, 2, 9, 1], 99), (list(range(17)), 37)):
        assert simdiff._percentile(vals, q) == ref_simdiff._percentile(
            vals, q)


def test_chip_smoke_constants_are_the_references():
    """``chip_smoke.py`` phase 21 holds the card to ``HARNESS_WANT``:
    its entries at 32 nodes are the reference's results here (the
    512-node ones come from the same reference calls)."""
    calls = {"sim_obs_trace(32)": ("sim_obs_trace", (32,)),
             "sim_chaos_trace(32)": ("sim_chaos_trace", (32,)),
             "kernel_coverage_prediction(32, 64)": (
                 "kernel_coverage_prediction", (32, 64))}
    for family in ref_scenarios.FAMILIES:
        calls[f"sim_prediction({family!r}, 32, 0.64)"] = (
            "sim_prediction", (family, 32, 0.64))
    for label, (name, args) in calls.items():
        want, _ = both(name, *args)
        assert harness_diff(HARNESS_WANT[label], want, label) == []


ENTRY_POINTS = [
    ("sim_trace", lambda: simdiff.sim_trace(8, seeds=1)),
    ("sim_obs_trace", lambda: obs.sim_obs_trace(8, seeds=1)),
    ("sim_chaos_trace", lambda: chaos.sim_chaos_trace(8, seeds=1)),
    ("sim_chaos_trace perm", lambda: chaos.sim_chaos_trace(
        8, seeds=1, track_sent=False)),
    ("sim_prediction", lambda: scenarios.sim_prediction(
        "compound", 8, 0.64, seeds=1)),
    ("sim_prediction fault-free", lambda: scenarios.sim_prediction(
        "slow_io", 8, 0.64, seeds=1)),
    ("kernel_coverage_prediction",
     lambda: timeline.kernel_coverage_prediction(8, 4, seeds=1)),
    ("model_churn_trace", lambda: churndiff.model_churn_trace(8)),
    ("model_churn_trace cycles",
     lambda: churndiff.model_churn_trace(8, cycles=2)),
]


@pytest.mark.parametrize("call", [c for _, c in ENTRY_POINTS],
                         ids=[n for n, _ in ENTRY_POINTS])
def test_entry_point_without_a_card_raises(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_twin_modules_import_no_jax():
    code = (
        "import sys\n"
        "import corrosion_tpu_torch.sim.simdiff, corrosion_tpu_torch.sim.obs\n"
        "import corrosion_tpu_torch.sim.chaos\n"
        "import corrosion_tpu_torch.sim.churndiff\n"
        "import corrosion_tpu_torch.sim.timeline\n"
        "import corrosion_tpu_torch.sim.scenarios\n"
        "import corrosion_tpu_torch.agent.submatch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'corrosion_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)
