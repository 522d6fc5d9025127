"""The port's bit-match (``corrosion_tpu_torch/sim/bitmatch.py`` over the
port's ``agent/det.py`` cluster) against the reference's, on the CPU.

The same calls go through both packages: ``run_bitmatch`` must return
the reference's result dict for dict, and the detectors' negative
controls (a skewed replay against the agents' trace) must find the same
mismatch at the same tick.  Every port case runs with the agents' clock
cache off and on (a torch store on the CPU, the kernels' plain
versions).
"""

import pytest

from corrosion_tpu.agent.det import DetCluster as RefCluster
from corrosion_tpu.agent.det import DetParams as RefParams
from corrosion_tpu.agent.det import run_det_epidemic as ref_run_det
from corrosion_tpu.sim import bitmatch as ref_bitmatch
from corrosion_tpu_torch.agent.det import DetCluster, DetParams, run_det_epidemic
from corrosion_tpu_torch.sim import bitmatch


def _dir(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    return str(d)


CACHE = pytest.mark.parametrize("cache", [False, True], ids=["nocache", "cache"])

# run_bitmatch keyword sets: tests/test_bitmatch.py's small cluster and
# the headline protocol (loss, ring0-first fanout, anti-entropy) at N=24
RUNS = {
    "n16_seed3": dict(n=16, writes=2, seed=3),
    "headline_n24": dict(n=24, writes=2, seed=0, loss=0.05, ring0_size=8,
                         sync_interval=8),
}

# (agents' params, skewed replay params): the divergence, loss-skew and
# sync-skew detectors of tests/test_bitmatch.py
DETECTORS = {
    "backoff": (dict(n_nodes=16, seed=1, backoff_ticks=2.5),
                dict(n_nodes=16, seed=1, backoff_ticks=1.0)),
    "loss": (dict(n_nodes=24, seed=2, loss=0.05, ring0_size=8,
                  sync_interval=8),
             dict(n_nodes=24, seed=2, loss=0.25, ring0_size=8,
                  sync_interval=8)),
    "sync": (dict(n_nodes=24, seed=0, loss=0.3, sync_interval=4),
             dict(n_nodes=24, seed=0, loss=0.3, sync_interval=6)),
}


@CACHE
@pytest.mark.parametrize("case", list(RUNS))
def test_run_bitmatch_equals_reference(case, cache, tmp_path):
    kw = RUNS[case]
    want = ref_bitmatch.run_bitmatch(base_dir=_dir(tmp_path, "ref"), **kw)
    got = bitmatch.run_bitmatch(base_dir=_dir(tmp_path, "port"),
                                device="cpu", device_cache=cache, **kw)
    assert want["bitmatch"]
    assert got == want


@CACHE
@pytest.mark.parametrize("name", list(DETECTORS))
def test_detectors_equal_reference(name, cache, tmp_path):
    real, skew = DETECTORS[name]
    ref = RefCluster(RefParams(**real), base_dir=_dir(tmp_path, "ref"))
    try:
        want_trace = ref_run_det(ref, origin=0, write_id=0)
    finally:
        ref.close()
    port = DetCluster(DetParams(**real), base_dir=_dir(tmp_path, "port"),
                      device="cpu", device_cache=cache)
    try:
        got_trace = run_det_epidemic(port, origin=0, write_id=0)
        # every agent's clock cache (when on) is a torch store on the
        # cluster's device
        for a in port.agents:
            dc = a.storage.device_cache
            assert (dc is not None) == cache
            if cache:
                assert dc.backend == "torch"
                assert dc.store.device.type == "cpu"
            assert a.storage.device.type == "cpu"
    finally:
        port.close()
    assert got_trace == want_trace
    want = ref_bitmatch.diff_det_traces(
        ref_bitmatch.det_sim_epidemic(RefParams(**skew), origin=0),
        want_trace)
    got = bitmatch.diff_det_traces(
        bitmatch.det_sim_epidemic(DetParams(**skew), origin=0), got_trace)
    assert not want["match"]
    assert got == want
    # the unskewed replay matches the port's agents exactly
    same = bitmatch.diff_det_traces(
        bitmatch.det_sim_epidemic(DetParams(**real), origin=0), got_trace)
    assert same["match"], same


def test_cluster_on_a_card_without_one_raises(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DetCluster(DetParams(n_nodes=2), base_dir=str(tmp_path))
