"""Phase 23b's catch-up arms on the CPU at a small size, with the
catch-up nodes on the test helper's sync timers or on the reference's
defaults: how many changes each node receives by sync, and from how
many served needs, against the version it lacks.

    JAX_PLATFORMS=cpu python3 probes/agent_catchup_timers.py [ROWS]

Runs ``chip_smoke.live_cluster`` with ``device="cpu"`` (the kernels'
plain versions), ``TORCH_AUTO_MIN`` lowered to an eighth of the rows
so the version's applies take the winner path and the older version's
(a sixteenth) does not, once a timer setting.
"""

import asyncio
import json
import os
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402
from corrosion_tpu_torch.agent import testing  # noqa: E402
from corrosion_tpu_torch.kernels import seg_sort, store  # noqa: E402
from corrosion_tpu_torch.kernels import winners as w  # noqa: E402
from corrosion_tpu_torch.ops import merge  # noqa: E402

# launch_test_agent's own sync timers
TEST_TIMERS = dict(sync_interval_min=0.15, sync_interval_max=0.4)


def run(rows: int, timers: str) -> dict:
    real = testing.launch_test_agent

    async def launch(*args, **kw):
        if timers == "test" and os.path.basename(
                kw.get("tmpdir", "")).startswith("c_"):
            kw.update(TEST_TIMERS)
        return await real(*args, **kw)

    cs.AGENT_ROWS, cs.AGENT_UPDATE_ROWS = rows, 256
    merge.TORCH_AUTO_MIN = rows // 8
    counted = {f.__name__: f for f in (
        seg_sort.seg_argsort, w.seg_cummax, w.winners_a, w.winners_b,
        store.store_set, store.store_gather)}
    dev = torch.device("cpu")
    old = cs.old_version()
    testing.launch_test_agent = launch
    try:
        with tempfile.TemporaryDirectory() as tmp:
            names = ["a", "b"] + ["c_" + arm for arm in cs.AGENT_ARMS]
            for name in names:
                os.mkdir(os.path.join(tmp, name))
            for name in names[1:]:
                cs.preseed(os.path.join(tmp, name), old, dev)
            live = asyncio.run(cs.live_cluster(counted, dev, tmp, old))
    finally:
        testing.launch_test_agent = real
    return {arm: {k: a[k] for k in ("sync_changes", "served_by_arm",
                                    "caught_up_s")}
            for arm, a in live["arms"].items()} | {
        "version": live["version_changes"], "b_serves": live["b_serves"]}


def main() -> None:
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    for timers in ("test", "default"):
        print(json.dumps({"timers": timers, "rows": rows,
                          **run(rows, timers)}), flush=True)


if __name__ == "__main__":
    main()
