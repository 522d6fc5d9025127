"""Phase 23b's walls on two trees in turns, and phase 23c on this one.

    python3 probes/agent_surfaces_walls.py [--parent DIR] [--order pccp]
        [--surfaces] [--device cpu --rows 6000]

Each turn is a process of its own that imports ``chip_smoke`` and the
port from one tree (``p``: ``--parent``, a checkout of the parent
commit; ``c``: this checkout), builds the winner and store kernels of
that tree, and runs ``chip_smoke.live_cluster`` (phase 23b: four agents
on loopback, 70,000 rows) on the card. It prints one JSON line a turn:
the write, B's reassembly, each catch-up arm and each large apply (host
clock), the kernels' launches, and which host codec the tree's agent
runs (the native module or the Python twins). With ``--surfaces`` a
turn of this tree then runs phase 23c (``chip_smoke.surfaces_cluster``:
three agents with the PostgreSQL wire, the admin sockets and signing
keys on). The card's name and power limit come first; the full
records land in ``corrosion_tpu_torch/kernels/build/
agent_surfaces_walls.json`` (ignored by git).

``--device cpu --rows N`` checks the turns on the CPU at N rows (the
kernels' plain versions; ``TORCH_AUTO_MIN`` lowered to half the rows,
B's updates to 512 rows); its times are no measurement.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def turn(root: str, surfaces: bool, device: str, rows) -> dict:
    """One turn, in this process, from the tree at ``root``."""
    sys.path.insert(0, root)
    import asyncio

    import torch

    import chip_smoke as cs
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.agent import pack
    from corrosion_tpu_torch.kernels import seg_sort, store, winners
    from corrosion_tpu_torch.ops import merge

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    dev = torch.device(device)
    if rows:
        cs.AGENT_ROWS, cs.AGENT_UPDATE_ROWS = rows, 512
        merge.TORCH_AUTO_MIN = rows // 2
    t0 = time.perf_counter()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if dev.type == "cuda":
        kernels.build(("seg_sort", "winners", "store"))
    out = dict(root=os.path.relpath(root, HERE), build_s=time.perf_counter()
               - t0, native=pack.pack_values is not pack._py_pack_values)
    counted = {f.__name__: f for f in (
        seg_sort.seg_argsort, winners.seg_cummax, winners.winners_a,
        winners.winners_b, store.store_set, store.store_gather)}
    old = cs.old_version()
    with tempfile.TemporaryDirectory(prefix="walls-",
                                     dir=kernels.BUILD_DIR) as tmp:
        names = ["a", "b"] + ["c_" + arm for arm in cs.AGENT_ARMS]
        for name in names:
            os.mkdir(os.path.join(tmp, name))
        for name in names[1:]:
            cs.preseed(os.path.join(tmp, name), old, dev)
        t0 = time.perf_counter()
        live = asyncio.run(cs.live_cluster(counted, dev, tmp, old))
        live["s"] = time.perf_counter() - t0
    out["23b"] = {k: live.get(k) for k in (
        "s", "write_s", "version_changes", "chunks", "b_received_s",
        "b_serves", "apply_walls", "b_launches", "update_launches")}
    out["23b"]["arms"] = {arm: {k: r[k] for k in (
        "caught_up_s", "sync_changes", "launches")}
        for arm, r in live["arms"].items()}
    if surfaces:
        with tempfile.TemporaryDirectory(prefix="surfaces-",
                                         dir=kernels.BUILD_DIR) as tmp:
            for name in "abc":
                os.mkdir(os.path.join(tmp, name))
            for name in "bc":
                cs.preseed(os.path.join(tmp, name), old, dev)
            t0 = time.perf_counter()
            surf = asyncio.run(cs.surfaces_cluster(
                counted, dev, tmp, old, live["version_digest"]))
            surf["s"] = time.perf_counter() - t0
        out["23c"] = {k: surf[k] for k in (
            "s", "pg_write_s", "version_changes", "same_version_as_23b",
            "b_received_s", "c_sync_s", "c_sync_changes", "pg_read_s",
            "pg_rows", "pg_rows_equal", "apply_walls", "signatures",
            "b_launches", "c_launches", "update_launches")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit")
    ap.add_argument("--order", default="c",
                    help="the turns, p (parent) and c (this tree)")
    ap.add_argument("--surfaces", action="store_true",
                    help="also run phase 23c in each turn of this tree")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, help="a smaller version (checks)")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.turn:
        rec = turn(os.path.abspath(opts.turn), opts.surfaces, opts.device,
                   opts.rows)
        print("TURN " + json.dumps(rec), flush=True)
        return 0
    if "p" in opts.order and not opts.parent:
        ap.error("--order names p without --parent")
    if opts.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("agent_surfaces_walls: CUDA is not available",
                  file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip(), flush=True)
    records, rc = [], 0
    for k in opts.order:
        root = os.path.abspath(opts.parent) if k == "p" else HERE
        cmd = [sys.executable, os.path.abspath(__file__), "--turn", root,
               "--device", opts.device]
        if opts.rows:
            cmd += ["--rows", str(opts.rows)]
        if k == "c" and opts.surfaces:
            cmd.append("--surfaces")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        rec = dict(tree=k, rc=proc.returncode,
                   wall_s=time.perf_counter() - t0)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("TURN ")]
        if lines:
            rec.update(json.loads(lines[-1][5:]))
        else:
            rec["stdout_tail"] = proc.stdout[-3000:]
        rec["stderr_tail"] = proc.stderr[-3000:] if proc.returncode else ""
        rc = rc or proc.returncode
        records.append(rec)
        short = {key: rec.get(key) for key in ("tree", "rc", "wall_s",
                                               "native")}
        if "23b" in rec:
            short.update({key: rec["23b"][key] for key in (
                "write_s", "b_received_s", "apply_walls")},
                arms={a: r["caught_up_s"]
                      for a, r in rec["23b"]["arms"].items()})
        if "23c" in rec:
            short["23c"] = {key: rec["23c"][key] for key in (
                "s", "pg_write_s", "b_received_s", "c_sync_s", "pg_read_s",
                "apply_walls", "signatures")}
        print(json.dumps(short), flush=True)
        if proc.returncode:
            print(rec["stderr_tail"] or rec.get("stdout_tail", ""),
                  flush=True)
    out = os.path.join(HERE, "corrosion_tpu_torch", "kernels", "build")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "agent_surfaces_walls.json"), "w") as fh:
        json.dump(records, fh, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
