"""Where the host layout's validity exchange spends its device time, on
a tree whose exchange packs bool masks (``bits_pack`` / ``bits_unpack``
around the all_gather, the [S, N] temporaries around them).

    python3 probes/validity_chain.py TREE CAND_CU OUT.json

TREE is a checkout of such a commit; its package is imported and built.
It runs only against such a tree: it records the exchanges through
``models/sharded.py``'s ``bits_pack``, which a tree that packs from the
sources (``bits_pack_active``, ``bits_pack_above``) no longer imports,
and it stops at once on such a tree.
CAND_CU is a ``fabric.cu`` with the packing forms ``bits_pack_above``,
``bits_pack_active`` and ``bits_unpack_add`` (built apart and launched
through ctypes).  Records the first chunk of the host-sparse 10M x 2
run on 2 hosts (``profile_tick.mesh_chunk``): every active exchange's
inputs and every shard's rejection rounds.  Then replays the chunk's
chain behind a GPU sleep, piece by piece (the active predicate's ops,
``torch.zeros`` of ``accepted``, the compare, the packs, the
all_gather's copies, the unpacks, the ``.any()`` tests, ``accepted +=
bad``) and through the candidate's forms, each held bitwise to TREE's
chain, and times the two loop tests (the unpack's count, or
``wire.any()``) with their host reads.  Times TREE's and the
candidate's ``bits_pack`` / ``bits_unpack`` alone at [2, 5M] and to
[2, 10M] in turns, and ``seq_sync`` / ``seq_stats`` at config #4's
width behind a sleep and by the profiler.  Needs one CUDA card; writes
OUT.json.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT, CAND, OUT = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, os.path.abspath(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from corrosion_tpu_torch import kernels  # noqa: E402
from corrosion_tpu_torch import profile_tick as pt  # noqa: E402
from corrosion_tpu_torch.kernels import fabric  # noqa: E402
from corrosion_tpu_torch.models import sharded  # noqa: E402
from corrosion_tpu_torch.sim import calibrate as cal  # noqa: E402

assert kernels.__file__.startswith(os.path.abspath(ROOT)), kernels.__file__
assert hasattr(sharded, "bits_pack"), (
    "TREE's host layout packs from the sources; this probe records a tree "
    "that packs bool masks")
dev = torch.device("cuda")
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
record = {"card": cs.card_line()}
print(record["card"], flush=True)

t0 = time.time()
kernels.build()
lib_path = str(kernels.BUILD_DIR / "libfabric_candidate.so")
res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib_path,
                      CAND], capture_output=True, text=True)
record["ptxas"] = [ln for ln in (res.stdout + res.stderr).splitlines()
                   if "registers" in ln or "Compiling" in ln]
record["build_s"] = time.time() - t0
print("built", record["build_s"], res.returncode, flush=True)
if res.returncode:  # TREE's chain is still measured
    print(res.stdout[-6000:], res.stderr[-6000:], flush=True)
    record["candidate_build"] = (res.stdout + res.stderr)[-6000:]
lib = ctypes.CDLL(lib_path) if res.returncode == 0 else None


def cfn(name, argtypes):
    if lib is None:
        return None
    f = getattr(lib, name)
    f.argtypes, f.restype = list(argtypes), ctypes.c_int
    return f


c_pack = cfn("bits_pack_launch", (P, P, LL, P))
c_unpack = cfn("bits_unpack_launch", (P, P, LL, P, P, P))
c_add = cfn("bits_unpack_add_launch", (P, P, LL, I, P, P, P))
c_above = cfn("bits_pack_above_launch", (P, I, P, LL, P))
c_active = cfn("bits_pack_active_launch", (P, LL, P, P, I, P, P, I, I, P))
scratch = torch.zeros(2, dtype=torch.int32, device=dev)


def ptr(t):
    return P(None if t is None else t.data_ptr())


def stream():
    return P(torch.cuda.current_stream().cuda_stream)


def check(code, name):
    if code:
        raise RuntimeError(f"{name}: CUDA error {code}")


def cand_pack(mask):
    wire = torch.empty((*mask.shape[:-1], mask.shape[-1] // 8),
                       dtype=torch.uint8, device=dev)
    check(c_pack(ptr(mask), ptr(wire), wire.numel(), stream()), "pack")
    return wire


def cand_unpack(wire, m, count=None):
    mask = torch.empty((*wire.shape[:-1], m), dtype=torch.bool, device=dev)
    check(c_unpack(ptr(wire), ptr(mask), wire.numel(),
                   ptr(None if count is None else scratch), ptr(count),
                   stream()), "unpack")
    return mask


def cand_add(wire, acc, first, count=None):
    check(c_add(ptr(wire), ptr(acc), wire.numel(), int(first),
                ptr(None if count is None else scratch), ptr(count),
                stream()), "unpack_add")


def cand_above(x, t):
    wire = torch.empty((*x.shape[:-1], x.shape[-1] // 8), dtype=torch.uint8,
                       device=dev)
    check(c_above(ptr(x), int(t), ptr(wire), x.numel(), stream()), "above")
    return wire


def cand_active(inf_w, tx, ns, tick):
    s, m = tx.shape
    active = torch.empty((s, m), dtype=torch.bool, device=dev)
    wire = torch.empty((s, m // 8), dtype=torch.uint8, device=dev)
    check(c_active(ptr(inf_w), inf_w.stride(0), ptr(tx), ptr(ns), int(tick),
                   ptr(active), ptr(wire), s, m, stream()), "active")
    return active, wire


# -- 1. record the first host-sparse 10M chunk's exchanges -------------

cfg = cal.headline_exact_cfg(10_000_000, False)
SEEDS, D = 2, 2
actives, rounds, log = {}, {}, []
orig_sh, orig_fb = sharded.bits_pack, fabric.bits_pack


def rec_active(mask):
    f = sys._getframe(1).f_locals
    key = (int(f["tick"]), int(f["sh"]))
    lo, nl = f["lo"], f["n_local"]
    actives[key] = dict(infected=f["infected"].clone(), lo=lo, n_local=nl,
                        tx=f["tx_l"].clone(), ns=f["next_send_l"].clone(),
                        tick=int(f["tick"]))
    log.append(("active", *key))
    return orig_sh(mask)


def rec_round(mask):
    f = sys._getframe(1).f_locals
    key = (int(f["tick"]), int(f["sh"]))
    if f["r"] == 0:
        rounds[key] = dict(rounds=f["rounds_l"].clone(), n=int(f["n"]), r=0)
    rounds[key]["r"] = int(f["r"]) + 1
    log.append(("round", *key, int(f["r"])))
    return orig_fb(mask)


# TREE's wrappers count their launches on the module's name
rec_active.launches = rec_round.launches = 0
sharded.bits_pack, fabric.bits_pack = rec_active, rec_round
work = pt.mesh_chunk(cfg, SEEDS, "hosts", D, True, True)()
work()
torch.cuda.synchronize()
sharded.bits_pack, fabric.bits_pack = orig_sh, orig_fb
ticks = sorted({k[0] for k in actives})
record["chain"] = {
    "active_exchanges": len(actives) // D,
    "active_packs": len(actives),
    "round_packs": sum(v["r"] for v in rounds.values()),
    "rejection_exchanges": sum(v["r"] for v in rounds.values()) // D,
    "rounds_by_tick": {t: [rounds.get((t, sh), {"r": 0})["r"]
                           for sh in range(D)] for t in ticks},
    "send_ticks": sorted({k[0] for k in rounds}),
}
print("chain", json.dumps(record["chain"]), flush=True)
n = cfg.n_nodes

# -- 2. the pieces, replayed in sequence behind a GPU sleep ------------


def seq_ms(calls, reps=3):
    """Device ms of ``calls`` run in order, enqueued behind a GPU sleep
    (best and all of ``reps``)."""
    for f in calls:
        f()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cs.SLEEP_CYCLES * (2 + len(calls) // 4))
        a.record()
        for f in calls:
            f()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return {"ms": min(out), "runs": out, "calls": len(calls)}


keys = sorted(actives)
inp = {}
for key in keys:
    a = actives[key]
    w = a["infected"][:, a["lo"]:a["lo"] + a["n_local"]]
    act = w & (a["tx"] > 0) & (a["ns"] <= a["tick"])
    inp[key] = dict(w=w, act=act, wire=fabric.bits_pack(act))
gathered = {}
for t in ticks:
    wl = [inp[(t, sh)]["wire"] for sh in range(D)]
    gathered[t] = torch.cat(wl, dim=1)
rkeys = sorted(rounds)
bad_l, rwire, bad, accs = {}, {}, {}, {}
for key in rkeys:
    v = rounds[key]
    for r in range(v["r"]):
        bad_l[key + (r,)] = v["rounds"] > r + 1
for t in sorted({k[0] for k in rkeys}):
    for r in range(max(rounds[(t, sh)]["r"] for sh in range(D))):
        ws = [fabric.bits_pack(bad_l[(t, sh, r)]) for sh in range(D)]
        g = torch.cat(ws, dim=1)
        for sh in range(D):
            rwire[(t, sh, r)] = g
            bad[(t, sh, r)] = fabric.bits_unpack(g, n)
for key in rkeys:
    accs[key] = torch.zeros((SEEDS, n), dtype=torch.int32, device=dev)
rk = [k for k in sorted(bad_l)]


rwl = {k: fabric.bits_pack(bad_l[k]) for k in rk}


def last_round(k):
    return k[2] == rounds[k[:2]]["r"] - 1


pieces = {
    "predicate (4 ops)": [
        (lambda a=actives[k], i=inp[k]:
         i["w"] & (a["tx"] > 0) & (a["ns"] <= a["tick"])) for k in keys],
    "bits_pack active": [(lambda i=inp[k]: fabric.bits_pack(i["act"]))
                         for k in keys],
    "all_gather copies (active)": [
        (lambda t=t: torch.cat([inp[(t, sh)]["wire"] for sh in range(D)],
                               dim=1)) for t in ticks for _ in range(D)],
    "bits_unpack active": [(lambda t=k[0]: fabric.bits_unpack(gathered[t],
                                                              n))
                           for k in keys],
    "active.any()": [(lambda a=fabric.bits_unpack(gathered[k[0]], n):
                      a.any()) for k in keys],
    "zeros accepted": [(lambda: torch.zeros((SEEDS, n), dtype=torch.int32,
                                            device=dev)) for _ in rkeys],
    "compare rounds > r + 1": [
        (lambda k=k: rounds[k[:2]]["rounds"] > k[2] + 1) for k in rk],
    "bits_pack round": [(lambda k=k: fabric.bits_pack(bad_l[k]))
                        for k in rk],
    "bits_unpack round": [(lambda k=k: fabric.bits_unpack(rwire[k], n))
                          for k in rk],
    "bad.any()": [(lambda k=k: bad[k].any()) for k in rk],
    "accepted += bad": [(lambda k=k: accs[k[:2]].add_(bad[k]))
                        for k in rk if not last_round(k)],
}
pieces["all_gather copies (rounds)"] = [
    (lambda k=k: torch.cat([rwl[(k[0], sh, k[2])] for sh in range(D)], dim=1))
    for k in rk]
cnt = torch.empty(1, dtype=torch.int32, device=dev)
cacc = {k: torch.empty((SEEDS, n), dtype=torch.int32, device=dev)
        for k in rkeys}
cand = {
    "cand bits_pack_active": [
        (lambda a=actives[k], i=inp[k]: cand_active(i["w"], a["tx"], a["ns"],
                                                    a["tick"])) for k in keys],
    "cand bits_unpack active + count": [
        (lambda t=k[0]: cand_unpack(gathered[t], n, cnt)) for k in keys],
    "cand bits_unpack active": [(lambda t=k[0]: cand_unpack(gathered[t], n))
                                for k in keys],
    "cand bits_pack_above": [
        (lambda k=k: cand_above(rounds[k[:2]]["rounds"], k[2] + 1))
        for k in rk],
    "cand bits_unpack_add + count": [
        (lambda k=k: cand_add(rwire[k], cacc[k[:2]], k[2] == 0, cnt))
        for k in rk],
    "cand bits_unpack_add": [
        (lambda k=k: cand_add(rwire[k], cacc[k[:2]], k[2] == 0))
        for k in rk],
    "wire.any()": [(lambda k=k: rwire[k].any()) for k in rk],
}

# bitwise: the candidate's forms against TREE's chain
diffs = []
if lib is None:
    cand, keys_c, rk_c, rkeys_c = {}, [], [], []
else:
    keys_c, rk_c, rkeys_c = keys, rk, rkeys
for k in keys_c:
    a, i = actives[k], inp[k]
    act, wire = cand_active(i["w"], a["tx"], a["ns"], a["tick"])
    if not (torch.equal(act, i["act"]) and torch.equal(wire, i["wire"])):
        diffs.append(f"active {k}")
    got = cand_unpack(gathered[k[0]], n, cnt)
    want = fabric.bits_unpack(gathered[k[0]], n)
    if not torch.equal(got, want) or int(cnt) != int(want.sum()):
        diffs.append(f"unpack {k}")
for k in rk_c:
    if not torch.equal(cand_above(rounds[k[:2]]["rounds"], k[2] + 1),
                       fabric.bits_pack(bad_l[k])):
        diffs.append(f"above {k}")
for key in rkeys_c:
    want = torch.zeros((SEEDS, n), dtype=torch.int32, device=dev)
    got = torch.full((SEEDS, n), 77, dtype=torch.int32, device=dev)
    for r in range(rounds[key]["r"]):
        k = key + (r,)
        cand_add(rwire[k], got, r == 0, cnt)
        if int(cnt) != int(bad[k].sum()):
            diffs.append(f"count {k}")
        if r < rounds[key]["r"] - 1:
            want += bad[k]
    if not torch.equal(got, want):
        diffs.append(f"accepted {key}")
record["bitwise_diffs"] = diffs
print("bitwise diffs:", diffs, flush=True)

times = {}
for name, calls in {**pieces, **cand}.items():
    times[name] = seq_ms(calls)
    print(name, json.dumps(times[name]), flush=True)
record["pieces"] = times


def host_chain(test_by_count: bool):
    """Wall ms (host clock, syncs included) of the chunk's rejection
    loops through the candidate's forms, the loop's test by the unpack's
    count or by ``wire.any()``."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for key in rkeys:
        for r in range(rounds[key]["r"]):
            k = key + (r,)
            cand_above(rounds[key]["rounds"], r + 1)
            if test_by_count:
                cand_add(rwire[k], cacc[key], r == 0, cnt)
                if not int(cnt):
                    break
            else:
                if r == 0:
                    cand_add(rwire[k], cacc[key], True)
                if not bool(rwire[k].any()):
                    break
                if r:
                    cand_add(rwire[k], cacc[key], False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


record["loop_test_wall_ms"] = {} if lib is None else {
    label: [host_chain(flag) for _ in range(5)]
    for label, flag in (("count", True), ("wire.any()", False),
                        ("count ", True), ("wire.any() ", False))}
print("loop tests", json.dumps(record["loop_test_wall_ms"]), flush=True)

# -- 3. the kernels alone, in turns ------------------------------------

g = torch.Generator(device="cpu").manual_seed(3)
m = (torch.rand((2, 5_000_000), generator=g) < 0.2).to(dev)
wire = torch.randint(0, 256, (2, 1_250_000), generator=g).to(torch.uint8).to(
    dev)
acc = torch.empty((2, 10_000_000), dtype=torch.int32, device=dev)
r_in = torch.randint(0, 4, (2, 5_000_000), generator=g,
                     dtype=torch.int32).to(dev)
k0 = keys[-1]
a0, i0 = actives[k0], inp[k0]
alone = {}
for name, parent, cand_fn in (
        ("bits_pack [2, 5M]", lambda: fabric.bits_pack(m),
         lambda: cand_pack(m)),
        ("bits_unpack to [2, 10M]", lambda: fabric.bits_unpack(wire, n),
         lambda: cand_unpack(wire, n)),
        ("pack of rounds > 1 [2, 5M]",
         lambda: fabric.bits_pack(r_in > 1), lambda: cand_above(r_in, 1)),
        ("active [2, 5M] window",
         lambda: fabric.bits_pack(i0["w"] & (a0["tx"] > 0)
                                  & (a0["ns"] <= a0["tick"])),
         lambda: cand_active(i0["w"], a0["tx"], a0["ns"], a0["tick"])),
        ("unpack into accepted, first",
         lambda: torch.zeros((2, n), dtype=torch.int32, device=dev).add_(
             fabric.bits_unpack(wire, n)),
         lambda: cand_add(wire, acc, True, cnt)),
        ("unpack into accepted, later",
         lambda: acc.add_(fabric.bits_unpack(wire, n)),
         lambda: cand_add(wire, acc, False, cnt))):
    row = {}
    for timer, fn in (("sleep_pairs", lambda f: cs.time_inplace_ms(
            lambda: None, f, 30)), ("sleep_batch", lambda f:
                                    cs.time_device_ms(f, 50))):
        if lib is None:
            row[timer] = {"parent": [fn(parent)]}
            continue
        row[timer] = {"parent": [fn(parent)], "cand": [fn(cand_fn),
                                                       fn(cand_fn)]}
        row[timer]["parent"].append(fn(parent))
    alone[name] = row
    print(name, json.dumps(row), flush=True)
record["alone"] = alone

# -- 4. seq_sync / seq_stats at config #4's width ----------------------

from corrosion_tpu_torch.kernels import seq_sync as ks  # noqa: E402
from corrosion_tpu_torch.random import (  # noqa: E402
    PRNGKey,
    fold_in,
    key_words,
    randint_span,
    split,
)
from corrosion_tpu_torch.sim.antientropy import (  # noqa: E402
    CONFIG4,
    CONFIG4_SEEDS,
)

tick = cs.AE_TICKS[-1]
flat, bits, msgs = cs.ae_state_at(CONFIG4, CONFIG4_SEEDS, tick - 1, dev)
p = flat.params
k_peers, k_drop = split(fold_in(PRNGKey(0), tick - 1))
peer_keys = tuple(key_words(k) for k in split(k_peers))
span, mult = randint_span(1, p.universe)
args = (bits, msgs, peer_keys, key_words(k_drop), p.universe, span, mult)
kw = dict(peers_per_round=p.peers_per_round, seqs_per_chunk=p.seqs_per_chunk,
          chunk_budget=p.chunk_budget, loss=p.loss,
          handshake_msgs=p.handshake_msgs)
got = ks.seq_sync(*args, **kw)
out = torch.empty_like(ks.seq_stats(got[0], got[1], CONFIG4_SEEDS))
seq = {}
for name, f in (("seq_sync", lambda: ks.seq_sync(*args, **kw)),
                ("seq_stats", lambda: ks.seq_stats(got[0], got[1],
                                                   CONFIG4_SEEDS, out=out))):
    prof = torch.profiler.profile(activities=list(pt.ACTIVITIES))
    with prof:
        for _ in range(20):
            f()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    seq[name] = {"sleep_pairs": cs.time_inplace_ms(lambda: None, f, 30),
                 "sleep_batch": cs.time_device_ms(f, 50),
                 "bare_events": cs.time_ms(f, 50),
                 "profiler": dev_us / 1e3 / 20,
                 "shape": f"{CONFIG4_SEEDS} x {CONFIG4.n_nodes}, "
                          f"{tuple(bits.shape)}, tick {tick}"}
    print(name, json.dumps(seq[name]), flush=True)
record["seq"] = seq

with open(OUT, "w") as fh:
    json.dump(record, fh, indent=1, default=str)
print("done", flush=True)
