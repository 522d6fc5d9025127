"""Where ``exact_commit``'s time goes, on the thread-a-byte kernel that
took contiguous masks (``exact_commit_launch`` with a flat count).

    python3 probes/exact_commit_parts.py TREE OUT.json

TREE is a checkout of a commit with that kernel; its package is
imported and built.  Records every commit of five main paths (the exact
dense and sparse runs, the first chunk of the host-sparse 10M,
sharded-dense and frontier layouts), replays each path's commits in
sequence behind a GPU sleep, in turns, through TREE's kernel and
``exact_commit_parts.cu``'s pieces and candidate designs, each held
bitwise to the plain version; times them on synthetic [2, 5M] masks
(with and without a tier), the host layout's two window copies, and
reads the gap before each commit in a profiled host chunk and sparse
run.  Needs one CUDA card; writes OUT.json.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT, OUT = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.abspath(ROOT))

import torch  # noqa: E402

from corrosion_tpu_torch import kernels  # noqa: E402
from corrosion_tpu_torch import profile_tick as pt  # noqa: E402
from corrosion_tpu_torch.kernels import exact_send as es  # noqa: E402
from corrosion_tpu_torch.models import sharded  # noqa: E402
from corrosion_tpu_torch.sim import calibrate as cal  # noqa: E402

assert kernels.__file__.startswith(os.path.abspath(ROOT)), kernels.__file__
dev = torch.device("cuda")
HERE = os.path.dirname(os.path.abspath(__file__))
P = ctypes.c_void_p
I, LL = ctypes.c_int, ctypes.c_longlong
SLEEP = 2_000_000
record = {"card": subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True).stdout.strip()}
print(record["card"], flush=True)

t0 = time.time()
kernels.build()
lib_path = str(kernels.BUILD_DIR / "libexact_commit_parts.so")
res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib_path,
                      os.path.join(HERE, "exact_commit_parts.cu")],
                     capture_output=True, text=True)
record["ptxas"] = [ln for ln in (res.stdout + res.stderr).splitlines()
                   if "registers" in ln or "Compiling" in ln]
if res.returncode:
    print(res.stdout, res.stderr)
    raise SystemExit(1)
print("built", time.time() - t0, flush=True)
lib = ctypes.CDLL(lib_path)


def fn(name, argtypes):
    f = getattr(lib, name)
    f.argtypes, f.restype = list(argtypes), ctypes.c_int
    return f


loads_byte = fn("loads_byte_launch", (P, P, LL, P, I, P))
loads_vec = fn("loads_vec_launch", (P, P, LL, P, I, P))
stores_list = fn("stores_list_launch", (P, I, P, P, P, I, I, I, P))
nomod = fn("nomod_launch", (P, P, P, P, P, I, I, I, I, P))
cand = fn("cand_launch", (P, P, LL, LL, P, P, P, I, I, I, I, I, P))
sink = torch.zeros(4, dtype=torch.int32, device=dev)


def ptr(t):
    return P(None if t is None else t.data_ptr())


def stream():
    return P(torch.cuda.current_stream().cuda_stream)


def ok(code):
    if code:
        raise RuntimeError(f"launch failed {code}")


# -- record every commit of the five main paths -------------------------
recs = []
orig = es.exact_commit


def recording(infected, new_infected, tx, next_send, tick, max_tx,
              tier=None):
    recs.append(dict(inf=infected.clone(), new=new_infected.clone(),
                     tier=None if tier is None else tier.clone(),
                     tick=tick, max_tx=max_tx))
    return orig(infected, new_infected, tx, next_send, tick, max_tx, tier)


cal.exact_commit = recording
sharded.exact_commit = recording

H10 = cal.headline_exact_cfg(10_000_000, False)
PATHS = {
    "dense_16x100k": lambda: pt.exact_run(cal.EXACT_DENSE, 16, "dense"),
    "sparse_4x1m": lambda: pt.exact_run(cal.EXACT_SPARSE, 4, "sparse"),
    "host_2x5m_of_10m": lambda: pt.mesh_chunk(H10, 2, "hosts", 2, True,
                                              True),
    "sharded_dense_4x12500": lambda: pt.mesh_chunk(cal.EXACT_DENSE, 4,
                                                   "nodes", 8, False, False),
    "frontier_4x1m": lambda: pt.mesh_chunk(cal.EXACT_SPARSE, 4, "nodes", 8,
                                           True, False),
}


def bound_bytes(learned, s, n, tier):
    flat = learned.reshape(-1)
    pad = (-flat.numel()) % 8
    sec = torch.nn.functional.pad(flat, (0, pad)).view(-1, 8).any(1)
    b = 2 * s * n + 64 * int(sec.sum())
    if tier is not None:
        col = learned.any(0)
        pad = (-n) % 8
        b += 32 * int(torch.nn.functional.pad(col, (0, pad)).view(-1, 8)
                      .any(1).sum())
    return b


def timed_seq(calls, reps=5):
    """Median ms of the whole sequence of calls behind a GPU sleep."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP + 60_000 * len(calls))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for c in calls:
            c()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    out.sort()
    return out[len(out) // 2]


def host_us(call, reps=50):
    """Host microseconds to enqueue ``call`` with the device asleep."""
    call()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP * 4)
    t = time.perf_counter()
    for _ in range(reps):
        call()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def path_variants(items, window_n=None):
    """{variant: [call per launch]} over recorded launches; tx / next_send
    scratch per launch shape."""
    scratch = {}
    out = {k: [] for k in ("parent", "loads_byte", "loads_vec",
                           "stores_list", "cand_persistent", "cand_plain")}
    if window_n:
        out.update(cand_window=[], copies_parent=[])
    for r in items:
        s, n = r["inf"].shape
        key = (s, n)
        if key not in scratch:
            scratch[key] = (torch.zeros((s, n), dtype=torch.int32,
                                        device=dev),
                            torch.zeros((s, n), dtype=torch.int32,
                                        device=dev))
        tx, ns = scratch[key]
        inf, new, tier, tick, mt = (r["inf"], r["new"], r["tier"],
                                    r["tick"], r["max_tx"])
        idx = r["idx"]
        out["parent"].append(lambda inf=inf, new=new, tx=tx, ns=ns, t=tick,
                             m=mt, tr=tier: orig(inf, new, tx, ns, t, m, tr))
        out["loads_byte"].append(lambda inf=inf, new=new: ok(loads_byte(
            ptr(inf), ptr(new), inf.numel(), ptr(sink), 0, stream())))
        out["loads_vec"].append(lambda inf=inf, new=new: ok(loads_vec(
            ptr(inf), ptr(new), inf.numel(), ptr(sink), 0, stream())))
        out["stores_list"].append(lambda idx=idx, tx=tx, ns=ns, tr=tier,
                                  n=n, t=tick, m=mt: ok(stores_list(
                                      ptr(idx), idx.numel(), ptr(tx),
                                      ptr(ns), ptr(tr), n, t, m, stream())))
        for pers, name in ((1, "cand_persistent"), (0, "cand_plain")):
            out[name].append(lambda inf=inf, new=new, tx=tx, ns=ns,
                             tr=tier, s=s, n=n, t=tick, m=mt, p=pers:
                             ok(cand(ptr(inf), ptr(new), n, n, ptr(tx),
                                     ptr(ns), ptr(tr), s, n, t, m, p,
                                     stream())))
        if window_n:
            fi, fn_ = r["full"]
            lo = r["lo"]
            out["cand_window"].append(
                lambda fi=fi, fn_=fn_, lo=lo, tx=tx, ns=ns, tr=tier, s=s,
                n=n, t=tick, m=mt: ok(cand(
                    ptr(fi[:, lo:]), ptr(fn_[:, lo:]), fi.stride(0),
                    fn_.stride(0), ptr(tx), ptr(ns), ptr(tr), s, n, t, m, 1,
                    stream())))
            out["copies_parent"].append(
                lambda fi=fi, fn_=fn_, lo=lo, tx=tx, ns=ns, tr=tier, n=n,
                t=tick, m=mt: orig(fi[:, lo:lo + n].contiguous(),
                                   fn_[:, lo:lo + n].contiguous(), tx, ns,
                                   t, m, tr))
    return out


def check_cand(r, g):
    """The candidate (contiguous, and on a window of a wider pair) and
    the parent bitwise the plain version from one random start."""
    s, n = r["inf"].shape
    tx0 = torch.randint(0, 9, (s, n), generator=g, device=dev,
                        dtype=torch.int32)
    ns0 = torch.randint(0, 30, (s, n), generator=g, device=dev,
                        dtype=torch.int32)
    want = [tx0.clone(), ns0.clone()]
    es.exact_commit_plain(r["inf"], r["new"], *want, r["tick"],
                          r["max_tx"], r["tier"])
    bad = {}
    got = [tx0.clone(), ns0.clone()]
    ok(cand(ptr(r["inf"]), ptr(r["new"]), n, n, ptr(got[0]), ptr(got[1]),
            ptr(r["tier"]), s, n, r["tick"], r["max_tx"], 1, stream()))
    bad["cand"] = sum(int((x != y).sum()) for x, y in zip(got, want))
    got = [tx0.clone(), ns0.clone()]
    orig(r["inf"], r["new"], *got, r["tick"], r["max_tx"], r["tier"])
    bad["parent"] = sum(int((x != y).sum()) for x, y in zip(got, want))
    # windows: the same masks at lo 3 of [s, n + 40] (both aligned
    # alike), and inf at 3 / new at 5 (aligned apart)
    for label, (a, b) in (("win_3_3", (3, 3)), ("win_3_5", (3, 5))):
        fi = torch.zeros((s, n + 40), dtype=torch.bool, device=dev)
        fn_ = torch.zeros((s, n + 40), dtype=torch.bool, device=dev)
        fi[:, a:a + n] = r["inf"]
        fn_[:, b:b + n] = r["new"]
        got = [tx0.clone(), ns0.clone()]
        ok(cand(ptr(fi[:, a:]), ptr(fn_[:, b:]), n + 40, n + 40,
                ptr(got[0]), ptr(got[1]), ptr(r["tier"]), s, n, r["tick"],
                r["max_tx"], 1, stream()))
        bad[label] = sum(int((x != y).sum()) for x, y in zip(got, want))
    torch.cuda.synchronize()
    return bad


g = torch.Generator(device=dev)
g.manual_seed(21)
record["paths"] = {}
for label, make in PATHS.items():
    recs.clear()
    torch.cuda.empty_cache()
    work = make()()
    t = time.time()
    work()
    torch.cuda.synchronize()
    del work
    torch.cuda.empty_cache()
    items = list(recs)
    recs.clear()
    launches, learners, bound_b, bounds = len(items), 0, 0, []
    bad = {}
    for r in items:
        learned = r["new"] & ~r["inf"]
        r["idx"] = torch.nonzero(learned.reshape(-1)).reshape(-1).to(
            torch.int32)
        s, n = r["inf"].shape
        b = bound_bytes(learned, s, n, r["tier"])
        bounds.append(b)
        bound_b += b
        learners += r["idx"].numel()
        for k, v in check_cand(r, g).items():
            bad[k] = bad.get(k, 0) + v
    window = None
    if label.startswith("host"):
        window = 10_000_000
        for i, r in enumerate(items):
            s, n = r["inf"].shape
            lo = 5_000_000 if i % 2 else 0
            fi = torch.zeros((s, window), dtype=torch.bool, device=dev)
            fn_ = torch.zeros((s, window), dtype=torch.bool, device=dev)
            fi[:, lo:lo + n] = r["inf"]
            fn_[:, lo:lo + n] = r["new"]
            r["full"], r["lo"] = (fi, fn_), lo
    calls = path_variants(items, window)
    names = list(calls)
    order = names + names[::-1]
    times = {k: [] for k in names}
    for k in order:
        times[k].append(timed_seq(calls[k]))
    per = {"shape": list(items[0]["inf"].shape), "launches": launches,
           "learners": learners,
           "learners_per_launch": [r["idx"].numel() for r in items],
           "bound_ms": bound_b / 3.35e12 * 1e3,
           "bound_ms_per_launch": [b / 3.35e12 * 1e3 for b in bounds],
           "run_s": time.time() - t, "mismatches": bad,
           "seq_ms": times}
    # the host's enqueue of one call (device asleep)
    top = max(range(len(items)), key=lambda i: items[i]["idx"].numel())
    per["host_us"] = {k: host_us(calls[k][top])
                      for k in ("parent", "cand_persistent")
                      + (("copies_parent", "cand_window") if window else ())}
    record["paths"][label] = per
    print(label, json.dumps({k: v for k, v in per.items()
                             if k not in ("learners_per_launch",
                                          "bound_ms_per_launch")}),
          flush=True)
    del items, calls
    torch.cuda.empty_cache()

cal.exact_commit = orig
sharded.exact_commit = orig

# -- synthetic [2, 5M]: tier and the 64-bit modulo; learner densities --
s, n = 2, 5_000_000
syn = {}
for frac in (0.0, 1e-4, 1e-2, 0.3):
    inf = torch.rand((s, n), generator=g, device=dev) < 0.3
    new = inf | (torch.rand((s, n), generator=g, device=dev) < frac)
    tier = torch.randint(1, 5, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    tx = torch.zeros((s, n), dtype=torch.int32, device=dev)
    ns = torch.zeros_like(tx)
    learned = new & ~inf
    b = bound_bytes(learned, s, n, None)
    bt = bound_bytes(learned, s, n, tier)
    v = {
        "parent": lambda: orig(inf, new, tx, ns, 5, 8, None),
        "parent_tier": lambda: orig(inf, new, tx, ns, 5, 8, tier),
        "nomod_tier": lambda: ok(nomod(ptr(inf), ptr(new), ptr(tx), ptr(ns),
                                       ptr(tier), s, n, 5, 8, stream())),
        "cand": lambda: ok(cand(ptr(inf), ptr(new), n, n, ptr(tx), ptr(ns),
                                P(None), s, n, 5, 8, 1, stream())),
        "cand_tier": lambda: ok(cand(ptr(inf), ptr(new), n, n, ptr(tx),
                                     ptr(ns), ptr(tier), s, n, 5, 8, 1,
                                     stream())),
        "cand_plain": lambda: ok(cand(ptr(inf), ptr(new), n, n, ptr(tx),
                                      ptr(ns), P(None), s, n, 5, 8, 0,
                                      stream())),
    }
    names = list(v)
    tm = {k: [] for k in names}
    # each call alone behind a sleep, ten of them in one window (L2 warm
    # after the first: 20 MB of masks)
    for k in names + names[::-1]:
        tm[k].append(timed_seq([v[k]] * 10) / 10)
    syn[str(frac)] = {"learners": int(learned.sum()),
                      "bound_ms": b / 3.35e12 * 1e3,
                      "bound_tier_ms": bt / 3.35e12 * 1e3, "ms": tm}
    print("syn", frac, json.dumps(syn[str(frac)]), flush=True)
    del inf, new, tier, tx, ns, learned
record["synthetic_2x5m"] = syn

# the two window copies at [2, 10M], lo = 5M
fi = torch.zeros((2, 10_000_000), dtype=torch.bool, device=dev)
fn_ = torch.zeros_like(fi)
lo = 5_000_000
record["copies_ms"] = [timed_seq([lambda: (fi[:, lo:].contiguous(),
                                           fn_[:, lo:].contiguous())] * 10)
                       / 10 for _ in range(3)]
print("copies", record["copies_ms"], flush=True)
del fi, fn_

# -- gaps before each commit in a profiled host-sparse chunk and sparse run
gaps = {}
for label, make in (("host_2x5m_of_10m", PATHS["host_2x5m_of_10m"]),
                    ("sparse_4x1m", PATHS["sparse_4x1m"])):
    torch.cuda.empty_cache()
    work = make()()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    del work
    ev = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    out, end, prev = [], -1, None
    for a, b, name in ev:
        if "exact_commit" in name:
            out.append({"gap_us": a - end, "prev": (prev or "")[:60],
                        "us": b - a})
        if b > end:
            end, prev = b, name
    gaps[label] = out
    print("gaps", label, json.dumps(out)[:3000], flush=True)
record["gaps"] = gaps
record["card_after"] = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True).stdout.strip()
with open(OUT, "w") as f:
    json.dump(record, f)
print("done", record["card_after"], flush=True)
