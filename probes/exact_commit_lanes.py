"""``exact_commit``'s lane width and residency under a cold, clean L2,
beside an earlier tree's thread-a-byte kernel.

    python3 probes/exact_commit_lanes.py OLD_TREE OUT.json [lanes|unrolled]

Run from the root of this checkout: builds its ``exact_send.cu``,
``exact_commit_lanes.cu`` and OLD_TREE's ``exact_send.cu`` (whose
``exact_commit_launch`` takes contiguous masks and a flat count), holds
each variant bitwise to ``exact_commit_plain`` on seeded masks
(``chip_smoke.commit_case``) at the main paths' shapes with few, some
and many learners, and times them in turns behind a GPU sleep, the L2
filled with other, clean lines before each call.  ``lanes`` (the
default) compares 16, 8 and 4 positions a lane and 16 at lower
residency; ``unrolled`` compares 16 and 4 with and without the
unrolled edge loads and store loop.  Needs one CUDA card;
writes OUT.json.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from corrosion_tpu_torch import kernels  # noqa: E402
from corrosion_tpu_torch.kernels import exact_send as es  # noqa: E402

ROOT, OUT = sys.argv[1], sys.argv[2]
HERE = os.path.dirname(os.path.abspath(__file__))
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
dev = torch.device("cuda")
print(cs.card_line(), flush=True)
kernels.build(("exact_send",))
libs = {}
for name, src in (("lanes", os.path.join(HERE, "exact_commit_lanes.cu")),
                  ("parent", os.path.join(ROOT, "corrosion_tpu_torch",
                                          "kernels", "csrc",
                                          "exact_send.cu"))):
    path = str(kernels.BUILD_DIR / f"libexact_commit_{name}.so")
    cs.build_library(src, path)
    libs[name] = ctypes.CDLL(path)
var = libs["lanes"].var_launch
var.argtypes, var.restype = [I, P, P, LL, LL, P, P, P, I, I, I, I, I, P], I
old = libs["parent"].exact_commit_launch
old.argtypes, old.restype = [P, P, P, P, P, LL, I, I, I, P], I


def ptr(t):
    return P(None if t is None else t.data_ptr())


def st():
    return P(torch.cuda.current_stream().cuda_stream)


def ok(code):
    if code:
        raise RuntimeError(f"launch failed {code}")


flush = torch.zeros(32 << 20, dtype=torch.int32, device=dev)


def evict():
    flush.sum()


CASES = (
    ("host few", 2, 10_000_000, 5_000_000, 5_000_000, 1e-4),
    ("host many", 2, 10_000_000, 5_000_000, 5_000_000, 0.3),
    ("host 3pct", 2, 10_000_000, 5_000_000, 5_000_000, 0.03),
    ("sparse few", 4, 1_000_000, 0, 1_000_000, 1e-4),
    ("sparse many", 4, 1_000_000, 0, 1_000_000, 0.3),
    ("dense many", 16, 100_000, 0, 100_000, 0.3),
    ("shard few", 4, 12_500, 0, 12_500, 1e-4),
    ("shard many", 4, 12_500, 0, 12_500, 0.3),
)
# name: (positions a lane, negative for the unrolled edges and stores;
# blocks an SM the shared memory leaves room for, 0 for no limit)
VARIANTS = {
    "lanes": {"v16": (16, 0), "v16_occ4": (16, 4), "v16_occ2": (16, 2),
              "v8": (8, 0), "v4": (4, 0)},
    "unrolled": {"v16": (16, 0), "v16u": (-16, 0), "v4": (4, 0),
                 "v4u": (-4, 0)},
}
VARS = VARIANTS[sys.argv[3] if len(sys.argv) > 3 else "lanes"]
g = torch.Generator(device=dev)
g.manual_seed(33)
record = {"card": cs.card_line(), "cases": {}}
for label, s, n_full, lo, width, frac in CASES:
    inf, new, tier, outs = cs.commit_case(g, s, n_full, lo, width, frac, dev)
    w_inf, w_new = inf[:, lo:lo + width], new[:, lo:lo + width]
    c_inf, c_new = w_inf.contiguous(), w_new.contiguous()
    o = [v for _, v in outs]
    start = [v.clone() for v in o]
    want = [v.clone() for v in o]
    es.exact_commit_plain(w_inf, w_new, *want, 5, 8)
    runs = {
        "parent": lambda: ok(old(ptr(c_inf), ptr(c_new), ptr(o[0]),
                                 ptr(o[1]), P(None), s * width, width, 5, 8,
                                 st())),
        "tree": lambda: es.exact_commit(w_inf, w_new, *o, 5, 8),
    }
    for k, (lp, occ) in VARS.items():
        runs[k] = (lambda lp=lp, occ=occ: ok(var(
            lp, ptr(w_inf), ptr(w_new), w_inf.stride(0), w_new.stride(0),
            ptr(o[0]), ptr(o[1]), P(None), s, width, 5, 8, occ, st())))
    bad = {}
    for k, fn in runs.items():
        for v, x in zip(o, start):
            v.copy_(x)
        fn()
        torch.cuda.synchronize()
        bad[k] = sum(int((v != w).sum()) for v, w in zip(o, want))
    names = list(runs)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k].append(cs.time_inplace_ms(evict, runs[k], 20))
    learned = w_new & ~w_inf
    rec = {"learners": int(learned.sum()),
           "bound_ms": cs.bound_ms(cs.commit_bytes(learned), 0)[0],
           "mismatches": bad, "ms": times}
    record["cases"][label] = rec
    print(label, json.dumps({k: v for k, v in rec.items()}), flush=True)
    del inf, new, tier, outs, w_inf, w_new, c_inf, c_new, o, start, want
    torch.cuda.empty_cache()
record["card_after"] = cs.card_line()
json.dump(record, open(OUT, "w"))
print("done", record["card_after"])
