"""The validity wire's kernels (``csrc/fabric.cu``) beside variants of
their grids and of ``bits_pack_active``'s batch of loads, at the host
layout's shapes.

    python3 probes/validity_variants.py FABRIC_CU OUT.json

Builds FABRIC_CU as it is and as variants made by text substitution
(``VARIANTS``: the first round's unpack into ``accepted`` on the capped
grid, four blocks an SM, ``bits_pack_active`` loading 16 or 4
positions a lane a batch in place of 8), each its own library launched
through ctypes;
holds every variant's five entry points bitwise to the plain versions
(``kernels/fabric.py``) and times each behind a GPU sleep (50 calls
behind one sleep, and 30 calls each between its own events) in turns,
the tree's first and last.  Needs one CUDA card; writes OUT.json.
"""
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CU, OUT = sys.argv[1], sys.argv[2]
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from corrosion_tpu_torch import kernels  # noqa: E402
from corrosion_tpu_torch.kernels import fabric as kf  # noqa: E402

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
dev = torch.device("cuda")
SRC = open(CU).read()
GRID = "constexpr int BITS_BLOCKS_PER_SM = 8;"
FIRST = "bits_grid(s.units > s.scalar ? s.units : s.scalar, false)"
BATCH = "constexpr int ACTIVE_BATCH = 8;"
VARIANTS = {
    "tree": [],
    "first round capped": [
        (FIRST, "bits_grid(s.units > s.scalar ? s.units : s.scalar)")],
    "4 blocks an SM": [(GRID, "constexpr int BITS_BLOCKS_PER_SM = 4;")],
    "active by 16": [(BATCH, "constexpr int ACTIVE_BATCH = 16;")],
    "active by 4": [(BATCH, "constexpr int ACTIVE_BATCH = 4;")],
}


def build(name: str) -> tuple:
    src = SRC
    for old, new in VARIANTS[name]:
        assert old in src, (name, old[:60])
        src = src.replace(old, new)
    tag = name.replace(" ", "_").replace(",", "")
    path = str(kernels.BUILD_DIR / f"fabric_{tag}.cu")
    lib = str(kernels.BUILD_DIR / f"libfabric_{tag}.so")
    with open(path, "w") as fh:
        fh.write(src)
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
                          path], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"{name}: {res.stdout}{res.stderr}")
    return lib, [ln for ln in (res.stdout + res.stderr).splitlines()
                 if "registers" in ln]


record = {"card": cs.card_line()}
print(record["card"], flush=True)
kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
with ThreadPoolExecutor(len(VARIANTS)) as pool:
    built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
record["ptxas"] = {k: v[1] for k, v in built.items()}


class Lib:
    def __init__(self, path):
        lib = ctypes.CDLL(path)

        def f(name, argtypes):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            return fn

        self.pack = f("bits_pack_launch", kf._PACK_ARGTYPES)
        self.unpack = f("bits_unpack_launch", kf._UNPACK_ARGTYPES)
        self.add = f("bits_unpack_add_launch", kf._UNPACK_ADD_ARGTYPES)
        self.above = f("bits_pack_above_launch", kf._ABOVE_ARGTYPES)
        self.active = f("bits_pack_active_launch", kf._ACTIVE_ARGTYPES)


libs = {k: Lib(v[0]) for k, v in built.items()}
p = kernels.ptr
scratch = torch.zeros(1, dtype=torch.int64, device=dev)
count = torch.empty(1, dtype=torch.int32, device=dev)
g = torch.Generator(device="cpu").manual_seed(3)
s, n = cs.VALIDITY_HOST
m = n // 2
x = cs.validity_inputs(s, m, dev, g)
wire = torch.cat([x["wire"], x["wire"]], dim=1)
sparse = torch.cat([x["sparse"], x["sparse"]], dim=1)
window = x["infected"][:, m:]
tick = cs.VALIDITY_TICK
outs = dict(wire=torch.empty((s, m // 8), dtype=torch.uint8, device=dev),
            active=torch.empty((s, m), dtype=torch.bool, device=dev),
            mask=torch.empty((s, n), dtype=torch.bool, device=dev),
            acc=torch.empty((s, n), dtype=torch.int32, device=dev))


def st():
    return kernels.stream(outs["acc"])


def calls(L: Lib) -> dict:
    o = outs
    return {
        "bits_pack": lambda: L.pack(p(x["mask"]), p(o["wire"]), s * m // 8,
                                    st()),
        "bits_pack_above": lambda: L.above(p(x["rounds"]), 1, p(o["wire"]),
                                           s * m, st()),
        "bits_pack_active": lambda: L.active(
            p(window), window.stride(0), p(x["tx"]), p(x["next_send"]),
            tick, p(o["active"]), p(o["wire"]), s, m, st()),
        "bits_unpack": lambda: L.unpack(p(wire), p(o["mask"]), s * n // 8,
                                        p(scratch), p(count), st()),
        "bits_unpack_add first": lambda: L.add(
            p(wire), p(o["acc"]), s * n // 8, 1, p(scratch), p(count), st()),
        "bits_unpack_add later (sparse)": lambda: L.add(
            p(sparse), p(o["acc"]), s * n // 8, 0, p(scratch), p(count),
            st()),
    }


def check(name: str) -> list:
    c = calls(libs[name])
    bad = []
    c["bits_pack"]()
    if not torch.equal(outs["wire"], kf.bits_pack_plain(x["mask"])):
        bad.append("bits_pack")
    c["bits_pack_above"]()
    if not torch.equal(outs["wire"], kf.bits_pack_above_plain(x["rounds"],
                                                               1)):
        bad.append("bits_pack_above")
    c["bits_pack_active"]()
    a, w = kf.bits_pack_active_plain(window, x["tx"], x["next_send"], tick)
    if not (torch.equal(outs["active"], a) and torch.equal(outs["wire"], w)):
        bad.append("bits_pack_active")
    c["bits_unpack"]()
    want = kf.bits_unpack_plain(wire, n)
    if not torch.equal(outs["mask"], want) or int(count) != int(want.sum()):
        bad.append("bits_unpack")
    c["bits_unpack_add first"]()
    c["bits_unpack_add later (sparse)"]()
    want = want.to(torch.int32) + kf.bits_unpack_plain(sparse, n)
    if not torch.equal(outs["acc"], want):
        bad.append("bits_unpack_add")
    return bad


record["bitwise"] = {name: check(name) for name in VARIANTS}
print("bitwise", record["bitwise"], flush=True)
order = list(VARIANTS) + ["tree"]
times = {}
for name in order:
    for form, fn in calls(libs[name]).items():
        row = times.setdefault(form, {}).setdefault(
            name, {"batch": [], "pairs": []})
        row["batch"].append(cs.time_device_ms(fn, 50))
        row["pairs"].append(cs.time_inplace_ms(lambda: None, fn, 30))
record["times"] = times
for form, row in times.items():
    print(form, json.dumps({k: [round(t, 5) for t in v["batch"]]
                            for k, v in row.items()}), flush=True)
with open(OUT, "w") as fh:
    json.dump(record, fh, indent=1)
print("done", flush=True)
