"""The port's native host module (``corrosion_tpu_torch/native``) against
its Python twins and the reference's native module, byte for byte.

The cases are those of ``tests/test_native.py``: value-codec round
trips, every truncation cut failing with the same error type,
``value_cmp``'s order, ``deframe`` at every prefix split, the speedy
change-array loops.  Each input goes through the port's native
function, the port's Python twin and ``corrosion_tpu.native``'s
function.  Then: the agent's call sites resolve to the port's module,
which lies in its own ignored build directory and is a module object of
its own beside the reference's.
"""

import array
import os
import random
import subprocess

import numpy as np
import pytest

from corrosion_tpu import native as ref_native_pkg
from corrosion_tpu.bridge import speedy as ref_speedy
from corrosion_tpu.types.base import CrsqlDbVersion as RefDbv
from corrosion_tpu.types.base import CrsqlSeq as RefSeq
from corrosion_tpu.types.change import Change as RefChange
from corrosion_tpu_torch import native as port_native_pkg
from corrosion_tpu_torch.agent import pack
from corrosion_tpu_torch.bridge import speedy
from corrosion_tpu_torch.types.base import CrsqlDbVersion, CrsqlSeq
from corrosion_tpu_torch.types.change import Change

native = port_native_pkg.load()
ref = ref_native_pkg.load()

pytestmark = pytest.mark.skipif(
    native is None or ref is None,
    reason="no C++ toolchain: Python fallback in use",
)

SEEDS = [11, 12, 13]


def _rand_value(rng):
    kind = int(rng.integers(6))
    if kind == 0:
        return None
    if kind == 1:
        return int(rng.integers(-(2**62), 2**62))
    if kind == 2:
        return float(rng.random() * 1e6 - 5e5)
    if kind == 3:
        return "".join(chr(int(c)) for c in rng.integers(
            1, 0x250, int(rng.integers(12))))
    if kind == 4:
        return rng.integers(0, 256, int(rng.integers(12))).astype(
            np.uint8).tobytes()
    return bool(rng.integers(2))


def _outcome(fn, *args):
    """``fn(*args)``'s value, or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - the type is the outcome
        return type(e)


@pytest.mark.parametrize("seed", SEEDS)
def test_pack_unpack_equal_twin_and_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        vals = [_rand_value(rng) for _ in range(int(rng.integers(5)))]
        pb = pack._py_pack_values(vals)
        assert native.pack_values(vals) == pb == ref.pack_values(vals), vals
        assert (native.unpack_values(pb) == pack._py_unpack_values(pb)
                == ref.unpack_values(pb))


@pytest.mark.parametrize("seed", SEEDS)
def test_every_truncation_cut_fails_alike(seed):
    rng = np.random.default_rng(seed)
    vals = [_rand_value(rng) for _ in range(6)] + [1, "abc", b"\x00\x01"]
    good = native.pack_values(vals)
    for cut in range(1, len(good)):
        part = good[:cut]
        want = _outcome(pack._py_unpack_values, part)
        assert _outcome(native.unpack_values, part) == want, cut
        assert _outcome(ref.unpack_values, part) == want, cut
    for bad in (b"\x09", b"\x05"):
        assert (_outcome(native.unpack_values, bad)
                == _outcome(pack._py_unpack_values, bad)
                == _outcome(ref.unpack_values, bad) == ValueError)
    for vals in ([object()], [array.array("b", [1, 2])]):
        assert (_outcome(native.pack_values, vals)
                == _outcome(pack._py_pack_values, vals)
                == _outcome(ref.pack_values, vals) == TypeError)
    assert (_outcome(native.pack_values, [2**70])
            == _outcome(pack._py_pack_values, [2**70])
            == _outcome(ref.pack_values, [2**70]) == OverflowError)


@pytest.mark.parametrize("seed", SEEDS)
def test_value_cmp_order(seed):
    rng = np.random.default_rng(seed)
    vals = [_rand_value(rng) for _ in range(50)]
    for a in vals:
        for b in vals:
            want = pack._py_value_cmp(a, b)
            assert native.value_cmp(a, b) == want == ref.value_cmp(a, b), (
                a, b)
    # INTEGER > FLOAT > TEXT > BLOB > NULL
    for a, b in ((0, 1e9), (1.0, "zzz"), ("", b"\xff"), (b"", None)):
        assert native.value_cmp(a, b) == 1 == -native.value_cmp(b, a)


@pytest.mark.parametrize("seed", SEEDS)
def test_deframe_at_every_prefix_split(seed):
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, int(rng.integers(40))).astype(
        np.uint8).tobytes() for _ in range(12)]
    stream = b"".join(speedy.frame(p) for p in payloads)
    assert stream == b"".join(ref_speedy.frame(p) for p in payloads)
    for cut in range(len(stream) + 1):
        want = speedy._py_deframe(stream[:cut])
        assert native.deframe(stream[:cut], speedy.MAX_FRAME_LEN) == want
        assert ref.deframe(stream[:cut], speedy.MAX_FRAME_LEN) == want
        assert speedy.deframe(stream[:cut]) == want
    bad = b"\xff\xff\xff\xff rest"
    assert (_outcome(native.deframe, bad, speedy.MAX_FRAME_LEN)
            == _outcome(ref.deframe, bad, ref_speedy.MAX_FRAME_LEN)
            == ValueError)
    assert (_outcome(speedy.deframe, bad) == _outcome(speedy._py_deframe, bad)
            == speedy.SpeedyError)


def _changes(seed, cls, dbv, sq, n=150):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(cls(
            table=("tests", "tbl_ü", "x")[int(rng.integers(3))],
            pk=rng.integers(0, 256, int(rng.integers(1, 20))).astype(
                np.uint8).tobytes(),
            cid=("text", "-1", "cöl")[int(rng.integers(3))],
            val=_rand_value(rng),
            col_version=int(rng.integers(0, 2**40)),
            db_version=dbv(int(rng.integers(0, 2**40))),
            seq=sq(i),
            site_id=rng.integers(0, 256, 16).astype(np.uint8).tobytes(),
            cl=int(rng.integers(1, 9)),
        ))
    return out


def _norm(c):
    # bools ride the wire as ints (SqliteValue has no bool)
    v = int(c.val) if isinstance(c.val, bool) else c.val
    return (c.table, c.pk, c.cid, v, c.col_version, int(c.db_version),
            int(c.seq), c.site_id, c.cl)


@pytest.mark.parametrize("seed", [77, 78])
def test_speedy_change_loops(seed):
    changes = _changes(seed, Change, CrsqlDbVersion, CrsqlSeq)
    ref_changes = _changes(seed, RefChange, RefDbv, RefSeq)
    w = speedy.Writer()
    for c in changes:
        speedy._w_change(w, c)
    twin = w.getvalue()
    nat = native.speedy_encode_changes(changes)
    assert nat == twin == ref.speedy_encode_changes(ref_changes)
    w = speedy.Writer()
    speedy._w_changes(w, changes)  # the call site: native
    assert w.getvalue() == twin
    tups, end = native.speedy_decode_changes(nat, 0, len(changes))
    assert end == len(nat)
    assert (tups, end) == ref.speedy_decode_changes(nat, 0, len(changes))
    r = speedy.Reader(nat)
    out = speedy._r_changes(r, len(changes))
    assert r.pos == len(nat)
    assert [_norm(c) for c in out] == [_norm(c) for c in changes]
    for cut in (1, len(nat) // 2, len(nat) - 3):
        with pytest.raises(speedy.SpeedyError):
            speedy._r_changes(speedy.Reader(nat[:cut]), len(changes))
    for off in (-4, len(nat) + 1):
        assert (_outcome(native.speedy_decode_changes, nat, off, 1)
                == _outcome(ref.speedy_decode_changes, nat, off, 1)
                == ValueError)


def test_speedy_change_edges():
    """u64-domain versions and bytes-like values."""
    c = Change(table="t", pk=bytearray(b"\x01\x02"), cid="c",
               val=bytearray(b"ab"), col_version=1,
               db_version=CrsqlDbVersion(2**63 + 5),
               seq=CrsqlSeq(2**64 - 2), site_id=bytes(16), cl=1)
    w = speedy.Writer()
    speedy._w_change(w, c)
    nat = native.speedy_encode_changes([c])
    assert nat == w.getvalue() == ref.speedy_encode_changes([c])
    out = speedy._r_changes(speedy.Reader(nat), 1)[0]
    assert int(out.db_version) == 2**63 + 5
    assert int(out.seq) == 2**64 - 2


def test_agent_call_sites_resolve_to_the_port_module():
    assert pack.pack_values is native.pack_values
    assert pack.unpack_values is native.unpack_values
    assert pack.value_cmp is native.value_cmp
    assert speedy._native is native and speedy._native_mod is native
    assert speedy.deframe is not speedy._py_deframe
    assert pack._py_pack_values is not native.pack_values


def test_two_modules_and_the_ignored_build():
    """The port's module and the reference's are two module objects
    under distinct qualified names and files; the port's file lies in
    ``corrosion_tpu_torch/native/build/``, which git ignores."""
    assert native is not ref
    assert native.__spec__.name == "corrosion_tpu_torch.native._corrosion_native"
    assert ref.__spec__.name == "corrosion_tpu.native._corrosion_native"
    assert os.path.realpath(native.__file__) != os.path.realpath(ref.__file__)
    build = os.path.realpath(port_native_pkg.BUILD_DIR)
    assert os.path.dirname(os.path.realpath(native.__file__)) == build
    assert os.path.realpath(native.__file__) == os.path.realpath(
        port_native_pkg.so_path())
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rel = os.path.relpath(native.__file__, root)
    probe = subprocess.run(["git", "check-ignore", "-q", rel], cwd=root)
    if probe.returncode == 128:
        pytest.skip("not a git checkout")
    assert probe.returncode == 0, f"{rel} is not ignored by git"


def test_opt_out_is_the_ports_own_switch():
    """``CORROSION_TPU_TORCH_NO_NATIVE`` turns the port's module off in
    a fresh process; the reference's switch leaves it on."""
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("from corrosion_tpu_torch.agent import pack\n"
            "print(pack.pack_values is pack._py_pack_values)\n")
    got = {}
    for env_name in (port_native_pkg.NO_NATIVE_ENV, "CORROSION_TPU_NO_NATIVE"):
        env = {k: v for k, v in os.environ.items()
               if k not in (port_native_pkg.NO_NATIVE_ENV,
                            "CORROSION_TPU_NO_NATIVE")}
        env.update({env_name: "1", "PYTHONPATH": root})
        out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                             capture_output=True, text=True, timeout=120,
                             check=True)
        got[env_name] = out.stdout.strip()
    assert got == {port_native_pkg.NO_NATIVE_ENV: "True",
                   "CORROSION_TPU_NO_NATIVE": "False"}
