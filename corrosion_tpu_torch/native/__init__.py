"""Native host kernels with transparent build + Python fallback.

A copy of ``corrosion_tpu/native/__init__.py`` re-rooted on this
package.  ``load()`` returns the compiled ``_corrosion_native`` module,
building it from ``_corrosion_native.cc`` beside this file with the
system C++ toolchain on first use, into ``build/`` here (ignored by git;
rebuilt when the source is newer).  Callers fall back to their
pure-Python twins when no toolchain is available, so the package never
hard-depends on a compiler: that fallback is host code's, not a device
path's.

Set ``CORROSION_TPU_TORCH_NO_NATIVE=1`` to force the Python paths (the
reference's own switch does not reach this package).  The module loads
under its own qualified name, ``corrosion_tpu_torch.native.
_corrosion_native``, from its own file, so it and the reference's
extension are two module objects in one process.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "_corrosion_native.cc")
BUILD_DIR = os.path.join(_DIR, "build")
MODULE_NAME = "corrosion_tpu_torch.native._corrosion_native"
NO_NATIVE_ENV = "CORROSION_TPU_TORCH_NO_NATIVE"

_lock = threading.Lock()
_cached = None
_failed = False


def so_path() -> str:
    tag = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, f"_corrosion_native{tag}")


def _fail_marker() -> str:
    return so_path() + ".buildfail"


def _build(so: str) -> bool:
    cxx = os.environ.get("CXX", "g++")
    include = sysconfig.get_path("include")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-process tmp: concurrent first-use builds (several agents, test
    # workers) must not interleave writes into one tmp file — os.replace
    # then installs whichever complete build finishes last
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        cxx, "-O2", "-fPIC", "-shared", "-std=c++17",
        f"-I{include}", _SRC, "-o", tmp,
    ]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120,
        )
    except (OSError, subprocess.TimeoutExpired):
        _record_failure("toolchain missing or timed out")
        return False
    if proc.returncode != 0:
        sys.stderr.write(
            f"corrosion_tpu_torch.native: build failed, using Python "
            f"fallback:\n{proc.stderr[-2000:]}\n"
        )
        _record_failure(proc.stderr[-500:])
        return False
    os.replace(tmp, so)
    try:
        os.unlink(_fail_marker())
    except OSError:
        pass
    return True


def _record_failure(reason: str) -> None:
    """Persist the failure keyed by source mtime so OTHER processes skip
    the doomed compile instead of each paying for it at import."""
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(_fail_marker(), "w") as f:
            f.write(f"{os.path.getmtime(_SRC)}\n{reason}\n")
    except OSError:
        pass


def _known_bad() -> bool:
    try:
        with open(_fail_marker()) as f:
            recorded = float(f.readline().strip())
        return recorded == os.path.getmtime(_SRC)
    except (OSError, ValueError):
        return False


def load():
    """The native module, or None (build failure / opted out)."""
    global _cached, _failed
    if _cached is not None:
        return _cached
    if _failed or os.environ.get(NO_NATIVE_ENV):
        return None
    with _lock:
        if _cached is not None or _failed:
            return _cached
        so = so_path()
        try:
            stale = (not os.path.exists(so)
                     or os.path.getmtime(so) < os.path.getmtime(_SRC))
            if stale and _known_bad():
                _failed = True
                return None
            if stale and not _build(so):
                _failed = True
                return None
            spec = importlib.util.spec_from_file_location(MODULE_NAME, so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _cached = mod
        except Exception as e:  # noqa: BLE001 - any failure -> fallback
            sys.stderr.write(
                f"corrosion_tpu_torch.native: load failed ({e!r}), "
                "using Python fallback\n"
            )
            _failed = True
            return None
    return _cached


def load_or_none():
    """:func:`load`, guaranteed never to raise — THE call-site API: the
    dispatch shims in agent/pack.py and bridge/speedy.py must not let a
    packaging problem break import of the pure-Python paths."""
    try:
        return load()
    except Exception:  # noqa: BLE001 - any failure -> fallback
        return None
