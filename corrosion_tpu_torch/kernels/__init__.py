"""Hand-written CUDA kernels of the port, their build and their binding.

Each ``csrc/<name>.cu`` is a CUDA C++ source with a plain C launch
function.  ``build`` compiles the sources of this checkout, and nothing
else, with ``nvcc`` for ``sm_90a`` into one shared library each under
``build/`` (named by a hash of source and flags, so an edited source
rebuilds), one ``nvcc`` per source, all started together.  ``load``
opens a library with ctypes, building it first when it is missing.

Each kernel module (``threefry``, ``deliver``, ``sync_pull``,
``tick_stats``, ``exact_send``, ``seq_sync``, ``swim``,
``sent_sampler``, ``seg_sort``, ``winners``) holds the
wrapper, the kernel's plain PyTorch version and a launch counter.  The
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  Kernels run on PyTorch's
current stream and allocate nothing: wrappers allocate outputs with
``torch.empty`` and check the launch's ``cudaGetLastError`` code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("threefry", "deliver_perm", "sync_pull", "tick_stats",
           "exact_send", "seq_sync", "swim", "sent_sampler", "seg_sort",
           "winners")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA "
        "toolkit is installed"
    )


def library_path(name: str) -> Path:
    """Where ``name``'s library lives: named by a hash of its source,
    the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict:
    """Compile every missing library, all ``nvcc`` runs at once.

    Returns {name: compiler output} (ptxas register and shared-memory
    report) for the libraries built by this call; raises with the
    compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
        running[name] = (proc, log, tmp, path)
    logs, failed = {}, []
    for name, (proc, log, tmp, path) in running.items():
        proc.wait()
        log.close()
        logs[name] = path.with_suffix(".log").read_text()
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C launch function ``symbol`` of library ``name``, typed: every
    pointer and the stream as ``c_void_p`` (so ctypes never cuts them to
    32 bits), returning the ``cudaGetLastError`` code as ``c_int``."""
    key = (name, symbol)
    fn = _LIBS.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _LIBS[key] = fn
    return fn


def on_cpu(*tensors) -> bool:
    """True when every given tensor lies on the CPU (the plain path),
    False when all lie on one CUDA device (the kernel); raises on a mix
    or on another device type."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        names = sorted(map(str, devices))
        raise ValueError(f"tensors on several devices: {names}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {device}")


def check(name: str, t, dtype, shape=None, align: int = 4) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``), ``align``-byte aligned, that a kernel can take by
    pointer."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: expected a {align}-byte aligned tensor")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer argument (NULL for an absent optional tensor)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on_error(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{code}")
