"""The device clock cache's array store (csrc/store.cu): ``store_gather``
and ``store_set``.

Replace corrosion_tpu/ops/devcache.py ``JaxStore.gather`` (:155) and
``JaxStore.set`` (:143), which ``ops.devcache.TorchStore`` calls with
host index and value arrays, as the reference's store is called.  The
wrappers check every index on the host (``IndexError`` out of range,
negative ones wrapped, as NumPy does), copy the host arrays to the
array's device and launch at n, with no padding.  ``store_set`` keeps
NumPy's answer on a repeated index, the last pair, through an int32
owner buffer of at least the array's length that holds -1 between calls
(``new_owner``; the kernels put it back).  Bound on the H100: bytes, a
32-byte sector per random access.

``gather_launch`` / ``set_launch`` take device tensors: the wrappers
call them, and each counts its launches on ``store_gather.launches`` /
``store_set.launches``, one a call: ``store_set``'s call is two kernel
launches, the claim and the write, the write under programmatic
dependent launch (it is scheduled while the claim runs and waits on
the card for it to finish); a launch the card refuses raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from corrosion_tpu_torch import kernels

_P = ctypes.c_void_p
_GATHER_ARGTYPES = (_P, _P, ctypes.c_longlong, _P, _P)
_SET_ARGTYPES = (_P, _P, _P, ctypes.c_longlong, _P, _P)


def new_owner(cap: int, device) -> torch.Tensor:
    """``store_set``'s owner buffer for arrays of up to ``cap``
    entries on ``device``: int32, -1 everywhere."""
    return torch.full((cap,), -1, dtype=torch.int32, device=device)


def host_index(idx, cap: int) -> np.ndarray:
    """``idx`` as contiguous int64 in 0..cap-1, as NumPy reads an index
    array into an axis of ``cap``: negative entries count from the end,
    and any outside -cap..cap-1 raises ``IndexError``."""
    idx = np.asarray(idx)
    if not np.issubdtype(idx.dtype, np.integer):
        raise IndexError("arrays used as indices must be of integer type")
    idx = np.ascontiguousarray(idx, dtype=np.int64).reshape(-1)
    if len(idx):
        lo, hi = int(idx.min()), int(idx.max())
        if hi >= cap or lo < -cap:
            bad = int(idx[(idx >= cap) | (idx < -cap)][0])
            raise IndexError(f"index {bad} is out of bounds for axis 0 "
                             f"with size {cap}")
        if lo < 0:
            idx = np.where(idx < 0, idx + cap, idx)
    return idx


def store_gather_plain(arr, idx):
    """Plain PyTorch version of the gather: ``arr[idx]`` (idx in
    range)."""
    return arr[idx]


def store_set_plain(arr, idx, vals):
    """Plain PyTorch version of the set: ``arr[idx] = vals`` in place
    with the last pair of a repeated index winning (its last occurrence,
    found through ``torch.unique``).  Returns ``arr``."""
    if idx.shape[0] == 0:
        return arr
    uniq, inv = torch.unique(idx, return_inverse=True)
    last = torch.full(uniq.shape, -1, dtype=torch.int64, device=idx.device)
    last.scatter_reduce_(0, inv, torch.arange(idx.shape[0],
                                              device=idx.device), "amax")
    arr[uniq] = vals[last]
    return arr


def _check_arr(name, arr):
    if arr.dim() != 1:
        raise ValueError(f"{name}: expected a 1-D array")
    kernels.check(name, arr, torch.int64, align=8)


def gather_launch(arr, idx) -> torch.Tensor:
    """The gather kernel on CUDA tensors: int64 [cap] ``arr``, int64
    [n] ``idx`` in 0..cap-1; returns a new int64 [n] tensor."""
    n = idx.shape[0]
    _check_arr("store_gather arr", arr)
    kernels.check("store_gather idx", idx, torch.int64, (n,), align=8)
    out = torch.empty(n, dtype=torch.int64, device=arr.device)
    if n == 0:
        return out
    pt = kernels.ptr
    fn = kernels.function("store", "store_gather_launch", _GATHER_ARGTYPES)
    code = fn(pt(arr), pt(idx), n, pt(out), kernels.stream(arr))
    store_gather.launches += 1
    kernels.raise_on_error("store_gather", code)
    return out


def set_launch(arr, idx, vals, owner) -> None:
    """The set kernels on CUDA tensors, in place: int64 [cap] ``arr``,
    int64 [n] ``idx`` in 0..cap-1 and ``vals``, int32 ``owner`` of at
    least cap entries, -1 everywhere (and so again on return)."""
    n = idx.shape[0]
    _check_arr("store_set arr", arr)
    kernels.check("store_set idx", idx, torch.int64, (n,), align=8)
    kernels.check("store_set vals", vals, torch.int64, (n,), align=8)
    kernels.check("store_set owner", owner, torch.int32)
    if owner.dim() != 1 or owner.shape[0] < arr.shape[0]:
        raise ValueError("store_set: the owner buffer is shorter than the "
                         "array")
    if n == 0:
        return
    pt = kernels.ptr
    fn = kernels.function("store", "store_set_launch", _SET_ARGTYPES)
    code = fn(pt(arr), pt(idx), pt(vals), n, pt(owner), kernels.stream(arr))
    store_set.launches += 1
    kernels.raise_on_error("store_set", code)


def store_gather(arr, idx) -> np.ndarray:
    """``arr[idx]`` fetched to the host as an int64 ndarray, as
    ``NumpyStore.gather`` returns it: ``arr`` an int64 [cap] tensor,
    ``idx`` a host integer array."""
    idx = host_index(idx, arr.shape[0])
    if kernels.on_cpu(arr):
        return store_gather_plain(arr, torch.from_numpy(idx)).numpy()
    return gather_launch(arr, torch.from_numpy(idx).to(arr.device)).cpu() \
        .numpy()


def store_set(arr, idx, vals, owner=None):
    """``arr[idx] = vals`` in place, the last pair of a repeated index
    winning, as ``NumpyStore.set``; returns ``arr``.  ``idx`` / ``vals``
    are host arrays of one length; a CUDA ``arr`` needs its ``owner``
    buffer (``new_owner``)."""
    idx = host_index(idx, arr.shape[0])
    vals = np.ascontiguousarray(vals, dtype=np.int64).reshape(-1)
    if len(vals) != len(idx):
        raise ValueError(f"store_set: {len(idx)} indices and {len(vals)} "
                         "values")
    if kernels.on_cpu(arr):
        return store_set_plain(arr, torch.from_numpy(idx),
                               torch.from_numpy(vals))
    if owner is None:
        raise ValueError("store_set: a CUDA array needs its owner buffer")
    dev = arr.device
    set_launch(arr, torch.from_numpy(idx).to(dev),
               torch.from_numpy(vals).to(dev), owner)
    return arr


store_gather.launches = 0
store_set.launches = 0
