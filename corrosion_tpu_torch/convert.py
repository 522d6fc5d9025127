"""Carry simulator state and PRNG keys between the reference and the
port.

The simulator has no weights; its state plays that role.  A reference
``EpidemicState`` (with ``sent`` when tracked), ``PackedExactState``,
``FrontierExactState``, calibration-scale ``ExactState`` or
``SwimState`` (any NamedTuple or mapping with its fields, the values
numpy arrays or anything ``np.asarray`` takes), or an anti-entropy
carry ``(bits, msgs)``, becomes the port's tensors on a given device,
and back, so both sides can start from the same state and keys.  An
exact-sampler state may be one seed's (leaves [N, ...], as
``packed_exact_tick`` holds it) or a seed batch's (leaves [S, N, ...]
and ticks [S], as the vmapped runners hold it); the port's always has
the seed axis.
"""

from __future__ import annotations

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.models.swim import SwimState
from corrosion_tpu_torch.random import key_words
from corrosion_tpu_torch.sim.calibrate import (
    ExactState,
    FrontierExactState,
    PackedExactState,
)
from corrosion_tpu_torch.sim.epidemic import EpidemicState

TENSOR_FIELDS = ("rows", "tx_remaining", "msgs", "hops", "next_send")
# the exact-sampler leaves and their dtypes (``sent`` / ``ring`` by type)
EXACT_FIELDS = {"infected": np.bool_, "tx": np.int32,
                "next_send": np.int32, "msgs": np.int32,
                "pending": np.int32}


def _fields(state) -> dict:
    return dict(state._asdict() if hasattr(state, "_asdict") else state)


def _tensor(x, dtype, device):
    if x is None:
        return None
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def state_from_numpy(state, device="cuda") -> EpidemicState:
    """The port's ``EpidemicState`` on ``device`` from a reference
    state given as numpy arrays (``sent`` [N, N] bool when tracked;
    with a leading seed axis on every leaf for the ``track_sent``
    runner's batched state).  The tick must be one for all seeds."""
    device = resolve_device(device)
    d = _fields(state)
    ticks = np.unique(np.asarray(d["tick"]))
    if ticks.size != 1:
        raise ValueError(f"the seeds of a batch tick together, got ticks "
                         f"{ticks.tolist()}")
    return EpidemicState(
        tick=int(ticks[0]),
        sent=_tensor(d.get("sent"), np.bool_, device),
        **{f: _tensor(d[f], np.int32, device) for f in TENSOR_FIELDS},
    )


def state_to_numpy(state: EpidemicState) -> dict:
    """{field: numpy array (or None)} of a port state, tick as an int."""
    out = {
        f: None if getattr(state, f) is None
        else getattr(state, f).cpu().numpy()
        for f in (*TENSOR_FIELDS, "sent")
    }
    out["tick"] = int(state.tick)
    return out


def exact_state_from_numpy(state, device="cuda") -> ExactState:
    """The port's calibration-scale ``ExactState`` on ``device`` from a
    reference one ([N] leaves, ``sent`` [N, N]) given as numpy arrays;
    ``exact_state_to_numpy`` is its inverse."""
    device = resolve_device(device)
    d = _fields(state)
    return ExactState(
        tick=int(np.asarray(d["tick"])),
        sent=_tensor(d["sent"], np.bool_, device),
        **{f: _tensor(d[f], EXACT_FIELDS[f], device)
           for f in ("infected", "tx", "next_send", "msgs")},
    )


def _exact_from_numpy(cls, memory: str, dtype, state, device):
    device = resolve_device(device)
    d = _fields(state)
    batched = np.ndim(d["infected"]) == 2
    ticks = np.unique(np.asarray(d["tick"]))
    if ticks.size != 1:
        raise ValueError(f"the seeds of a batch tick together, got ticks "
                         f"{ticks.tolist()}")

    def tensor(x, dt):
        a = np.array(x, dtype=dt)
        return torch.from_numpy(a if batched else a[None]).to(device)

    leaves = {f: tensor(d[f], dt) for f, dt in EXACT_FIELDS.items()}
    return cls(tick=int(ticks[0]), **{memory: tensor(d[memory], dtype)},
               **leaves)


def packed_state_from_numpy(state, device="cuda") -> PackedExactState:
    """The port's ``PackedExactState`` on ``device`` from a reference
    one (single-seed or seed-batched) given as numpy arrays."""
    return _exact_from_numpy(PackedExactState, "sent", np.uint8, state,
                             device)


def frontier_state_from_numpy(state, device="cuda") -> FrontierExactState:
    """The port's ``FrontierExactState`` on ``device`` from a reference
    one (single-seed or seed-batched) given as numpy arrays."""
    return _exact_from_numpy(FrontierExactState, "ring", np.int32, state,
                             device)


def exact_state_to_numpy(state) -> dict:
    """{field: numpy array} of a port ``PackedExactState`` or
    ``FrontierExactState`` (with the seed axis) or ``ExactState``, tick
    as an int (the inverse of the ``*_from_numpy`` of each)."""
    out = {f: v.cpu().numpy() for f, v in state._asdict().items()
           if f != "tick"}
    out["tick"] = int(state.tick)
    return out


def anti_entropy_from_numpy(carry, device="cuda") -> tuple:
    """The port's anti-entropy carry (bits [N, S] bool, msgs [N] int32)
    on ``device`` from a reference ``(bits, msgs)``."""
    device = resolve_device(device)
    bits, msgs = carry
    return (torch.from_numpy(np.array(bits, dtype=np.bool_)).to(device),
            torch.from_numpy(np.array(msgs, dtype=np.int32)).to(device))


def anti_entropy_to_numpy(carry) -> tuple:
    """(bits, msgs) numpy arrays of a port anti-entropy carry."""
    return tuple(t.cpu().numpy() for t in carry)


def swim_state_from_numpy(state, device="cuda") -> SwimState:
    """The port's ``SwimState`` on ``device`` from a reference one given
    as numpy arrays (every leaf int32)."""
    device = resolve_device(device)
    d = _fields(state)
    return SwimState(**{
        f: torch.from_numpy(np.array(d[f], dtype=np.int32)).to(device)
        for f in SwimState._fields
    })


def swim_state_to_numpy(state: SwimState) -> dict:
    """{field: numpy array} of a port ``SwimState``."""
    return {f: getattr(state, f).cpu().numpy() for f in SwimState._fields}


def key_from_numpy(key) -> torch.Tensor:
    """A port key (host ``uint32[2]`` tensor) from a reference key."""
    return torch.tensor(key_words(np.asarray(key)), dtype=torch.uint32)


def key_to_numpy(key) -> np.ndarray:
    return np.asarray(key_words(key), dtype=np.uint32)
