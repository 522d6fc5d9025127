"""Carry simulator state and PRNG keys between the reference and the
port.

The simulator has no weights; its state plays that role.  A reference
``EpidemicState`` (any NamedTuple or mapping with its fields, the
values numpy arrays or anything ``np.asarray`` takes) becomes the
port's tensors on a given device, and back, so both sides can start
from the same state and keys.
"""

from __future__ import annotations

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.models.broadcast import TRACK_SENT_TODO
from corrosion_tpu_torch.random import key_words
from corrosion_tpu_torch.sim.epidemic import EpidemicState

TENSOR_FIELDS = ("rows", "tx_remaining", "msgs", "hops", "next_send")


def _fields(state) -> dict:
    return dict(state._asdict() if hasattr(state, "_asdict") else state)


def state_from_numpy(state, device="cuda") -> EpidemicState:
    """The port's ``EpidemicState`` on ``device`` from a reference
    state given as numpy arrays."""
    device = resolve_device(device)
    d = _fields(state)
    if d.get("sent") is not None:
        raise NotImplementedError(TRACK_SENT_TODO)

    def tensor(x):
        if x is None:
            return None
        return torch.from_numpy(np.array(x, dtype=np.int32)).to(device)

    return EpidemicState(
        tick=int(np.asarray(d["tick"])),
        **{f: tensor(d[f]) for f in TENSOR_FIELDS},
    )


def state_to_numpy(state: EpidemicState) -> dict:
    """{field: numpy array (or None)} of a port state, tick as an int."""
    out = {
        f: None if getattr(state, f) is None
        else getattr(state, f).cpu().numpy()
        for f in TENSOR_FIELDS
    }
    out["tick"] = int(state.tick)
    return out


def key_from_numpy(key) -> torch.Tensor:
    """A port key (host ``uint32[2]`` tensor) from a reference key."""
    return torch.tensor(key_words(np.asarray(key)), dtype=torch.uint32)


def key_to_numpy(key) -> np.ndarray:
    return np.asarray(key_words(key), dtype=np.uint32)
