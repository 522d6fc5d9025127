"""CRDT merge of packed keys (port of ``corrosion_tpu/ops/merge.py``,
part A: the merge the simulator runs).

The merge of two replicas' cell states is an elementwise ``max`` over
packed keys (``ops/keys.py``); message delivery into a replica array
is a scatter-max.  The columnar batched-apply half of the reference
module belongs to the agent's device path and is not ported yet.
"""

from __future__ import annotations

import torch


def merge_keys(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two equally-shaped packed-key tensors (commutative,
    idempotent, associative — the CRDT join)."""
    return torch.maximum(a, b)


def merge_cells(states: torch.Tensor) -> torch.Tensor:
    """Merge replica states along the leading axis: [R, ...] -> [...]."""
    return torch.amax(states, dim=0)


def scatter_merge(state: torch.Tensor, targets: torch.Tensor,
                  msg_keys: torch.Tensor) -> torch.Tensor:
    """Deliver messages into a replica-indexed state via scatter-max.

    state:    [N, ...cells] packed keys, one row per replica.
    targets:  [M] int replica indices (may repeat; duplicates merge).
    msg_keys: [M, ...cells] packed keys carried by each message.

    Returns the updated state (``state`` is left as it was).  Targets
    outside [-N, N) are dropped, as the reference's ``mode="drop"``
    does, and negative ones count from the end: every dropped message
    lands on one pad row past the end that is sliced off again."""
    n = state.shape[0]
    t = targets.to(torch.int64)
    t = torch.where(t < 0, t + n, t)
    t = torch.where((t >= 0) & (t < n), t, n)
    pad = state.new_empty((1,) + tuple(state.shape[1:]))
    padded = torch.cat([state, pad])
    msg_keys = msg_keys.to(state.dtype)
    index = t.reshape((-1,) + (1,) * (msg_keys.dim() - 1)).expand_as(msg_keys)
    padded.scatter_reduce_(0, index, msg_keys, "amax", include_self=True)
    return padded[:n]
