"""SWIM membership as a state machine over an [N, N] view matrix (port
of ``corrosion_tpu/models/swim.py``).

``view[i, j]`` is node i's knowledge of node j packed as
``incarnation * 4 + state_rank`` (alive=0 < suspect=1 < down=2), so
SWIM's override rules are one numeric ``max``.  Each protocol period a
member pings one random peer, asks ``num_indirect_probes`` helpers on
failure, suspects the peer when nothing comes back, turns an
unrefuted suspicion into down after the timeout, gossips its freshest
entries (foca's update backlog) and piggybacks them on probes and
acks; a member that learns it is suspected or down refutes with a
bumped incarnation.  ``swim_step`` runs as the ``swim`` kernels on a
card and their plain version on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.kernels.swim import (  # noqa: F401
    ALIVE,
    DOWN,
    SUSPECT,
    swim_tick,
)
from corrosion_tpu_torch.kernels.swim import NEVER as _NEVER
from corrosion_tpu_torch.utils.swimscale import (
    scaled_suspect_timeout,
    scaled_update_retransmissions,
)


@dataclass(frozen=True)
class SwimParams:
    n_nodes: int
    num_indirect_probes: int = 3  # ping-req helpers after a failed ping
    suspect_timeout: int = 6  # ticks before suspect -> down
    gossip_targets: int = 3  # peers gossiped to per tick
    gossip_entries: int = 6  # view entries piggybacked per gossip msg
    loss: float = 0.0  # per-leg message drop probability
    # foca's update backlog decay: an entry rides at most this many
    # gossip rounds after it last changed, then leaves circulation
    update_tx_limit: int = 8

    @classmethod
    def scaled(cls, n_nodes: int, probe_ticks: int = 1, **overrides):
        """Cluster-size-scaled parameters (foca ``Config::new_wan``):
        suspicion deadline and update retransmission limit grow with
        ceil(log10(n+1))."""
        defaults = dict(
            suspect_timeout=int(
                scaled_suspect_timeout(0, probe_ticks, n_nodes)
            ),
            update_tx_limit=scaled_update_retransmissions(n_nodes),
        )
        defaults.update(overrides)
        return cls(n_nodes=n_nodes, **defaults)


class SwimState(NamedTuple):
    view: torch.Tensor  # [N, N] int32 packed (inc*4 + state)
    suspect_since: torch.Tensor  # [N, N] int32 tick, _NEVER when not suspect
    incarnation: torch.Tensor  # [N] int32 own incarnation
    msgs: torch.Tensor  # [N] int32 messages sent
    # [N, N] gossip rounds entry (i, j) rode since it last changed
    update_tx: torch.Tensor


def member_key(inc, state):
    return inc * 4 + state


def key_state(key):
    return key % 4


def key_inc(key):
    return key // 4


def swim_init(n_nodes: int, device="cuda") -> SwimState:
    """Everyone starts knowing everyone alive at incarnation 0."""
    device = resolve_device(device)
    i32 = torch.int32
    return SwimState(
        view=torch.zeros((n_nodes, n_nodes), dtype=i32, device=device),
        suspect_since=torch.full((n_nodes, n_nodes), _NEVER, dtype=i32,
                                 device=device),
        incarnation=torch.zeros(n_nodes, dtype=i32, device=device),
        msgs=torch.zeros(n_nodes, dtype=i32, device=device),
        update_tx=torch.zeros((n_nodes, n_nodes), dtype=i32, device=device),
    )


def swim_step(state: SwimState, key, tick: int, params: SwimParams, alive,
              revived=None, victim=None, flags=None) -> SwimState:
    """One protocol period for all N nodes at once, on the device of
    ``state``.

    alive: [N] bool ground truth (dead nodes never ack, send or
    gossip); revived: optional [N] bool, nodes coming back THIS tick,
    which run the rejoin announce.  ``victim`` / ``flags``: see
    ``kernels.swim.swim_tick``.  Returns the next SwimState."""
    if params.n_nodes != state.view.shape[0]:
        raise ValueError("swim_step: params.n_nodes must match the state")
    return SwimState(*swim_tick(
        state.view, state.suspect_since, state.incarnation, state.msgs,
        state.update_tx, key, int(tick), params, alive, revived,
        victim=victim, flags=flags,
    ))
