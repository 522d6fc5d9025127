"""Cluster-size-scaled SWIM parameters (port of
``corrosion_tpu/utils/swimscale.py``).

The reference rebuilds its foca config whenever cluster size changes
(``make_foca_config(cluster_size)`` calls ``foca::Config::new_wan``),
so suspicion timeouts and update retransmission limits grow
logarithmically with membership: suspicion-mult x ceil(log10(n+1)) x
probe-period.
"""

from __future__ import annotations

import math


def swim_scale_factor(cluster_size: int) -> int:
    """ceil(log10(size+1)), minimum 1 — the dissemination/suspicion
    multiplier's growth term."""
    return max(1, math.ceil(math.log10(max(cluster_size, 1) + 1)))


def scaled_suspect_timeout(
    base: float, probe_interval: float, cluster_size: int,
    suspicion_mult: int = 4,
) -> float:
    """Suspect→down deadline: at least ``base``, growing as mult x
    factor x probe-period once the log term dominates."""
    return max(
        base,
        suspicion_mult * swim_scale_factor(cluster_size) * probe_interval,
    )


def scaled_update_retransmissions(
    cluster_size: int, retransmit_mult: int = 4
) -> int:
    """How many times one membership update is piggybacked before it
    decays out of the gossip backlog."""
    return retransmit_mult * swim_scale_factor(cluster_size)
