"""Anti-entropy sync as dense set reconciliation (port of
``corrosion_tpu/models/sync.py``).

* the **row model** the convergence sims run: a peer's full CRDT state
  is its [R] packed-key row; a pull-merge from peer ``p`` is
  ``max(rows[i], rows[p])`` and the served volume is the count of cells
  where the peer was strictly ahead (that count over cells per chunk =
  chunk messages, the unit the north-star metric counts).
  ``sync_step`` runs as the ``sync_pull`` kernel on a card;
* the **sequence-chunked reassembly** model of config #4: a dense
  [N, S] seq bitmap per node, served in ascending seq order in chunks
  of ``seqs_per_chunk`` under a session budget, each chunk lost i.i.d.
  (``seq_sync_step``, the ``seq_sync`` kernel on a card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from corrosion_tpu_torch.kernels.seq_sync import seq_sync
from corrosion_tpu_torch.kernels.sync_pull import (  # noqa: F401
    session_msgs,
    sync_pull,
)
from corrosion_tpu_torch.models.common import severance_matrix, universe_width
from corrosion_tpu_torch.random import key_words, randint, randint_span, split


@dataclass(frozen=True)
class SyncParams:
    n_nodes: int
    peers_per_round: int = 1  # concurrent sync partners
    cells_per_chunk: int = 64  # cells that fit one 8 KiB chunk message
    handshake_msgs: int = 2  # SyncStart + State exchange per session
    # seed-flattening: peer draws stay inside the sender's own universe
    # of this width when set
    universe: Optional[int] = None
    # one-way partitions: a session needs BOTH directions up (the dial
    # runs client→server, the served chunks server→client).  No WAN
    # loss here: anti-entropy sessions ride streams with retries.
    oneway_blocks: Optional[tuple] = None


def bitmap_needs(ours, theirs):
    """Versions the peer has that we don't: ``theirs & ~ours`` over
    ``[..., V]`` bool knowledge bitmaps."""
    return theirs & ~ours


def sync_step(rows, msgs_sent, key, params: SyncParams, partition_id=None,
              partition_active=False):
    """One anti-entropy round: every node pulls from random peers.

    rows: [N, R] int32 packed keys; msgs_sent: [N] int32 cumulative
    message counter; key: uint32[2].  Returns (rows', msgs_sent') on the
    device of ``rows``."""
    n, p = params.n_nodes, params.peers_per_round
    u = universe_width(n, params.universe)
    # the draw of models/common.py rand_peers; the kernel forms the peer
    offs = randint(key, (n, p), 1, max(u, 2), device=rows.device)
    sev = None
    if params.oneway_blocks:
        sev = severance_matrix(params.oneway_blocks, device=rows.device)
    part = None
    if partition_id is not None:
        part = partition_id.to(torch.int32)
    return sync_pull(
        rows, msgs_sent, offs, u, partition_id=part, sev=sev,
        partition_active=bool(partition_active),
        cells_per_chunk=params.cells_per_chunk,
        handshake_msgs=params.handshake_msgs,
    )


# -- sequence-chunked reassembly ---------------------------------------


@dataclass(frozen=True)
class SeqSyncParams:
    n_nodes: int
    n_seqs: int  # seqs in the changeset under reassembly
    peers_per_round: int = 1  # subset peer selection
    seqs_per_chunk: int = 8  # contiguous seqs per chunk message
    chunk_budget: int = 4  # chunks a server sends per session
    loss: float = 0.0  # per-CHUNK drop probability
    handshake_msgs: int = 2
    # seed-flattening (models/common.py)
    universe: Optional[int] = None


def bitmap_gaps(bits):
    """Missing-seq bitmap — the dense twin of ``RangeSet.gaps``.

    bits: [..., S] bool (seqs held)."""
    return ~bits


def seq_sync_step(bits, msgs_sent, key, params: SeqSyncParams):
    """One anti-entropy round over partially-reassembled changesets.

    bits: [N, S] bool (seqs each node holds); msgs_sent: [N] int32
    cumulative message counter; key: uint32[2].  Each node pulls from
    ``peers_per_round`` random peers; a serving peer walks the client's
    needs (``peer & ~mine``) in ascending seq order and sends up to
    ``chunk_budget`` chunks of ``seqs_per_chunk`` seqs, each dropped
    i.i.d. with ``loss``.  Returns (bits', msgs_sent') on the device of
    ``bits``."""
    n = params.n_nodes
    u = universe_width(n, params.universe)
    k_peers, k_drop = split(key)
    peer_keys = tuple(key_words(k) for k in split(k_peers))
    span, mult = randint_span(1, max(u, 2))
    return seq_sync(
        bits, msgs_sent, peer_keys, key_words(k_drop), u, span, mult,
        peers_per_round=params.peers_per_round,
        seqs_per_chunk=params.seqs_per_chunk,
        chunk_budget=params.chunk_budget, loss=params.loss,
        handshake_msgs=params.handshake_msgs,
    )
