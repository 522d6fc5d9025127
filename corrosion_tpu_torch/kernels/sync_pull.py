"""``sync_pull``: one anti-entropy pull round (csrc/sync_pull.cu).

Replaces corrosion_tpu/models/sync.py ``sync_step`` (:90) with its
``session_msgs`` charge (:66), the peer formula of ``rand_peers`` and
the bidirectional ``partition_ok`` (models/common.py :35, :65).  Bound
on the H100: bytes — the client row, one random peer row per draw and
the [N] counters, each moved once.  The kernel merges and counts in
registers and charges the serving peer with an integer ``atomicAdd``,
exact in any order.
"""

from __future__ import annotations

import ctypes

import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.kernels.deliver import MAX_ROWS
from corrosion_tpu_torch.models.common import blocks_cross, peers_from_offsets
from corrosion_tpu_torch.ops.merge import merge_cells, merge_keys

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)


def session_msgs(msgs_sent, peers, chunks, handshake_msgs, reachable=None):
    """Charge sync-session messages: the client pays half the handshake
    per session; each serving peer pays the other half plus its chunk
    stream.  peers/chunks: [N, P] (``models/sync.py`` exports it)."""
    if reachable is None:
        reachable = torch.ones(peers.shape, dtype=torch.bool,
                               device=peers.device)
    half = handshake_msgs // 2
    client = reachable.sum(dim=1) * half
    per_server = ((handshake_msgs - half) + chunks) * reachable
    server = torch.zeros_like(msgs_sent).index_add_(
        0, peers.reshape(-1).to(torch.int64),
        per_server.reshape(-1).to(msgs_sent.dtype),
    )
    return msgs_sent + client.to(msgs_sent.dtype) + server


def sync_pull_plain(rows, msgs, offs, u, *, partition_id=None, sev=None,
                    partition_active=False, cells_per_chunk=64,
                    handshake_msgs=2):
    """Plain PyTorch version of the kernel (same arguments and results
    as :func:`sync_pull`)."""
    peers = peers_from_offsets(offs, u).to(torch.int64)  # [N, P]
    reach = torch.ones(peers.shape, dtype=torch.bool, device=rows.device)
    if partition_id is not None and partition_active:
        reach = ~blocks_cross(partition_id[:, None], partition_id[peers],
                              sev, bidirectional=True)
    peer_rows = rows[peers]  # [N, P, R]
    ahead = torch.sum((peer_rows > rows[:, None, :]) & reach[:, :, None],
                      dim=2)
    merged = merge_cells(torch.where(reach[:, :, None], peer_rows,
                                     rows[:, None, :]).transpose(0, 1))
    chunks = -(-ahead // cells_per_chunk)
    return (merge_keys(rows, merged),
            session_msgs(msgs, peers, chunks, handshake_msgs, reach))


def sync_pull(rows, msgs, offs, u, *, partition_id=None, sev=None,
              partition_active=False, cells_per_chunk=64, handshake_msgs=2):
    """Every node pulls from its P peers ``base + (local + offs) % u``.

    rows [N, R] int32 packed keys; msgs [N] int32; offs [N, P] int32
    peer offsets in 1..u-1 (``u`` the universe width);
    partition_id [N] int32 or None; sev [B, B] bool one-way severance
    or None (symmetric).  A session needs both directions up while
    ``partition_active``.  Returns (rows, msgs) as new tensors."""
    if kernels.on_cpu(rows, msgs, offs, partition_id, sev):
        return sync_pull_plain(
            rows, msgs, offs, u, partition_id=partition_id, sev=sev,
            partition_active=partition_active,
            cells_per_chunk=cells_per_chunk, handshake_msgs=handshake_msgs,
        )
    n, r = rows.shape
    p = offs.shape[1]
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"sync_pull: the kernel takes 1..{MAX_ROWS} cells "
                         f"per row, got {r}")
    if cells_per_chunk < 1 or not 1 <= u <= n or n % u:
        raise ValueError("sync_pull: needs cells_per_chunk >= 1 and a "
                         "universe width dividing N")
    i32 = torch.int32
    kernels.check("sync_pull rows", rows, i32, (n, r), align=16)
    kernels.check("sync_pull msgs", msgs, i32, (n,))
    kernels.check("sync_pull offs", offs, i32, (n, p))
    if partition_id is not None:
        kernels.check("sync_pull partition_id", partition_id, i32, (n,))
    sev_b = 0
    if sev is not None:
        sev_b = sev.shape[0]
        sev = sev.to(torch.uint8)
        kernels.check("sync_pull sev", sev, torch.uint8, (sev_b, sev_b), 1)
    rows_out = torch.empty_like(rows)
    msgs_out = msgs.clone()
    pt = kernels.ptr
    fn = kernels.function("sync_pull", "sync_pull_launch", _ARGTYPES)
    code = fn(pt(rows), pt(offs), pt(partition_id), pt(sev), sev_b,
              int(bool(partition_active)), pt(rows_out), pt(msgs_out), n, r,
              p, u, cells_per_chunk, handshake_msgs, kernels.stream(rows))
    sync_pull.launches += 1
    kernels.raise_on_error("sync_pull", code)
    return rows_out, msgs_out


sync_pull.launches = 0
