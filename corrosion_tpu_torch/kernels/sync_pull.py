"""``sync_pull``: one anti-entropy pull round (csrc/sync_pull.cu).

Replaces corrosion_tpu/models/sync.py ``sync_step`` (:90) with its
``session_msgs`` charge (:66), the peer formula of ``rand_peers`` and
the bidirectional ``partition_ok`` (models/common.py :35, :65).  Bound
on the H100: bytes — the client row, one random peer row per draw and
the [N] counters, each moved once.  The kernel merges and counts in
registers and charges the serving peer with an integer ``atomicAdd``,
exact in any order.

With a source (``src_rows``, the all_gathered [N, R] rows) and ``lo``
the clients are one shard's window ``[lo, lo + n)`` of the N nodes, the
sync of the epidemic tick on a ``("seeds", "nodes")`` mesh
(``models/sharded.py`` ``sharded_epidemic_tick``): the offset draw is
the replicated [N, P] one, a peer's row comes from the source, and the
serving peers' charges land in an [N] delta that the caller sums over
the shards (one all_reduce) before each shard adds its own slice.
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
_WINDOW_ARGTYPES = (
    (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 2 + (ctypes.c_void_p,) * 4
    + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)
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


def sync_pull_window_plain(rows, msgs, offs, u, *, src_rows, lo,
                           partition_id=None, sev=None,
                           partition_active=False, cells_per_chunk=64,
                           handshake_msgs=2):
    """Plain PyTorch version of the kernel's window form (same arguments
    and results as :func:`sync_pull` with ``src_rows``)."""
    n = rows.shape[0]
    n_global = src_rows.shape[0]
    my = torch.arange(lo, lo + n, device=rows.device)
    peers = peers_from_offsets(offs, u)[lo:lo + n].to(torch.int64)
    reach = torch.ones(peers.shape, dtype=torch.bool, device=rows.device)
    if partition_id is not None and partition_active:
        reach = ~blocks_cross(partition_id[my][:, None], partition_id[peers],
                              sev, bidirectional=True)
    peer_rows = src_rows[peers]  # [n, P, R]
    ahead = torch.sum((peer_rows > rows[:, None, :]) & reach[:, :, None],
                      dim=2)
    merged = merge_cells(torch.where(reach[:, :, None], peer_rows,
                                     rows[:, None, :]).transpose(0, 1))
    chunks = -(-ahead // cells_per_chunk)
    half = handshake_msgs // 2
    client = (reach.sum(dim=1) * half).to(msgs.dtype)
    per_server = ((handshake_msgs - half) + chunks) * reach
    delta = torch.zeros(n_global, dtype=msgs.dtype,
                        device=rows.device).index_add_(
        0, peers.reshape(-1), per_server.reshape(-1).to(msgs.dtype))
    return merge_keys(rows, merged), msgs + client, delta


def sync_pull(rows, msgs, offs, u, *, partition_id=None, sev=None,
              partition_active=False, cells_per_chunk=64, handshake_msgs=2,
              src_rows=None, lo=0):
    """Every node pulls from its P peers ``base + (local + offs) % u``.

    rows [N, R] int32 packed keys; msgs [N] int32; offs [N, P] int32
    peer offsets in 1..u-1 (``u`` the universe width);
    partition_id [N] int32 or None; sev [B, B] bool one-way severance
    or None (symmetric).  A session needs both directions up while
    ``partition_active``.  Returns (rows, msgs) as new tensors.

    The window form: ``src_rows`` [N, R] (every node's rows) and the
    clients ``[lo, lo + n)``, their rows [n, R] and msgs [n]; offs and
    partition_id stay [N, ...].  Returns (rows, msgs, delta): my
    clients' merged rows, their msgs with the clients' halves of the
    handshake, and [N] int32 the serving peers' charges."""
    if src_rows is not None:
        return _sync_pull_window(
            rows, msgs, offs, u, src_rows=src_rows, lo=lo,
            partition_id=partition_id, sev=sev,
            partition_active=partition_active,
            cells_per_chunk=cells_per_chunk, handshake_msgs=handshake_msgs)
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


def _sync_pull_window(rows, msgs, offs, u, *, src_rows, lo, partition_id,
                      sev, partition_active, cells_per_chunk,
                      handshake_msgs):
    args = dict(src_rows=src_rows, lo=lo, partition_id=partition_id, sev=sev,
                partition_active=partition_active,
                cells_per_chunk=cells_per_chunk,
                handshake_msgs=handshake_msgs)
    if kernels.on_cpu(rows, msgs, offs, partition_id, sev, src_rows):
        return sync_pull_window_plain(rows, msgs, offs, u, **args)
    n, r = rows.shape
    n_global = src_rows.shape[0]
    p = offs.shape[1]
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"sync_pull: the kernel takes 1..{MAX_ROWS} cells "
                         f"per row, got {r}")
    if (cells_per_chunk < 1 or not 1 <= u <= n_global or n_global % u
            or not 0 <= lo <= n_global - n):
        raise ValueError("sync_pull: needs cells_per_chunk >= 1, a "
                         "universe width dividing N and the clients "
                         "inside N")
    i32 = torch.int32
    kernels.check("sync_pull rows", rows, i32, (n, r), align=16)
    kernels.check("sync_pull src_rows", src_rows, i32, (n_global, r),
                  align=16)
    kernels.check("sync_pull msgs", msgs, i32, (n,))
    kernels.check("sync_pull offs", offs, i32, (n_global, p))
    if partition_id is not None:
        kernels.check("sync_pull partition_id", partition_id, i32,
                      (n_global,))
    sev_b = 0
    if sev is not None:
        sev_b = sev.shape[0]
        sev = sev.to(torch.uint8)
        kernels.check("sync_pull sev", sev, torch.uint8, (sev_b, sev_b), 1)
    rows_out = torch.empty_like(rows)
    msgs_out = msgs.clone()
    delta = torch.zeros(n_global, dtype=i32, device=rows.device)
    pt = kernels.ptr
    fn = kernels.function("sync_pull", "sync_pull_window_launch",
                          _WINDOW_ARGTYPES)
    code = fn(pt(rows), pt(src_rows), pt(offs), pt(partition_id), sev_b,
              int(bool(partition_active)), pt(sev), pt(rows_out),
              pt(msgs_out), pt(delta), n, r, p, u, cells_per_chunk,
              handshake_msgs, lo, n_global, kernels.stream(rows))
    sync_pull.launches += 1
    kernels.raise_on_error("sync_pull", code)
    return rows_out, msgs_out, delta


sync_pull.launches = 0
