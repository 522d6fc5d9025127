#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``corrosion_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package.  Phases, each ending the run with a non-zero exit on failure:

1. print the card's name and power limit, build the twelve kernel sources
   of this checkout (one ``nvcc`` per source, in parallel) and record
   the opcode mix by pipe and loop of threefry, ``sent_select``,
   ``store_set`` and ``swim_probe_select`` (``kernels/sass.py`` over
   ``cuobjdump -sass``); print each threefry instantiation's loop (a
   mode, a group index width) with its ALU and FMA counts, a trip and a
   word (the ``threefry_pipes`` line), and ``seg_cummax``'s
   instructions, ``LDG`` and ``BAR`` counts (the ``seg_cummax_sass``
   entry of that line);
2. hold the perm-fanout kernels (the threefry draws, ``seg_argsort``,
   ``deliver_perm``, ``sync_pull``, ``tick_stats``) against their plain
   PyTorch versions on the card, bitwise, on the inputs the headline's
   tick 7 (a sync tick, partition in force) gives them, and time both
   with CUDA events; ``threefry_bits`` at the tick's five draws, four
   of them timed behind a GPU-side sleep at the headline's shapes
   (uniform [3.2M, 4], bits [32, 100000] and [12800, 250], randint
   [3.2M, 1]) and at n = 1, each beside its own bound, then in each
   mode at n in {1, 3, 4, 5, 1023, 4097}, into a fresh tensor and into
   a view 4 bytes past a 16-byte boundary, through the 32-bit and the
   64-bit group index (the words around the output untouched), randint
   at spans 1, 2**16, 2**16 + 1 and 2**32 - 1, and a uint32 draw of
   2**32 + 4099 words (17 GB, freed after) whose first 2048 words and
   those from 2**32 - 2048 on must equal ``threefry2x32`` on int64
   index tensors; ``seg_argsort`` at both column shapes, beside
   ``torch.sort`` of the uniform scores, which must give the same
   indices; ``tick_stats`` in both of its designs also on byte rows at
   the exact column's shapes (16 x 100k, 4 x 1M, 2 x 10M), at n a
   multiple of no tile, S = 1, series spanning 4095 values (accepted)
   and 4096 (+inf in that universe alone) and a universe without a
   measured depth, its scratch all zero after every call;
3. run the headline — 100k nodes x 32 seeds, R = 8, 5% loss, two
   partition blocks healing at tick 12 — on the card, require its
   numbers (converged 1.0, ticks 15, msgs/node 16.03, p99 34.97), and
   require every kernel's launch counter (zeroed just before) to have
   risen;
4. run the same config at 4096 nodes x 4 seeds on the card (kernels)
   and on the CPU (plain versions) and require per-tick rows / tx /
   msgs / hops / next_send and the stats dicts to be equal; the same
   for five 1024-node variants that take the kernels' other paths;
5. hold ``exact_send`` (bitmap and ring) and ``exact_commit`` against
   their plain versions (max |diff| 0 on every output leaf and the
   rejection counters) at ticks 1 and 6 of the exact column's
   full-width configs at their own seed counts (16 x 100k, 4 x 1M; the
   dense run also at tick 8, the sparse at its busiest) and of a
   WAN-latency variant of each, the bitmap also at N = 64, K = 4 with
   an empty bitmap and with one that makes rows redraw past the
   block's round keys, and time them at those ticks; then
   ``exact_commit`` alone, bitwise its plain version, at every shape
   the main paths launch it at (``COMMIT_SHAPES``: dense [16, 100k],
   sparse and frontier [4, 1M], the host layout's [2, 5M] window at
   5M of a [2, 10M] pair, read in place, the sharded-dense shard's
   [4, 12,500] and one at column 3 of a [4, 100k] pair), with few and
   many learners, a tier given and not, learners at the window's
   first and last byte, sentinel words around tx / next_send, and
   new_infected 2 bytes off infected's alignment; timed behind a GPU
   sleep with the L2 flushed before each call, each with its bound
   from its learners' sectors (the ``{"exact_commit": ...}`` line);
6. run the exact column at full width through ``run_exact_headline``:
   dense 100k nodes x 16 seeds (a 20 GB bitmap, partitioned) and
   sparse 1M nodes x 4 seeds, each with the launch counters zeroed just
   before; require convergence and that ``exact_send``, ``exact_commit``,
   ``sync_pull``, ``tick_stats`` and ``threefry_bits`` all ran; then
   run the 100k config through the sparse kernel and require per-seed
   statistics identical to the dense run's;
7. run both exact kernels at 1024 nodes x 2 seeds on the card and on
   the CPU, on tests/test_frontier.py's headline shape and four
   scenario families, and require every leaf (bitmap or ring included),
   the per-tick statistics and the run's stats dict to be equal;
8. hold ``seq_sync`` and ``seq_stats`` against their plain versions at
   config #4's full width (10k nodes x 32 seeds, 64 seqs) at ticks 1
   and 20, and the SWIM kernels (``swim_tick``: probe/select,
   disseminate, settle) at N = 64, 1000, 1003 and 4096 at a tick during
   suspicion, that tick with whole rows at the retransmission limit,
   the revive tick, the revive tick with the victim probed by the node
   it announces to, a 15%-loss tick, a tick without gossip targets and
   a crafted-tie state at 8, 12 and 20 gossip entries (one, two and
   three selection passes), at N = 5 with 9 gossip entries, a crafted
   ordering state (the passes' order shows) at N = 16 and 4096 with
   and without loss, gossip targets and a second selection pass, and
   at N = 16384 with 20 entries (more than the card's threads at
   once), every leaf bitwise and ``swim_disseminate`` bitwise
   ``swim_disseminate_plain`` on the kernels' own selection; time each
   host call's kernels with CUDA events and ``swim_probe_select`` alone
   at N = 64 and 4096, and there the host's enqueue of a tick (the
   device asleep), the dissemination between two events, a whole tick
   and the dissemination as five PyTorch calls (three
   ``scatter_reduce_``, two ``torch.gather``), which must leave the
   kernels' view;
9. run config #4 (``run_anti_entropy_seeds``, 10k x 32 seeds), config
   #2 (``run_churn``, 64 nodes) and the 4096-node churn cycle on the
   card, each with the launch counters zeroed just before, and hold
   them to the reference's numbers (converged 1.0, ticks 32/37,
   msgs/node 73.2255; detect 15, rejoin 4, 4.982421875 msgs/node/tick;
   detect and rejoin None, 4.99986 msgs/node/tick);
10. run anti-entropy at 1000 nodes x 4 seeds (default, and 3 peers with
    a budget of 2) and SWIM at 256 nodes over two 128-tick churn cycles
    (lossless and 15% loss), at 48 nodes with 12 gossip entries and 5
    targets and at 64 nodes with 20 entries (15% loss) on the card and
    on the CPU, and require every leaf per tick and the stats to be
    equal;
11. hold ``sent_select`` and ``sent_commit`` (the exact ``sent_to``
    sampler), and the two from one ``sent_tick`` call (the commit under
    programmatic dependent launch), against their plain versions, every
    output leaf bitwise (``sent`` included), for every fanout k of 1..8,
    each in the row
    layout ``sent_select`` takes at its N (a block a row at 16,000 and
    beyond, a warp a row at 512): calibration mode at
    ``ExactConfig(16000)`` seed 0 at tick 1 and at its busiest tick,
    which must hold active rows with tied scores in their k + 1
    smallest, and that tick with crafted rows left fewer than k peers
    the filter can find (the exact fallback); broadcast mode at 512
    nodes x 8 seeds on ``sim_trace``'s config (with int32 keys and with
    int64 keys) and on two variants (10% loss, a one-way partition in
    force, hops; WAN drop or RTT tiers); calibration rows whose
    counters cross 2**32 (N = 65,537 and 65,600, chunk = N, a few
    active rows) against the plain selection of each row alone; time
    both kernels behind a GPU-side sleep, and the pair from one
    ``sent_tick`` call, and the host's enqueue of a calibration tick
    (``exact_inputs`` and ``sent_tick``, and the two wrappers; the
    device asleep; the ``{"sent_tick": ...}`` line);
12. run ``run_msgs_calibration(ns=(1000, 4000, 16000), seeds=3)``,
    ``sim/simdiff.py``'s ``sim_trace`` at 64, 256 and 512 nodes x 8
    seeds and ``sim/obs.py``'s ``sim_obs_trace`` (sync every 8 ticks)
    at 512 x 8 on the card, each with the launch counters zeroed just
    before, and hold them to ``CALIB_MSGS.json``'s points,
    ``SIMDIFF_N*.json``'s sim numbers and the reference's numbers
    (hard-coded here), the runner's statistics under each twin (kept
    by ``through``) and the twin's fields equal to them;
13. run ``exact_tick`` at 2000 nodes (a short last sender chunk,
    backoff 1.5) and the ``track_sent`` runner at 256 nodes x 4 seeds
    (phase 11's variants and ``sim_obs_trace``'s) on the card and on
    the CPU, and require every leaf per tick and the results to be
    equal;
14. hold ``seg_argsort`` against its plain version, bitwise, on 23-bit
    threefry keys at [32, 100000], [12800, 250], [128000, 250] and
    [32, 1000000], on all-equal and two-valued keys at [32, 100000], on
    int64 keys of 2**20 with many ties and on the regimes' edges; and
    require a headline tick (``torch.profiler``) to sort with the
    port's ``seg_sort_*`` kernels and none of PyTorch's;
15. run ``select_winners(backend="torch", device="cuda")`` on 2**20
    changes (262,144 rows x 4 cells, ``profile_tick.resync_batch``
    through ``encode_changes``), cold and warm, pk-grouped and
    interleaved, each with the launch counters zeroed just before, and
    require every ``MergeDecision`` field and ``impacted`` bitwise equal
    to the NumPy twin's and the plain torch core's on the card; then
    hold ``seg_cummax``, ``winners_a`` and ``winners_b`` (and the int64
    sort) against their plain versions on the four batches'
    intermediates and on edge batches (n = 1, 31, 32, 33 and 4097, one
    row of 5,000 changes, rows of one change, a cell's accepts across
    warps, sentinels only, one and 64 columns; cold and warm, whose
    whole call must equal the NumPy twin's), ``seg_cummax`` in both
    domains, exclusive and inclusive; then ``seg_cummax`` alone on
    inputs through a random permutation (one segment of 2**22 positions,
    more tiles than the card holds at once, random, rising and falling
    values; segments starting at every tile's first position; n = 1,
    2, 1023, 1024, 1025, 2047, 2048, 2049 and 4097; segments of one
    position; masks all false and all true; values at ``NEG_KEY`` and
    2**62 - 1; three calls at falling n without a synchronisation
    between them; a CUDA graph of two calls replayed three times),
    bitwise its plain version; time them with CUDA events, the winner
    passes and ``seg_cummax`` (both domains, interleaved and
    pk-grouped) behind a GPU sleep (the ``{"winners_kernels": ...}``
    and ``{"seg_cummax": ...}`` lines, the latter with each domain's
    bound from its inputs and domain B's interleaved time between two
    events without the sleep);
16. hold ``store_set`` and ``store_gather`` (the device clock cache's
    store) against their plain versions and NumPy on the card, bitwise,
    at n in {0, 1, 2500, 10000, 65536, 262144} into arrays of 1024,
    65536 and 524288 entries, unique and repeated indices (the last
    pair wins), one index repeated, and n over three times the threads
    the card holds at once into 2**20; the owner buffer all -1 after
    every call; require an out-of-range index to raise; time both
    beside ``index_select`` / ``index_put_`` at the apply path's widest
    calls and a steady wave's; then drive the device-resident apply
    through the port's
    ``CrConn`` with
    ``enable_device_cache()`` (the torch store, which must be on the
    card): APPLY_BENCH ``device_arm``'s steady and flood scenarios
    (bench.py:538; 12 waves of 10,000 changes) in four arms
    (per-change, batched, NumPy store, torch store) that must leave one
    state, and the capacity run (a 262,144-change prefill that fills
    the cache, 12 steady waves and one over all 65,536 rows, 12 flood
    waves with a local write, and a batch of more rows than the cache
    holds), the torch store's counters, metrics and arrays equal to the
    NumPy store's after each segment and its state after the steady and
    the last, with the launch counters zeroed just before it.  The arms
    held against the torch store's run in two spawned worker processes
    beside it;
17. hold the validity wire, ``bits_pack``, ``bits_pack_above``,
    ``bits_pack_active``, ``bits_unpack`` and ``bits_unpack_add`` (at
    the host layout's shapes, [2, 5,000,000] packed, the active window
    at 5,000,000 of the replicated [2, 10,000,000], [2, 1,250,000]
    unpacked, and odd shapes, inputs and outputs off their alignment,
    sentinels around the outputs, the unpacks' counts, also under CUDA
    graph replay; ``bits_pack`` packs no mask of a main path and stays
    off the kernels line),
    ``route_pack`` (``ROUTE_CASES``: the fabrics' maps at caps 1, 256
    and n_local for shards 0, 3 and 7, no sender and every sender
    active, D = 1, 2, 8 and 64, K = 1, 99,976 nodes over 8 shards (no
    multiple of the kernel's tile), R = 4, 6 and 8 with rows_l or the
    outputs off a 16-byte boundary and sentinel words around the
    outputs; its marks all zero after every call), ``ring_receive`` (the
    same layouts, each shard and cap receiving every source's
    ``route_pack`` buffers, on one slot map; four broken orders it
    must flag), the all_gather fabric's ``deliver_perm`` with its
    identity slot map and a receiver window (100k nodes x R = 8 over 8
    shards) and ``shard_round`` /
    ``shard_commit`` (ticks 1 and 6 of phase 18's three runs and of a
    WAN-latency variant of the dense and host layouts: every shard's
    rounds, shard 0's and a later shard's commit) against their plain
    versions, bitwise, and time them behind a GPU-side sleep at tick 6
    of the host, frontier and dense layouts, also with the active rows
    gathered into contiguous blocks (``narrowed_rows``);
18. run ``run_exact_headline`` over a ``LocalFabric`` on the card, the
    launch counters zeroed just before each run: ``host-sparse`` on the
    10M-node headline config x 2 seeds on 2 hosts, held to
    ``BENCH_FRONTIER.json``'s ticks and p99 (13/13, 33.0) and to the
    reference's statistics over the run's per-node msgs (19.15 msgs/node;
    the record's 19.12 is not reproduced, see ``HOST_SEED_MEANS``; those
    msgs are written to ``HOST_MSGS`` for the reference's script),
    with a fabric that moved only packed validity bits and the
    statistics' gather; ``sharded-sparse`` (1M x 4) and
    ``sharded-dense`` (100k x 4)
    over 8 node shards, held per seed to phase 6's runs; then the
    all_gather and ring broadcast fabrics at 100k nodes x R = 8 over 8
    shards for 12 ticks and the seq-sync fabric at config #4's width
    for 20, each bitwise its single-device step;
19. run the three layouts at 2048 nodes (8 node shards, 2 hosts, and 8
    hosts at 256 nodes) x 2 seeds, with a WAN-latency variant, the
    broadcast fabrics at 256 nodes and the seq-sync fabric at 10k nodes x
    64 seqs over 8 shards on the card and on the CPU, and require every
    leaf per tick equal between them (and the layouts to the
    single-device tick);
20. run the host layout at 4096 nodes x 2 seeds on 2 hosts over a
    ``DistFabric`` of two gloo ranks (spawned processes, CUDA tensors on
    the one card) and require every shard after every tick equal to the
    ``LocalFabric``'s on the card, and the ranks' bytes to sum to its;
21. run the harness twins' predictions through their entry points on
    the card, each with the launch counters zeroed just before it:
    ``sim_obs_trace(32)``, ``sim_chaos_trace(32)`` and ``(512,
    oneway_blocks=((0, 1),))``, ``sim_prediction`` for the five fault
    families at 32 and 512 nodes (heal after 0.64 s),
    ``kernel_coverage_prediction`` at 32 and 512 nodes (heal at tick
    64), ``model_churn_trace`` at 64 and 256 nodes over 3 cycles, and
    ``resolve_wave`` on the subscription bench's headline burst (20
    waves, ``backend="torch"``) and on one wave of 131,072 changes
    (``backend="auto"``); hold each to the reference's result for the
    same call on the CPU (``HARNESS_WANT``; the churn runs to
    ``CHURNDIFF_N64`` / ``N256.json``, which agree with it; the waves
    also to the NumPy twin, exactly), tick and integer fields equal,
    floats to rel_tol 1e-6, coverage lists within 1e-4, and require
    every kernel of each call's path to have launched (the
    ``{"harness": ...}`` line: each call's wall and launches);
22. the twin of the reference's multi-chip dry run, through
    ``corrosion_tpu_torch.entry``: (a) ``dryrun_multichip(8)`` as 8
    shards of a ``LocalFabric`` on the card, a ``("seeds", "nodes")``
    mesh of 2 x 4, with every assert of the reference's inline path
    (its two lines, then the ``{"dryrun_multichip": ...}`` line with its
    launches and fabric bytes); (b) the headline's config per seed
    (100k nodes, R = 8) for 4 seeds under ``split(PRNGKey(7), 4)`` over
    that mesh for 16 ticks (the partition, its heal at 12, two sync
    ticks), every leaf of every seed bitwise the single-device
    ``epidemic_tick`` after every tick; (c) SWIM at N = 4096 (the churn
    run's parameters, loss 0.05) over 4 node shards for 32 ticks of the
    churn schedule (suspicion, DOWN, refutations and the rejoin
    required), every leaf and the churn flags bitwise the single-device
    ``swim_step`` after every tick (the ``{"multichip_epidemic": ...}``
    and ``{"multichip_swim": ...}`` lines: each tick's wall beside the
    single-device tick's, the fabric's bytes and calls by kind, the
    launches of the sharded ticks alone); (d) each window kernel
    (``deliver_perm``'s and ``sync_pull``'s at (b)'s shape, the SWIM
    tick's phases at (c)'s) against its plain version, timed, with its
    bound (the ``{"window_kernels": ...}`` line);
23. the port's live agent (``agent/runtime.py``) on the card: first
    the port's native host module (``native/_corrosion_native.cc``)
    must have built from this checkout and loaded, and the agent's
    value codec (``agent/pack.py``) and speedy's change loops and
    deframer must be its functions, equal to their Python twins on a
    sample (the ``phase 23 native`` line); then (a)
    ``run_bitmatch`` at 256 and 64 nodes with ``BITMATCH_N256.json``'s
    and ``BITMATCH_N64.json``'s own arguments (loss 0.05, ring0-first
    fanout, anti-entropy every 8 ticks), real agents run for the card
    under the deterministic scheduler, held to the record field for
    field: a check of the protocol, since the bit-match's versions are
    one change each, which the storage applies change by change (its
    wall, store launches and device memory printed: no kernel launches
    and no cache array is made), and a two-node ``DetCluster`` whose
    agents' caches must be torch stores on the card; (b) four agents
    from ``launch_test_agent(device="cuda")`` on loopback at the
    reference's default surfaces (the HTTP API, subscriptions, SWIM over
    foca datagrams, broadcast and sync over the multiplexed transport),
    B and two catch-up nodes booted from A, the three holding an older
    version of a fourth actor over one row in sixteen (col_version 2, or
    1 with a value above or below A's); each catch-up node opens a
    subscription ``SELECT id, text FROM tests`` over its HTTP API before
    A writes one transaction of 70,000 rows of ``tests`` (its version's
    changes counted with ``collect_changes``, more than
    ``TORCH_AUTO_MIN``); B (whose sync client waits a minute) takes it by
    broadcast in chunks of ``MAX_CHANGES_BYTE_SIZE`` and applies the
    reassembled version at once, A and B drop their broadcasts to the
    catch-up nodes, which then catch up by sync in two arms, one from A
    and one from B alone (``Agent._choose_sync_peers`` wrapped; B serves
    only the changes that won there, which must still be more than
    ``TORCH_AUTO_MIN``; each arm's received changes and its servers'
    served needs counted), A is handed the older version, then B updates
    4096 of the rows twice; all four must end with equal rows and clock
    state, the rows those the merge rules give (the older version's
    where it wins), each subscription's stream (resumed from the change
    log at a gap) holding those rows, SWIM datagrams all foca, broadcast
    frames and sync channels on the mux, every cache on the card with
    hits on A and both catch-up nodes, the three large applies through
    ``seg_argsort``, ``seg_cummax``, ``winners_a`` and ``winners_b``,
    ``store_set`` and ``store_gather`` launched in the receivers'
    applies, and every winner decision and store call the agents made
    there (recorded as they ran) bitwise its plain version's on the same
    inputs, the decisions also the NumPy twin's (the ``{"agent": ...}``
    line: the walls, each receiver's large apply's host-clock wall, the
    arms, the subscriptions, the wire counts, the launches, the sizes
    checked); (c) three agents on the card with every further surface of
    the reference on: each an admin socket and a signing key, one shared
    directory of their public keys, A the PostgreSQL wire, B and C
    holding the older version; A writes (b)'s 70,000 rows in one
    transaction over the PG wire (one recursive CTE INSERT; its version
    must equal (b)'s change for change), B takes it by broadcast, C by
    sync from A alone, A takes the older version and B updates 4096 rows
    twice; B's and C's applies must go through the four winner kernels,
    every decision bitwise its plain version's; A's PG session must read
    back the rows the merge rules give, equal on all three nodes; every
    node's admin socket must answer ``health``, ``cluster_members`` (3
    alive), ``actor_version`` of A's actor (equal on all three),
    ``sync_sessions`` and ``db_info``; a small signed write from A must
    be verified on B and C (``corro_sig_verifications_total`` ok, no
    failure) (the ``phase 23c`` line: the PG write, B's reassembly, C's
    sync, the PG read, each apply's wall, the launches).  Every wait is
    bounded.

``python3 chip_smoke.py --parent DIR`` (DIR an unpacked ``git
archive`` of the parent commit) also builds the parent's ``swim.cu``,
``exact_send.cu``, ``threefry.cu``, ``sent_sampler.cu``, ``fabric.cu``,
``deliver_perm.cu`` and ``winners.cu`` and requires their kernels to
write what this tree's write: ``threefry_bits`` in every case of phase
2, the 2**32 window included, the headline's ``deliver_perm`` (phase
2), ``sent_select`` and ``sent_commit`` in every case of phase 11 but
the counter splits (their two calls against ``sent_tick``),
``swim_probe_select`` at N = 64 and 4096 (phase 8; there
the parent's dissemination is timed in turns with this tree's, and
the whole tick with each),
``exact_send<Bitmap>`` at phase 5's timed ticks, ``exact_commit`` in
every case of phase 5 (on the windows in place; timed in turns at
dense tick 6 and every ``COMMIT_SHAPES`` case), ``bits_pack`` and
``bits_unpack`` at the host layout's shapes (phase 17a), ``route_pack`` in
every case of phase 17a, its ``ring_receive`` in every case and
its delivery from the all_gather
fabric's source, ``shard_round`` and ``shard_commit`` in phase
17b's timed cases (both commits from restored copies), ``winners_a``
and ``winners_b`` on every phase-15 batch; each pair is
timed in turns (parent, change, change, parent): the headline's
``deliver_perm`` (the ``{"deliver_perm": ...}`` line), ``route_pack``
and ``ring_receive`` at shard 3 of 8 at caps 12,500 and 256 and the
all_gather delivery (the ``{"route_pack": ...}``, ``{"ring_receive":
...}`` and ``{"deliver_perm (source, window)": ...}`` lines), the
sampler's pair and its commit alone behind a GPU sleep at 16k tick 9
and 8 x 512 tick 4 (the ``{"sent_tick": ...}`` line), the
winner passes behind a GPU sleep at 2**20, interleaved and pk-grouped
(the ``{"winners_kernels": ...}`` line), and ``seg_cummax`` (the parent's
launch, on tile words of its own) in every phase-15 case and timed the
same way in both domains (the ``{"seg_cummax": ...}`` line).  Phase 1
then also prints whether each ``sent_select`` function's opcode counts
equal the parent's, and each ``sent_select`` loop's, and the parent's
``seg_cummax`` counts beside this tree's.

Prints the card line, the ``kernels`` JSON line and, last, the
``{"ok": true, "device": ...}`` line; writes the full record (with
the compiler's register report) to
``corrosion_tpu_torch/kernels/build/chip_smoke.json``.
"""

from __future__ import annotations

import ctypes
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# integer operations: an SM's 4 schedulers dispatch one warp instruction
# a clock each, 128 lanes x 132 SMs x 1.98 GHz, shared by its two
# integer pipes (ALU: IADD3, LOP3, SHF, ISETP; FMA: IMAD, IMAD.WIDE),
# 64 lanes each (the float32 67 TFLOP/s rate is 128 lanes x 2 flops x
# the same clock)
INT_OPS_PER_S = 128 * 132 * 1.98e9
# the integer operations of one threefry2x32 hash that no schedule
# avoids: 20 rounds of an add, a rotate (a funnel shift on the ALU, or a
# 32 x 32 -> 64 multiply on the FMA pipe whose halves the next LOP3
# folds) and an xor; x1's 4 key injections (x0's fold into the next
# round's three-input add); the output's two adds and xor; the
# counter's add.  The adds can run as IMAD beside the ALU's work
# (threefry_bits and sent_select's filter put all of theirs there,
# common.cuh hash_run; kernels/sass.py shows a built kernel's split), so
# the two pipes share the 68.
INT_OPS_PER_HASH = 60 + 4 + 3 + 1
# and a uniform float: the epilogue's shift-or (one LEA.HI) and subtract
INT_OPS_PER_UNIFORM = INT_OPS_PER_HASH + 2
# and a randint: two hashes, three remainders by a span known only at
# run time (four multiplies each, threefry.cu fastmod), the
# multiply-add that folds them and minval's add
INT_OPS_PER_RANDINT = 2 * INT_OPS_PER_HASH + 3 * 4 + 2

def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the card (CUDA events, warm)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_device_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls enqueued
    behind a GPU-side sleep (CUDA events, warm): the host's enqueue of
    a call, longer than a small kernel, stays out of the time."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES * (1 + reps // 4))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def max_abs_err(a, b) -> float:
    """Largest |a - b| over paired tensors (NaN where both are NaN
    counts as equal); 0.0 means bitwise-equal integers.  Unequal
    tensors are compared in float64 slices, so a 20 GB bitmap needs no
    160 GB copy."""
    worst = 0.0
    step = 1 << 26
    for x, y in zip(a, b):
        if x is None and y is None or torch.equal(x, y):
            continue
        x, y = x.reshape(-1), y.reshape(-1)
        for i in range(0, x.numel(), step):
            xs, ys = x[i:i + step].double(), y[i:i + step].double()
            both_nan = torch.isnan(xs) & torch.isnan(ys)
            d = torch.where(both_nan, torch.zeros_like(xs), (xs - ys).abs())
            worst = max(worst,
                        float(torch.nan_to_num(d, nan=math.inf).max()))
    return worst


def mismatches(a, b) -> int:
    """Entries that differ over paired integer tensors (0: bitwise
    equal; exact where float64 would round int64 keys near 2**62)."""
    return sum(int((x != y).sum()) for x, y in zip(a, b))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def flat_indices(local: torch.Tensor) -> torch.Tensor:
    """[S, L] per-row indices as ``seg_argsort``'s flat int32 ones."""
    s, length = local.shape
    row0 = torch.arange(s, dtype=torch.int64, device=local.device) * length
    return (local.to(torch.int64) + row0[:, None]).to(torch.int32)


def in_turns(change, parent, timer) -> dict:
    """``change``'s time (``timer(fn)`` ms) and, when ``parent`` is
    given, the parent design's, in turns: parent, change, change,
    parent; ``ms`` is the mean of the change's two."""
    if not parent:
        return {"ms": timer(change)}
    p0 = timer(parent)
    c0, c1 = timer(change), timer(change)
    return {"ms": (c0 + c1) / 2, "ms_runs": [c0, c1],
            "parent_ms": [p0, timer(parent)]}


def build_library(src: str, lib: str) -> list:
    """``nvcc`` of one source into ``lib`` with the port's flags;
    returns the register lines of the compiler's report."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    from corrosion_tpu_torch import kernels

    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                          "-I", os.path.dirname(src), "-I", str(kernels.CSRC),
                          "-o", lib, src],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        fail(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    return [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "registers" in ln or "Compiling entry" in ln]


class ParentDesign:
    """The parent commit's ``swim.cu``, ``exact_send.cu``, ``threefry.cu``,
    ``sent_sampler.cu``, ``fabric.cu``, ``deliver_perm.cu`` and
    ``winners.cu``, built
    from a checkout of it (``--parent DIR``, one ``nvcc`` each, all at
    once) and launched as its wrappers launched them, for timing beside
    this tree's kernels in one run.
    The C interfaces of ``swim_launch``, ``exact_send_launch``,
    ``shard_launch``, ``route_pack_launch``, ``deliver_perm_launch``,
    ``ring_receive_launch``, ``sent_select_launch``,
    ``sent_commit_launch``, ``winners_a_launch``, ``winners_b_launch``,
    ``seg_cummax_launch``, ``threefry_launch`` and
    ``exact_commit_launch`` are unchanged since, so this tree's wrappers
    fill their arguments (``kernels.swim.prepare``,
    ``exact_send.send_args``, ``sent_sampler._select_fields`` /
    ``_commit_fields``, ``shard_exact.round_args`` / ``commit_args``,
    ``threefry._ARGTYPES``, ``deliver.launch``,
    ``fabric._RECEIVE_ARGTYPES`` on this tree's slot map,
    ``winners._A_ARGTYPES`` / ``_B_ARGTYPES`` / ``_CUMMAX_ARGTYPES``,
    the last on tile words of the parent's own,
    ``exact_send._COMMIT_ARGTYPES``; ``route_pack``'s scratch argument
    is a zeroed buffer of the parent's own).  The parent's
    ``bits_pack_launch`` / ``bits_unpack_launch`` (a thread a wire byte)
    take ``fabric._PACK_ARGTYPES``."""

    SOURCES = ("swim", "exact_send", "threefry", "sent_sampler", "fabric",
               "deliver_perm", "winners")

    def __init__(self, root: str):
        from corrosion_tpu_torch import kernels
        from corrosion_tpu_torch.kernels import shard_exact as sx

        csrc = os.path.join(root, "corrosion_tpu_torch", "kernels", "csrc")
        out = str(kernels.BUILD_DIR / "parent")
        libs = {name: os.path.join(out, f"lib{name}.so")
                for name in self.SOURCES}
        with ThreadPoolExecutor(len(libs)) as pool:
            logs = pool.map(lambda name: build_library(
                os.path.join(csrc, f"{name}.cu"), libs[name]), libs)
            self.ptxas = dict(zip(libs, logs))
        self.paths = libs
        self.libs = {name: ctypes.CDLL(lib) for name, lib in libs.items()}
        size = self.libs["exact_send"].shard_args_size()
        if size != ctypes.sizeof(sx._ShardArgs):
            fail(f"the parent's ShardArgs is {size} bytes, this tree's "
                 f"{ctypes.sizeof(sx._ShardArgs)}")

    def _fn(self, lib: str, symbol: str, argtypes):
        fn = getattr(self.libs[lib], symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        return fn

    def _launch(self, lib: str, symbol: str, argtypes, *args) -> None:
        from corrosion_tpu_torch import kernels

        kernels.raise_on_error(f"parent {symbol}",
                               self._fn(lib, symbol, argtypes)(*args))

    def deliver_perm(self, rows, tx, msgs, senders, **args):
        """The parent's ``deliver_perm`` (``deliver_perm``'s arguments on
        CUDA tensors, every keyword given)."""
        from corrosion_tpu_torch.kernels import deliver

        return deliver.launch(self._fn("deliver_perm", "deliver_perm_launch",
                                       deliver._ARGTYPES),
                              rows, tx, msgs, senders, **args)

    def ring_receive(self, rows, tx, msgs, senders, recv_ids, recv_rows,
                     loss_u, loss, max_tx, lo):
        """The parent's ``ring_receive`` (``ring_receive``'s arguments,
        positional) on this tree's slot map and its next generation;
        returns (rows, tx, msgs)."""
        from corrosion_tpu_torch import kernels
        from corrosion_tpu_torch.kernels import fabric

        (n, r), (k, n_global), (d, cap) = (rows.shape, senders.shape,
                                           recv_ids.shape)
        tags, gen = fabric._slot_map(rows.device, n_global)
        out = torch.empty(n * r + 2 * n + 1, dtype=torch.int32,
                          device=rows.device)
        rows_out = out[:n * r].view(n, r)
        tx_out, msgs_out, bad = out[n * r:].split((n, n, 1))
        p = kernels.ptr
        self._launch("deliver_perm", "ring_receive_launch",
                     fabric._RECEIVE_ARGTYPES, p(rows), p(tx), p(msgs),
                     p(senders), p(loss_u), p(recv_ids), p(recv_rows),
                     p(tags), p(rows_out), p(tx_out), p(msgs_out), p(bad),
                     n, r, k, float(loss), int(max_tx), lo, n_global, d,
                     cap, gen, kernels.stream(rows))
        return rows_out, tx_out, msgs_out

    def route_pack(self, senders, active_l, rows_l, shard: int, cap: int):
        """The parent's ``route_pack`` (``route_pack``'s arguments) on the
        zeroed byte marks and overflow its wrapper made."""
        from corrosion_tpu_torch import kernels
        from corrosion_tpu_torch.kernels import fabric

        k, n = senders.shape
        n_local, r = rows_l.shape
        d, dev, i32 = n // n_local, rows_l.device, torch.int32
        needed = torch.zeros((d, n_local), dtype=torch.uint8, device=dev)
        out = (torch.empty((d, cap), dtype=i32, device=dev),
               torch.empty((d, cap, r), dtype=i32, device=dev),
               torch.zeros((1,), dtype=i32, device=dev))
        p = kernels.ptr
        self._launch("fabric", "route_pack_launch", fabric._ROUTE_ARGTYPES,
                     p(senders), p(active_l), p(rows_l), p(needed),
                     *map(p, out), k, n, shard * n_local, n_local, d, cap, r,
                     kernels.stream(rows_l))
        return out

    def threefry_bits(self, out, key, key2=None, span=0, mult=0,
                      minval=0):
        """The parent's ``threefry_bits`` into the CUDA tensor ``out``
        (the epilogue follows its dtype); returns ``out``."""
        from corrosion_tpu_torch import kernels
        from corrosion_tpu_torch.kernels import threefry as tf

        kb = key2 if key2 is not None else (0, 0)
        mode = tf._MODES[out.dtype]
        self._launch("threefry", "threefry_launch", tf._ARGTYPES,
                     kernels.ptr(out), out.numel(), key[0], key[1], kb[0],
                     kb[1], mode, span, mult, minval,
                     tf.fastmod_m(span) if mode == 2 else 0, 0,
                     kernels.stream(out))
        return out

    def _swim(self, launch, phase: int) -> None:
        """The parent's ``swim_launch`` of ``phase`` on a tick's
        ``Launch``."""
        from corrosion_tpu_torch.kernels import swim as ksw

        self._launch("swim", "swim_launch", ksw._ARGTYPES, *launch.args,
                     phase, launch.stream)

    def swim_probe_select(self, launch) -> None:
        """The parent's ``swim_probe_select`` on a tick's ``Launch``."""
        from corrosion_tpu_torch.kernels import swim as ksw

        self._swim(launch, ksw.SELECT)

    def swim_disseminate(self, launch, gossip: bool) -> None:
        """The parent's dissemination on a tick's ``Launch`` (one host
        call, two kernels)."""
        from corrosion_tpu_torch.kernels import swim as ksw

        self._swim(launch, ksw.DISSEMINATE if gossip
                   else ksw.DISSEMINATE_NO_GOSSIP)

    def exact_send(self, infected, tx, next_send, msgs, pending, sent, keys,
                   tick, p, tier, diag):
        """The parent's ``exact_send<Bitmap>`` (``exact_send``'s
        arguments, a bitmap ``sent``); returns new_infected."""
        from corrosion_tpu_torch import kernels
        from corrosion_tpu_torch.kernels import exact_send as es

        if sent.dtype != torch.uint8:
            fail("the parent's exact_send is launched on a bitmap only")
        new_infected = infected.clone()
        a = es.send_args(infected, new_infected, tx, next_send, msgs,
                         pending, sent, keys, tick, p, tier, diag)
        self._launch("exact_send", "exact_send_launch",
                     (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p),
                     ctypes.addressof(a), 0, None, None,
                     kernels.stream(infected))
        return new_infected

    def exact_commit(self, infected, new_infected, tx, next_send, tick,
                     max_tx, tier=None) -> None:
        """The parent's ``exact_commit`` (``exact_commit``'s arguments,
        the masks' windows read in place)."""
        from corrosion_tpu_torch import kernels
        from corrosion_tpu_torch.kernels import exact_send as es

        p = kernels.ptr
        s, n = infected.shape
        lds = [kernels.row_stride("parent exact_commit", t, s, n)
               for t in (infected, new_infected)]
        self._launch("exact_send", "exact_commit_launch",
                     es._COMMIT_ARGTYPES, p(infected), p(new_infected),
                     *lds, p(tx), p(next_send), p(tier), s, n, tick, max_tx,
                     kernels.stream(infected))

    def bits_pack(self, mask):
        """The parent's ``bits_pack`` (a thread a wire byte, one 8-byte
        load)."""
        from corrosion_tpu_torch import kernels
        from corrosion_tpu_torch.kernels import fabric

        wire = torch.empty((*mask.shape[:-1], mask.shape[-1] // 8),
                           dtype=torch.uint8, device=mask.device)
        self._launch("fabric", "bits_pack_launch", fabric._PACK_ARGTYPES,
                     kernels.ptr(mask), kernels.ptr(wire), wire.numel(),
                     kernels.stream(mask))
        return wire

    def bits_unpack(self, wire, m: int):
        """The parent's ``bits_unpack`` (a thread a wire byte, one 8-byte
        store)."""
        from corrosion_tpu_torch import kernels
        from corrosion_tpu_torch.kernels import fabric

        mask = torch.empty((*wire.shape[:-1], m), dtype=torch.bool,
                           device=wire.device)
        self._launch("fabric", "bits_unpack_launch", fabric._PACK_ARGTYPES,
                     kernels.ptr(wire), kernels.ptr(mask), wire.numel(),
                     kernels.stream(wire))
        return mask

    def _shard(self, sa, sent_l, commit: bool, t) -> None:
        from corrosion_tpu_torch import kernels

        self._launch("exact_send", "shard_launch",
                     (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p),
                     ctypes.addressof(sa), int(sent_l.dtype == torch.int32),
                     int(commit), kernels.stream(t))

    def shard_round(self, active_l, sent_l, keys, lo, n, p, diag, tick=0):
        """The parent's ``shard_round`` (``shard_round``'s arguments)."""
        from corrosion_tpu_torch.kernels import shard_exact as sx

        sa, rounds = sx.round_args(active_l, sent_l, keys, lo, n, p, diag,
                                   tick)
        self._shard(sa, sent_l, False, active_l)
        return rounds

    def shard_commit(self, active, rounds, infected_t, pending_t, tx_b,
                     next_send_b, msgs_b, sent_l, keys, lo, tick, p, tier):
        """The parent's ``shard_commit`` (``shard_commit``'s arguments)."""
        from corrosion_tpu_torch.kernels import shard_exact as sx

        sa, new_infected = sx.commit_args(
            active, rounds, infected_t, pending_t, tx_b, next_send_b,
            msgs_b, sent_l, keys, lo, tick, p, tier)
        self._shard(sa, sent_l, True, active)
        return new_infected


    def sent_block(self, select, commit):
        """One argument block for the parent's ``sent_select_launch`` and
        ``sent_commit_launch`` on a tick's inputs (``{**select,
        **commit}`` as ``sent_tick`` takes them), with the outputs its
        wrappers allocated (counts zero-filled): (block, outputs in
        ``sent_tick``'s order)."""
        from corrosion_tpu_torch.kernels import sent_sampler as ss

        outs, fields = ss._select_fields("parent sent_select", **select)
        tx, msgs, ns, hops = (commit["tx"], commit["msgs"],
                              commit.get("next_send"), commit.get("hops"))
        counts = torch.zeros_like(tx)
        c_outs = (torch.empty_like(tx), torch.empty_like(msgs),
                  None if ns is None else torch.empty_like(ns),
                  None if hops is None else torch.empty_like(hops))
        a = ss._args(counts=counts, **fields, **ss._commit_fields(
            msgs, commit.get("tier"), commit["max_tx"],
            commit.get("backoff", 0.0), c_outs))
        tx_out, msgs_out, next_out, hops_out = c_outs
        if select.get("infected") is not None:
            return a, (*outs, counts, tx_out, next_out, msgs_out)
        return a, (*outs, counts, tx_out, msgs_out, hops_out, next_out)

    def sent_launch(self, symbol: str, a, t) -> None:
        """The parent's ``sent_select_launch`` or ``sent_commit_launch``
        on a block of ``sent_block``."""
        from corrosion_tpu_torch import kernels

        self._launch("sent_sampler", symbol,
                     (ctypes.c_void_p, ctypes.c_void_p),
                     ctypes.addressof(a), kernels.stream(t))

    def sent_pair(self, select, commit):
        """The parent's two calls of a tick (``sent`` marked in place);
        returns their outputs in ``sent_tick``'s order."""
        a, outs = self.sent_block(select, commit)
        for symbol in ("sent_select_launch", "sent_commit_launch"):
            self.sent_launch(symbol, a, commit["tx"])
        return outs

    def seg_cummax(self, order, seg, values, mask=None, exclusive=True):
        """The parent's ``seg_cummax`` (``seg_cummax``'s arguments), on
        tile words kept apart from this tree's."""
        from corrosion_tpu_torch import kernels
        from corrosion_tpu_torch.kernels import winners

        p, n, dev = kernels.ptr, order.shape[0], order.device
        out = torch.empty(n, dtype=torch.int64, device=dev)
        words = winners._tile_words(
            ("parent", dev, torch.cuda.current_stream(dev).cuda_stream), dev,
            -(-n // winners.CM_TILE))
        self._launch("winners", "seg_cummax_launch",
                     winners._CUMMAX_ARGTYPES, p(order), p(seg), p(values),
                     p(mask), n, int(exclusive), p(out), p(words),
                     kernels.stream(order))
        return out

    def winners_a(self, oA, prev, pk, cl, sent, seed_cl, final_cl,
                  sent_flag, ensure, part, counts):
        """The parent's ``winners_a`` (``winners_a``'s arguments);
        returns its pk_pos."""
        from corrosion_tpu_torch import kernels
        from corrosion_tpu_torch.kernels import winners

        p = kernels.ptr
        pk_pos = torch.empty(oA.shape[0], dtype=torch.int64,
                             device=oA.device)
        self._launch("winners", "winners_a_launch", winners._A_ARGTYPES,
                     p(oA), p(prev), p(pk), p(cl), p(sent), p(seed_cl),
                     oA.shape[0], p(final_cl), p(sent_flag), p(ensure),
                     p(part), p(pk_pos), p(counts), kernels.stream(oA))
        return pk_pos

    def winners_b(self, oB, prev, pk_pos, cid, cl, key, part, seed_key,
                  final_cl, n_cid, winner, clrow, counts) -> None:
        """The parent's ``winners_b`` (``winners_b``'s arguments)."""
        from corrosion_tpu_torch import kernels
        from corrosion_tpu_torch.kernels import winners

        p = kernels.ptr
        self._launch("winners", "winners_b_launch", winners._B_ARGTYPES,
                     p(oB), p(prev), p(pk_pos), p(cid), p(cl), p(key),
                     p(part), p(seed_key), p(final_cl), oB.shape[0], n_cid,
                     p(winner), p(clrow), p(counts), kernels.stream(oB))


# threefry_bits' small sizes (every tail of a 4-word group, more than one
# block), randint's edge spans (1, the multiplier's wrap at 2**16, the
# widest) and the 2**32 window's draw (past the counter's high word)
THREEFRY_SIZES = (1, 3, 4, 5, 1023, 4097)
THREEFRY_SPANS = ((5, 6), (0, 2**16), (0, 2**16 + 1), (-2**31, 2**31 - 1))
THREEFRY_WINDOW = 2**32 + 4099
SENTINEL = 0x7F7F7F7F


def threefry_edge_checks(tf, dev, parent=None) -> list:
    """``threefry_bits`` (``tf.launch``, uncounted) through the 32-bit
    and the 64-bit group index, and the parent's kernel when given,
    bitwise the plain version in each mode at every size of
    ``THREEFRY_SIZES``, into a fresh tensor and into a view 4 bytes past
    a 16-byte boundary, and randint at every span of
    ``THREEFRY_SPANS``; the words around each output must stay
    untouched."""
    from corrosion_tpu_torch.random import randint_span

    key, key2 = (0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344)
    span, mult = randint_span(1, 100_000)
    cases = [(dtype, n, {}) for dtype in (torch.uint32, torch.float32)
             for n in THREEFRY_SIZES]
    cases += [(torch.int32, n, dict(key2=key2, span=span, mult=mult,
                                    minval=1)) for n in THREEFRY_SIZES]
    for lo, hi in THREEFRY_SPANS:
        span, mult = randint_span(lo, hi)
        cases.append((torch.int32, 4097, dict(key2=key2, span=span,
                                              mult=mult, minval=lo)))
    runs = [("index32", lambda o, epi: tf.launch(o, key, **epi)),
            ("index64", lambda o, epi: tf.launch(o, key, index64=True,
                                                 **epi))]
    if parent is not None:
        runs.append(("parent",
                     lambda o, epi: parent.threefry_bits(o, key, **epi)))
    out = []
    for dtype, n, epi in cases:
        want = tf.threefry_bits_plain(
            torch.empty(n, dtype=dtype, device=dev), key, **epi)
        want = want.view(torch.int32)
        for offset in (0, 1):
            for label, run in runs:
                buf = torch.full((n + 8,), SENTINEL, dtype=torch.int32,
                                 device=dev)
                got = buf[offset:offset + n]
                run(got.view(dtype), epi)
                err = max_abs_err([got], [want])
                rest = torch.cat([buf[:offset], buf[offset + n:]])
                if not bool((rest == SENTINEL).all()):
                    fail(f"threefry_bits ({label}) wrote outside its "
                         f"output ({dtype}, n = {n}, offset {offset})")
                out.append(dict(dtype=str(dtype), n=n, offset_bytes=4 * offset,
                                run=label, span=epi.get("span"),
                                max_abs_err=err))
    return out


def threefry_window(tf, dev, parent=None) -> dict:
    """A uint32 draw of ``THREEFRY_WINDOW`` words (past 2**32, about
    17 GB; freed after): the first 2048 words and those from 2**32 - 2048
    on against ``threefry2x32`` on int64 index tensors, through the
    32-bit and the 64-bit group index (each call timed), and the parent's
    kernel when given."""
    key = (0x452821E6, 0x38D01377)
    out = torch.empty(THREEFRY_WINDOW, dtype=torch.uint32, device=dev)
    words = out.view(torch.int32)
    idx = torch.cat([torch.arange(2048),
                     torch.arange(2**32 - 2048, THREEFRY_WINDOW)]).to(dev)
    x0, x1 = tf.threefry2x32(key[0], key[1], idx >> 32, idx & tf.MASK32)
    want = x0 ^ x1
    rec = {"words": THREEFRY_WINDOW, "checked": idx.numel(),
           "max_abs_err": 0.0}
    runs = [("index32", lambda: tf.launch(out, key)),
            ("index64", lambda: tf.launch(out, key, index64=True))]
    if parent is not None:
        runs.append(("parent", lambda: parent.threefry_bits(out, key)))
    for label, fn in runs:
        words.fill_(SENTINEL)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        got = words[idx].to(torch.int64) & tf.MASK32
        err = max_abs_err([got], [want])
        rec[label] = {"ms": start.elapsed_time(end), "max_abs_err": err}
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    del out, words
    torch.cuda.empty_cache()
    return rec


def cummax_sass(mix: dict) -> dict:
    """{seg_cummax function: its instructions, loads (``LDG``) and
    barriers (``BAR``)} of a ``sass.mix`` of ``winners.cu``, keyed from
    "seg_cummax" on (the anonymous namespace's id differs between
    builds)."""
    return {name[name.index("seg_cummax"):]: {
        "n": f["n"], "ldg": sum(c for op, c in f["ops"].items()
                                if op.startswith("LDG")),
        "bar": sum(c for op, c in f["ops"].items() if op.startswith("BAR"))}
        for name, f in mix.items() if "seg_cummax" in name}


def threefry_pipes(mix: dict, group: int) -> dict:
    """Each threefry instantiation's grid-stride loop (its largest), from
    ``sass.mix``: instructions by pipe a loop trip and a word (a trip
    makes ``group`` words)."""
    out = {}
    for name, f in mix.items():
        m = re.search(r"threefry_kernelILi(\d)E([jy])", name)
        if not m or not f["loops"]:
            continue
        loop = f["loops"][-1]
        mode = ("bits", "uniform", "randint")[int(m.group(1))]
        index = "u32" if m.group(2) == "j" else "u64"
        pipes = loop["pipes"]
        out[f"{mode}/{index}"] = dict(
            n=loop["n"], pipes=pipes,
            per_word={p: pipes.get(p, 0) / group for p in ("alu", "fma")})
    return out


def kernel_checks(cfg, mods, dev, parent=None):
    """Phase 2: each kernel against its plain version at tick 7 of the
    headline (state reached through the port on the card); with
    ``parent``, ``threefry_bits`` also against the parent's kernel, timed
    beside it in turns."""
    from corrosion_tpu_torch.kernels import seg_sort
    from corrosion_tpu_torch.models.broadcast import (
        _largest_divisor_upto,
        _perm_senders,
        _rtt_tier,
        _wan_region,
    )
    from corrosion_tpu_torch.random import (
        PRNGKey,
        fold_in,
        key_words,
        randint_span,
        split,
    )
    from corrosion_tpu_torch.sim.epidemic import (
        _partition_ids,
        epidemic_init,
        epidemic_tick,
    )

    threefry, deliver, sync_pull, tick_stats = mods
    seed_key = PRNGKey(0)
    state = epidemic_init(cfg, device=dev)
    for _ in range(7):
        state = epidemic_tick(state, fold_in(seed_key, state.tick), cfg)
    tick = state.tick
    bp, sp = cfg.broadcast_params, cfg.sync_params
    n, k, u = bp.n_nodes, bp.fanout, bp.universe
    key = fold_in(seed_key, tick)
    k_b, k_s = split(key)
    key_t, key_l = split(k_b)
    part = _partition_ids(cfg, dev)
    results = []

    # -- threefry_bits: the tick's draws (loss uniforms, column scores as
    #    uniforms and as raw bits, sync offsets) against the plain version
    #    and the parent's kernel; the four headline shapes and n = 1 timed
    #    in turns with the parent's, each beside its bound
    span, mult = randint_span(1, u)
    kh, kl = (key_words(x) for x in split(k_s))
    randint = dict(key2=kl, span=span, mult=mult, minval=1)
    cases = [  # mode, dtype, shape, key, epilogue, operations a word, timed
        ("uniform", torch.float32, (n, k), key_words(key_l), {},
         INT_OPS_PER_UNIFORM, True),
        ("uniform", torch.float32, (n // u, u), key_words(fold_in(key_t, 2)),
         {}, INT_OPS_PER_UNIFORM, False),
        ("bits", torch.uint32, (n // u, u), key_words(fold_in(key_t, k - 1)),
         {}, INT_OPS_PER_HASH, True),
        ("bits", torch.uint32, (n // 250, 250), key_words(fold_in(key_t, 0)),
         {}, INT_OPS_PER_HASH, True),
        ("randint", torch.int32, (n, sp.peers_per_round), kh, randint,
         INT_OPS_PER_RANDINT, True),
        ("uniform", torch.float32, (1,), key_words(key_l), {},
         INT_OPS_PER_UNIFORM, True),
    ]
    err, shapes = 0.0, []
    for mode, dtype, shape, kw, epi, ops, timed in cases:
        got = torch.empty(shape, dtype=dtype, device=dev)
        want = torch.empty(shape, dtype=dtype, device=dev)
        threefry.threefry_bits(got, kw, **epi)
        threefry.threefry_bits_plain(want, kw, **epi)
        err = max(err, max_abs_err([got.view(torch.int32)],
                                   [want.view(torch.int32)]))
        old = None
        if parent is not None:
            ref = parent.threefry_bits(torch.empty_like(got), kw, **epi)
            if not torch.equal(ref.view(torch.int32), got.view(torch.int32)):
                fail(f"threefry_bits differs from the parent's ({mode} "
                     f"{list(shape)})")

            def old(ref=ref, kw=kw, epi=epi):
                parent.threefry_bits(ref, kw, **epi)
        if not timed:
            continue
        rec = dict(mode=mode, shape=list(shape), **in_turns(
            lambda got=got, kw=kw, epi=epi: threefry.threefry_bits(
                got, kw, **epi),
            old, lambda fn: time_device_ms(fn, 50)))
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes(got),
                                                    got.numel() * ops)
        if len(shapes) == 0:
            rec["plain_ms"] = time_ms(lambda: threefry.threefry_bits_plain(
                want, kw, **epi), 5)
        shapes.append(rec)
    edges = threefry_edge_checks(threefry, dev, parent)
    window = threefry_window(threefry, dev, parent)
    head = shapes[0]
    results.append(dict(
        name="threefry_bits", route="cuda",
        source="corrosion_tpu_torch/kernels/csrc/threefry.cu",
        replaces="jax/_src/prng.py:1184",
        max_abs_err=max([err] + [e["max_abs_err"] for e in edges]
                        + [window["max_abs_err"]]),
        ms=head["ms"], plain_ms=head["plain_ms"],
        bound=(4 * math.prod(head["shape"]),
               math.prod(head["shape"]) * INT_OPS_PER_UNIFORM),
        library_ms=None,
        shape=f"uniform float32 {head['shape']} (the other shapes in "
              f"shapes)",
        shapes=shapes, edges=edges, window=window,
    ))

    # -- seg_argsort: the tick's column keys (raw bits; the 23-bit
    #    scores are bits >> 9) at the global [S, u] and ring0 [N / b0,
    #    b0] shapes; torch.sort of the uniform scores, the library
    #    call, must give the same indices (local: plus each row's
    #    offset)
    b0 = _largest_divisor_upto(u, bp.ring0_size)
    shapes, err = [], 0.0
    for j, block in ((k - 1, u), (0, b0)):
        kw = key_words(fold_in(key_t, j))
        raw = torch.empty((n // block, block), dtype=torch.uint32,
                          device=dev)
        threefry.threefry_bits(raw, kw)
        scores = threefry.threefry_bits(torch.empty(raw.shape, device=dev),
                                        kw)
        got = seg_sort.seg_argsort(raw, 23, 9)
        err = max(err, max_abs_err([got], [seg_sort.seg_argsort_plain(
            raw, 23, 9)]))
        lib = torch.sort(scores, dim=1, stable=True).indices
        if not torch.equal(flat_indices(lib), got):
            fail(f"seg_argsort differs from torch.sort of the uniform "
                 f"scores at {list(raw.shape)}")
        shapes.append(dict(
            shape=list(raw.shape),
            ms=time_device_ms(lambda: seg_sort.seg_argsort(raw, 23, 9), 20),
            plain_ms=time_ms(lambda: seg_sort.seg_argsort_plain(raw, 23, 9),
                             5),
            library_ms=time_device_ms(
                lambda: torch.sort(scores, dim=1, stable=True), 20),
            bound_ms=raw.numel() * 8 / HBM_BYTES_PER_S * 1e3))
    results.append(dict(
        name="seg_argsort", route="cuda", source=SORT_SOURCE,
        replaces="corrosion_tpu/models/broadcast.py:321",
        max_abs_err=err, ms=shapes[0]["ms"], plain_ms=shapes[0]["plain_ms"],
        bound=(n * 8, 0), library_ms=shapes[0]["library_ms"],
        shape=f"uint32 {shapes[0]['shape']} (global column; ring0 "
              f"{shapes[1]['shape']} in shapes)",
        shapes=shapes,
    ))

    # -- deliver_perm: the tick's K sender maps and loss draws
    senders = torch.stack([
        _perm_senders(key_t, j, n, u, j < bp.fanout_ring0, bp.ring0_size,
                      device=dev)
        for j in range(k)
    ])
    loss_u = torch.empty((n, k), dtype=torch.float32, device=dev)
    threefry.threefry_bits(loss_u, key_words(key_l))
    dargs = dict(
        hops=state.hops, next_send=state.next_send, tick=tick,
        loss_u=loss_u, wan_u=None, region=_wan_region(bp, dev),
        partition_id=part, sev=None, partition_active=tick < cfg.heal_tick,
        tier=_rtt_tier(bp, dev), loss=bp.loss, wan_loss=bp.wan_cross_loss,
        max_tx=bp.max_transmissions, backoff=bp.backoff_ticks,
    )
    inputs = (state.rows, state.tx_remaining, state.msgs, senders)
    got = deliver.deliver_perm(*inputs, **dargs)
    want = deliver.deliver_perm_plain(*inputs, **dargs)
    old = None
    if parent is not None:
        full = dict(dargs, src_rows=None, slot_of=None, lo=0)
        if max_abs_err(parent.deliver_perm(*inputs, **full), got):
            fail("deliver_perm differs from the parent's")

        def old():
            parent.deliver_perm(*inputs, **full)
    turns = in_turns(lambda: deliver.deliver_perm(*inputs, **dargs), old,
                     lambda fn: time_device_ms(fn, 20))
    results.append(dict(
        name="deliver_perm", route="cuda",
        source="corrosion_tpu_torch/kernels/csrc/deliver_perm.cu",
        replaces="corrosion_tpu/models/broadcast.py:327",
        max_abs_err=max_abs_err(got, want), ms=turns["ms"], turns=turns,
        plain_ms=time_ms(
            lambda: deliver.deliver_perm_plain(*inputs, **dargs), 3),
        bound=(nbytes(*inputs, state.hops, state.next_send, loss_u, part,
                      *got), 0),
        library_ms=None,
        shape=f"rows int32 [{n}, {cfg.n_rows}], K={k}",
    ))

    # -- sync_pull: this sync tick's pull on the delivered state
    rows_b, msgs_b = got[0], got[2]
    offs = torch.empty((n, sp.peers_per_round), dtype=torch.int32,
                       device=dev)
    threefry.threefry_bits(offs, kh, key2=kl, span=span, mult=mult,
                           minval=1)
    sargs = dict(partition_id=part, sev=None,
                 partition_active=tick < cfg.heal_tick,
                 cells_per_chunk=sp.cells_per_chunk,
                 handshake_msgs=sp.handshake_msgs)
    got_s = sync_pull.sync_pull(rows_b, msgs_b, offs, u, **sargs)
    want_s = sync_pull.sync_pull_plain(rows_b, msgs_b, offs, u, **sargs)
    results.append(dict(
        name="sync_pull", route="cuda",
        source="corrosion_tpu_torch/kernels/csrc/sync_pull.cu",
        replaces="corrosion_tpu/models/sync.py:90",
        max_abs_err=max_abs_err(got_s, want_s),
        ms=time_ms(lambda: sync_pull.sync_pull(rows_b, msgs_b, offs, u,
                                               **sargs), 20),
        plain_ms=time_ms(lambda: sync_pull.sync_pull_plain(
            rows_b, msgs_b, offs, u, **sargs), 3),
        bound=(nbytes(rows_b, msgs_b, offs, part, *got_s), 0),
        library_ms=None,
        shape=f"rows int32 [{n}, {cfg.n_rows}], P={sp.peers_per_round}",
    ))

    # -- tick_stats: the state after the tick, then the exact column's
    #    byte rows at their shapes, and the edge cases
    results.append(stats_checks(
        tick_stats, dev,
        (got_s[0], state.rows[0].clone(), got_s[1], got[3]),
        cfg.n_universes, cfg.n_rows))

    for r in results:
        set_bound(r)
        if r["max_abs_err"] != 0.0:
            fail(f"{r['name']} differs from its plain version "
                 f"(max |diff| {r['max_abs_err']})")
    return results


# the exact column's statistics shapes: dense 100k x 16, sparse 1M x 4
# and the mesh's host-sparse 10M x 2 (a copy a host), byte rows
STATS_BYTE_SHAPES = ((16, 100_000), (4, 1_000_000), (2, 10_000_000))


def stats_inputs(s: int, n: int, r: int, hops: bool, dev, seed: int):
    """Seeded [S*n] statistics inputs: byte rows (r = 0) or int32 rows
    [S*n, r] against a target of ones, msgs as a mid-run holds them
    (K = 4 sends and sync messages), hop depths with a third unset."""
    from corrosion_tpu_torch.kernels.deliver import HOP_UNSET

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    total = s * n

    def ints(hi, shape=(total,)):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    if r:
        rows = (ints(16, (total, r)) != 0).to(torch.int32)
        target = torch.ones(r, dtype=torch.int32, device=dev)
    else:
        rows, target = ints(4) != 0, None
    msgs = ints(9) * 4 + ints(3)
    h = None
    if hops:
        h = ints(24)
        h[ints(3) == 0] = HOP_UNSET
    return rows, target, msgs, h


def equal_nan(a, b) -> bool:
    """Bitwise-equal values, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


def stats_equal(ts, inputs, s: int, label: str, out=None) -> torch.Tensor:
    """Every design of ``tick_stats`` bitwise its plain version (NaN
    equal to NaN) on ``inputs``; returns the kernel's statistics."""
    rows, target, msgs, hops = inputs
    want = ts.tick_stats_plain(rows, target, msgs, hops, s, torch.empty(
        (s, len(ts.STATS)), dtype=torch.float32, device=msgs.device))
    got = ts.tick_stats(rows, target, msgs, hops, s)
    for d, name in enumerate(ts.DESIGNS):
        if not equal_nan(design_stats(ts, inputs, s, d), want):
            fail(f"tick_stats ({name}) differs from its plain version at "
                 f"{label}:\n{got}\n{want}")
    if not equal_nan(got, want):
        fail(f"tick_stats differs from its plain version at {label}")
    return got


def design_stats(ts, inputs, s: int, design: int, out=None):
    """``tick_stats`` on ``inputs`` through design ``design`` of the
    kernel (``ts.DESIGNS``), whatever the wrapper would choose."""
    if out is None:
        out = torch.empty((s, len(ts.STATS)), dtype=torch.float32,
                          device=inputs[2].device)
    return ts._launch(*inputs, s, out, design)


def stats_edge_checks(ts, dev) -> list:
    """``tick_stats`` at the edges, every design against the plain
    version: n a multiple of no tile, S = 1, series spanning NBINS - 1
    values above a minimum far from 0 (accepted), a universe without a
    measured hop depth (NaN), and one more value in the span (+inf in
    that universe's percentiles alone)."""
    cases = []
    for s, n, r in ((3, 100_003, 8), (3, 100_003, 0), (1, 100_000, 8),
                    (1, 100_000, 0), (2, 4_099, 5)):
        inputs = stats_inputs(s, n, r, r > 0, dev, 7 + s + r)
        stats_equal(ts, inputs, s, f"[{s} x {n}], R={r}")
        cases.append(f"[{s} x {n}] R={r}")
    s, n, top = 4, 50_000, ts.NBINS - 1
    rows, target, msgs, hops = stats_inputs(s, n, 8, True, dev, 11)
    m, h = msgs.view(s, n), hops.view(s, n)
    m[1] += 12_345
    m[1, 0], m[1, 1] = 12_345, 12_345 + top  # spans NBINS - 1
    h[3] = torch.where(h[3] < ts.HOP_UNSET, h[3] + 3, h[3])
    h[3, 0], h[3, 1] = 3, 3 + top
    h[2] = ts.HOP_UNSET  # no measured depth
    h[2, :10] = ts.HOP_UNSET - 1
    base = stats_equal(ts, (rows, target, msgs, hops), s, "spans NBINS - 1")
    if not bool(torch.isnan(base[2, ts.HOPS_P50:ts.HOPS_P99 + 1]).all()):
        fail("tick_stats: a universe without a measured depth is not NaN")
    cases.append("spans of NBINS - 1, no measured depth")
    for label, series, u, cols in (
            ("msgs", msgs, 1, (ts.MSGS_P99,)),
            ("hops", hops, 3, (ts.HOPS_P50, ts.HOPS_P99))):
        wide = series.clone()
        wide.view(s, n)[u, 1] += 1  # spans NBINS
        args = (wide, hops) if label == "msgs" else (msgs, wide)
        expect = ts.tick_stats_plain(rows, target, *args, s,
                                     torch.empty_like(base))
        expect[u, list(cols)] = math.inf
        for d, name in enumerate(ts.DESIGNS):
            flagged = design_stats(ts, (rows, target, *args), s, d)
            if not equal_nan(flagged, expect):
                fail(f"tick_stats ({name}): a {label} series spanning "
                     f"NBINS values was not flagged in its universe "
                     f"alone:\n{flagged}")
            try:
                ts.raise_on_overflow(flagged.cpu().numpy())
            except ValueError:
                pass
            else:
                fail("tick_stats: raise_on_overflow missed a flag")
        cases.append(f"{label} spanning NBINS flagged")
    return cases


def stats_checks(ts, dev, headline, s: int, r: int) -> dict:
    """Phase 2's ``tick_stats``: bitwise its plain version at the
    headline's shape (``headline``: tick 7's rows, target, msgs, hops)
    and at the exact column's byte-row shapes, every design timed
    there, with the edge cases; the scratch must be all zero after
    every call."""
    shapes = []
    for label, s_, inputs in (
            (f"{s} x {headline[2].numel() // s}, R={r}, hops", s, headline),
            *((f"{u} x {n}, byte rows", u,
               stats_inputs(u, n, 0, False, dev, u))
              for u, n in STATS_BYTE_SHAPES)):
        rows, target, msgs, hops = inputs
        stats_equal(ts, inputs, s_, label)
        out = torch.empty((s_, len(ts.STATS)), dtype=torch.float32,
                          device=dev)
        moved = nbytes(rows, target, msgs, hops, out)
        entry = dict(shape=label, bytes=moved,
                     bound_ms=moved / HBM_BYTES_PER_S * 1e3)
        for d, name in enumerate(ts.DESIGNS):
            entry[name] = time_device_ms(
                lambda d=d: design_stats(ts, inputs, s_, d, out), 20)
        entry["ms"] = time_device_ms(
            lambda: ts.tick_stats(*inputs, s_, out=out), 20)
        entry["plain_ms"] = time_ms(lambda: ts.tick_stats_plain(
            *inputs, s_, out), 3)
        shapes.append(entry)
    edges = stats_edge_checks(ts, dev)
    if any(int(torch.count_nonzero(b)) for b in ts._SCRATCH.values()):
        fail("tick_stats left its scratch nonzero")
    head = shapes[0]
    return dict(
        name="tick_stats", route="cuda",
        source="corrosion_tpu_torch/kernels/csrc/tick_stats.cu",
        replaces="corrosion_tpu/sim/epidemic.py:272", max_abs_err=0.0,
        ms=head["ms"], plain_ms=head["plain_ms"],
        bound=(head["bytes"], 0),
        library_ms=None, shape=head["shape"], shapes=shapes, edges=edges)


def bound_ms(b: int, ops: int) -> tuple:
    """The least time on the card of moving ``b`` bytes and running
    ``ops`` integer operations: (ms, "bytes" or "operations")."""
    t_bytes = b / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def set_bound(r: dict) -> None:
    """Replace ``r["bound"]`` (bytes, integer operations) by the
    least time of the two on the card and which one it is."""
    r["bound_ms"], r["bound_by"] = bound_ms(*r.pop("bound"))


def states_equal(a, b) -> bool:
    """Every leaf of two states of one type equal (tensors compared on
    the host; ints and None as values)."""
    for x, y in zip(a, b):
        tx, ty = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
        if tx or ty:
            if not (tx and ty and torch.equal(x.cpu(), y.cpu())):
                return False
        elif x != y:
            return False
    return True


# phase 4's variants of the headline at 1024 nodes: the kernel paths
# the headline itself never takes (RTT tiers and backoff, WAN drops,
# one-way severance with two sync peers, R % 4 != 0 without hops and a
# prime universe's ring0 fallback)
VARIANTS = {
    "het_ring": dict(topology="het_ring", rtt_tiers=3, backoff_ticks=1.5),
    "wan_two_region": dict(topology="wan_two_region", partition_blocks=1),
    "measured_ring": dict(topology="measured_ring",
                          rtt_tier_weights=(2.0, 1.0, 1.0),
                          backoff_ticks=2.5),
    "oneway": dict(oneway_blocks=((0, 1),), sync_peers=2),
    "r5_nohops_prime": dict(n_nodes=1021, n_rows=5, track_hops=False),
}


def run_equal(cfg, seeds: int, dev, label: str) -> dict:
    """The port's kernels on the card equal its plain versions on the
    CPU, tick by tick (state and tick stats) until every universe has
    converged, and in the stats dict of ``run_epidemic_seeds``."""
    from corrosion_tpu_torch.kernels.tick_stats import CONVERGED, tick_stats
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim.epidemic import (
        epidemic_init,
        epidemic_tick,
        run_epidemic_seeds,
    )

    flat = replace(cfg, n_universes=seeds)
    key = PRNGKey(0)
    gpu = epidemic_init(flat, device=dev)
    cpu = epidemic_init(flat, device="cpu")
    target_g, target_c = gpu.rows[0].clone(), cpu.rows[0].clone()
    ticks = 0
    while ticks < cfg.max_ticks:
        k = fold_in(key, ticks)
        gpu = epidemic_tick(gpu, k, flat)
        cpu = epidemic_tick(cpu, k, flat)
        ticks += 1
        if not states_equal(gpu, cpu):
            fail(f"{label}: card and CPU states differ at tick {ticks}")
        sg = tick_stats(gpu.rows, target_g, gpu.msgs, gpu.hops, seeds).cpu()
        sc = tick_stats(cpu.rows, target_c, cpu.msgs, cpu.hops, seeds)
        if not torch.equal(torch.nan_to_num(sg), torch.nan_to_num(sc)):
            fail(f"{label}: tick stats differ at tick {ticks}")
        if bool((sc[:, CONVERGED] == 1.0).all()):
            break
    a = run_epidemic_seeds(cfg, n_seeds=seeds, seed=0, device=dev)
    b = run_epidemic_seeds(cfg, n_seeds=seeds, seed=0, device="cpu")
    a.pop("wall_s")
    b.pop("wall_s")
    if a != b:
        fail(f"{label}: stats differ:\ncard {a}\ncpu  {b}")
    return {"ticks_compared": ticks, "stats": a}


# -- the exact sampler ----------------------------------------------------

SECTOR = 32  # bytes a random access moves at least
BUSY_TICK = 6  # most rows of the writer's block are active by then
LATE_TICK = 8  # the dense run's third checked tick
# a GPU-side wait queued before a timed call, so the host's enqueue of
# the call hides behind it (about 1 ms at 1.98 GHz)
SLEEP_CYCLES = 2_000_000


def exact_cfgs():
    """The full-width exact configs (``sim.calibrate.EXACT_DENSE`` and
    ``EXACT_SPARSE``: bench.py ``_frontier_exact_cfg`` at 100k
    partitioned and 1M loss-only, bench.py:2538-2553) and their seeds
    (``_exact_seed_policy``, bench.py:3576-3584)."""
    from corrosion_tpu_torch.sim import calibrate as cal

    return ((cal.EXACT_DENSE, cal.EXACT_DENSE_SEEDS),
            (cal.EXACT_SPARSE, cal.EXACT_SPARSE_SEEDS))


def frontier_cap(cfg) -> int:
    return cfg.max_transmissions * cfg.fanout


def time_inplace_ms(restore, fn, reps: int, warm: int = 2) -> float:
    """Mean ms of ``fn`` on the card (a CUDA event pair around each
    call) when ``fn`` updates its inputs in place: ``restore`` puts the
    inputs back before every call, outside the timed pair (its copies
    also evict the L2 cache, as a tick's other work would).  A GPU-side
    sleep before the pair keeps the host's enqueue of ``fn`` out of
    the time."""
    for _ in range(warm):
        restore()
        fn()
    pairs = []
    for _ in range(reps):
        restore()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def exact_advance(state, base, cfg, tick: int, sparse: bool):
    """Tick ``state`` (seed keys ``base``) on through ``tick - 1``."""
    from corrosion_tpu_torch.random import fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    tick_fn = cal.frontier_exact_tick if sparse else cal.packed_exact_tick
    while state.tick < tick:
        state = tick_fn(state, [fold_in(k, state.tick) for k in base], cfg)
    return state


def exact_state_at(cfg, seeds: int, tick: int, sparse: bool, dev):
    """The first ``seeds`` seeds of ``run_exact_headline(seed=0)`` at
    ``tick``, reached through the port on ``dev``; and the seed keys."""
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    base = [PRNGKey(s) for s in range(seeds)]
    init = cal.frontier_exact_init if sparse else cal.packed_exact_init
    state = init(cfg, [fold_in(k, 2**20) for k in base], device=dev)
    return exact_advance(state, base, cfg, tick, sparse), base


MUTATED = ("tx", "next_send", "msgs", "pending", "sent")


def busiest_tick(cfg, seeds: int, dev) -> dict:
    """The tick of the sparse run (``run_exact_headline``'s seeds and
    keys) whose rejection loop ran the most rounds in one row (the
    ``diag`` maximum; ties to the most rounds in all), with each tick's
    counters."""
    from corrosion_tpu_torch.kernels.exact_send import DIAG
    from corrosion_tpu_torch.random import fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    state, base = exact_state_at(cfg, seeds, 0, True, dev)
    per_tick = []
    while state.tick < cfg.max_ticks:
        d = torch.zeros(len(DIAG), dtype=torch.int64, device=dev)
        tick = state.tick
        state = cal.frontier_exact_tick(
            state, [fold_in(k, tick) for k in base], cfg, diag=d)
        per_tick.append((tick, *d.tolist()))
        if not bool((state.infected & (state.tx > 0)).any()):
            break
    top = max(per_tick, key=lambda t: (t[3], t[2]))
    return {"tick": top[0], "per_tick": per_tick}


def exact_kernel_checks(dev, parent=None):
    """``exact_send`` (both representations) and ``exact_commit``
    against their plain versions on the card, on the inputs of ticks 1
    and ``BUSY_TICK`` of the full-width runs at their own seed counts
    (the shapes the main path launches), and of a WAN latency variant
    of each (which fills the queue); for the ring also the run's
    busiest tick (``busiest_tick``), for the bitmap ``LATE_TICK`` and
    ``bitmap_edge_checks``.  Timed at each tick of the uniform runs.
    The dense check holds three copies of the 20 GB bitmap (the state,
    the kernel's and the plain version's); the timed calls reuse the
    kernel's.  With ``parent``, ``exact_send<Bitmap>`` is held to the
    parent's and timed beside it in turns at each timed tick."""
    from corrosion_tpu_torch.kernels import exact_send as es
    from corrosion_tpu_torch.random import fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    (dense, dense_seeds), (sparse, sparse_seeds) = exact_cfgs()
    latency = dict(topology="wan_two_region", partition_blocks=1,
                   heal_tick=0, wan_latency_ticks=2)
    cases = (
        ("bitmap", dense, dense_seeds, False),
        ("bitmap", replace(dense, **latency), 2, False),
        ("ring", sparse, sparse_seeds, True),
        ("ring", replace(sparse, **latency), sparse_seeds, True),
    )
    errs = {"bitmap": 0.0, "ring": 0.0, "commit": 0.0}
    timed, checks = {}, []

    def diag():
        return torch.zeros(len(es.DIAG), dtype=torch.int64, device=dev)

    busiest = None
    for rep, cfg, seeds, ring in cases:
        ticks = [1, BUSY_TICK]
        if ring and cfg.topology == "uniform":
            busiest = busiest_tick(cfg, seeds, dev)
            ticks = sorted({*ticks, busiest["tick"]})
        elif cfg.topology == "uniform":
            ticks.append(LATE_TICK)
        state, base = exact_state_at(cfg, seeds, 0, ring, dev)
        for tick in ticks:
            state = exact_advance(state, base, cfg, tick, ring)
            args, _, _ = cal._send_inputs(
                state, [fold_in(k, tick) for k in base], cfg)
            saved = {f: args[f] for f in MUTATED if args[f] is not None}
            got = {**args, **{f: v.clone() for f, v in saved.items()}}
            want = {**args, **{f: v.clone() for f, v in saved.items()}}
            got_d, want_d = diag(), diag()
            got_inf = es.exact_send(**got, diag=got_d)
            want_inf = es.exact_send_plain(**want, diag=want_d)
            names = ["new_infected", *saved, "diag"]
            a = [got_inf, *(got[f] for f in saved), got_d]
            b = [want_inf, *(want[f] for f in saved), want_d]
            err = max_abs_err(a, b)
            errs[rep] = max(errs[rep], err)
            bad = [nm for nm, x, y in zip(names, a, b)
                   if not torch.equal(x, y)]
            del a, b, want, want_inf
            # the commit on the kernel's send results
            c_got = [got["tx"].clone(), got["next_send"].clone()]
            c_want = [t.clone() for t in c_got]
            es.exact_commit(args["infected"], got_inf, *c_got, tick,
                            cfg.max_transmissions, args["tier"])
            es.exact_commit_plain(args["infected"], got_inf, *c_want,
                                  tick, cfg.max_transmissions, args["tier"])
            c_err = max_abs_err(c_got, c_want)
            errs["commit"] = max(errs["commit"], c_err)
            d = got_d.tolist()
            learned = int((got_inf & ~args["infected"]).sum())
            checks.append(dict(
                rep=rep, n=cfg.n_nodes, seeds=seeds, tick=tick,
                topology=cfg.topology, max_abs_err=err, differs=bad,
                commit_max_abs_err=c_err, active_rows=d[0],
                rounds_mean=d[1] / max(1, d[0]), rounds_max=d[2],
                learned=learned))
            if cfg.topology == "uniform":
                times = exact_times(es, cfg, seeds, ring, rep, tick, args,
                                    saved, got, got_inf, d, learned, diag(),
                                    parent)
                checks[-1]["times"] = {k: {f: v[f] for f in v if f in (
                    "ms", "ms_runs", "parent_ms", "bound", "shape")}
                    for k, v in times.items()}
                if tick == BUSY_TICK:
                    timed.update(times)
            del got, got_inf, args, saved, c_got, c_want
            torch.cuda.empty_cache()
        del state
        torch.cuda.empty_cache()
    checks += bitmap_edge_checks(es, dev)
    for c in checks:
        if c["differs"] or c.get("commit_max_abs_err", 0.0) != 0.0:
            fail(f"exact kernels differ from their plain versions: {c}")
    commit, commit_times = commit_checks(es, dev, parent)
    checks += commit
    timed["commit"] = {**commit_times["host_2x5m_of_10m few"],
                       "shapes": commit_times}
    source = "corrosion_tpu_torch/kernels/csrc/exact_send.cu"
    results = []
    for name, key, replaces in (
        ("exact_send<Bitmap>", "bitmap",
         "corrosion_tpu/sim/calibrate.py:587"),
        ("exact_send<Ring>", "ring", "corrosion_tpu/sim/calibrate.py:1157"),
        ("exact_commit", "commit", "corrosion_tpu/sim/calibrate.py:658"),
    ):
        results.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=errs[key], library_ms=None, **timed[key]))
        if "bound" in results[-1]:
            set_bound(results[-1])
    return results, checks, busiest


def bitmap_edge_checks(es, dev) -> list:
    """``exact_send<Bitmap>`` against its plain version, every output
    bitwise, on crafted states at N = 64, 2 seeds, where a row's
    candidates often share one of its 8 bitmap bytes: K = 4 (the exact
    column's fanout, its own kernel) with an empty bitmap and with about
    60% of each row's bits set, so rows redraw past the block's
    KEY_ROUNDS round keys (its maximum must exceed them), and K = 3 and
    8 (the kernel for any K); loss and a partition in force."""
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim.calibrate import _tick_keys

    s, n, max_tx, tick = 2, 64, 8, 3
    keys, _ = _tick_keys([fold_in(PRNGKey(40 + x), tick) for x in range(s)])
    g = torch.Generator(device=dev)
    g.manual_seed(64)
    out = []
    for label, fill, k in (("n64_k4", 0.0, 4), ("n64_k4_redraws", 0.6, 4),
                           ("n64_k3", 0.3, 3), ("n64_k8", 0.1, 8)):
        p = es.SendParams(fanout=k, max_tx=max_tx, backoff=0.5, loss=0.05,
                          part_blocks=2, heal_tick=5)
        base = dict(
            infected=torch.rand((s, n), generator=g, device=dev) < 0.7,
            tx=torch.randint(0, max_tx + 1, (s, n), generator=g,
                             device=dev, dtype=torch.int32),
            next_send=torch.randint(0, tick + 2, (s, n), generator=g,
                                    device=dev, dtype=torch.int32),
            msgs=torch.zeros((s, n), dtype=torch.int32, device=dev),
            pending=None,
            sent=(torch.rand((s, n, n), generator=g, device=dev) < fill),
            keys=keys, tick=tick, p=p, tier=None)
        bits = base["sent"].reshape(s, n, n // 8, 8).to(torch.int32)
        base["sent"] = (bits << torch.arange(8, device=dev)).sum(-1).to(
            torch.uint8)
        runs = {}
        for who, fn in (("kernel", es.exact_send),
                        ("plain", es.exact_send_plain)):
            a = {f: v.clone() if isinstance(v, torch.Tensor) else v
                 for f, v in base.items()}
            d = torch.zeros(len(es.DIAG), dtype=torch.int64, device=dev)
            new_inf = fn(**a, diag=d)
            runs[who] = [new_inf, *(a[f] for f in MUTATED if a[f] is not None),
                         d]
        names = ["new_infected", *(f for f in MUTATED if base[f] is not None),
                 "diag"]
        bad = [f"{who} {nm}" for who in runs if who != "kernel"
               for nm, x, y in zip(names, runs["kernel"], runs[who])
               if not torch.equal(x, y)]
        d = runs["kernel"][-1].tolist()
        out.append(dict(rep="bitmap", n=n, seeds=s, tick=tick, case=label,
                        differs=bad, active_rows=d[0],
                        rounds_mean=d[1] / max(1, d[0]), rounds_max=d[2]))
        if label.endswith("redraws") and d[2] <= es.KEY_ROUNDS:
            fail(f"{label}: no row redrew past the {es.KEY_ROUNDS} rounds "
                 f"of the block's key table ({d})")
    return out


def parent_send_check(es, parent, work, restore, saved, tick: int):
    """The parent's ``exact_send<Bitmap>`` on ``work`` restored from
    ``saved`` must write what this tree's writes, every leaf and the
    counters; returns it as a function of its ``diag``."""
    outs = []
    for fn in (es.exact_send, parent.exact_send):
        restore()
        d = torch.zeros(len(es.DIAG), dtype=torch.int64, device=work[
            "infected"].device)
        new_inf = fn(**work, diag=d)
        # this tree's leaves copied (one more bitmap), the parent's read
        # in place
        outs.append([new_inf, *(work[f] if outs else work[f].clone()
                                for f in saved), d])
    bad = [f for f, x, y in zip(["new_infected", *saved, "diag"], *outs)
           if not torch.equal(x, y)]
    if bad:
        fail(f"exact_send<Bitmap> differs from the parent's at tick "
             f"{tick}: {bad}")
    del outs
    torch.cuda.empty_cache()
    return lambda diag: parent.exact_send(**work, diag=diag)


def exact_times(es, cfg, seeds, ring, rep, tick, args, saved, work,
                new_infected, d, learned, t_diag, parent=None) -> dict:
    """Times of ``exact_send`` (and for the bitmap ``exact_commit``) on
    one tick's inputs, with their bounds.  ``work`` is the kernel's
    copy of the inputs; ``restore`` puts ``saved`` back into it before
    every call.  With ``parent``, the bitmap's is held to the parent's
    and timed beside it in turns."""
    def restore():
        for f, v in saved.items():
            work[f].copy_(v)

    total = seeds * cfg.n_nodes
    k = cfg.fanout
    # every row's activity test; an active row's own leaves (17 bytes
    # read, 12 written), its infection stores, and its bitmap sectors
    # read and marked, or its ring row read and its slots written
    memory = 4 * frontier_cap(cfg) + SECTOR if ring else 2 * k * SECTOR
    send_bytes = total * 9 + d[0] * (17 + 12 + k * SECTOR + memory)
    # a drawn candidate's two hashes; the round keys (fold_in and
    # randint's split, 3 hashes) depend on (seed, round) alone: counted
    # for the busiest row's rounds only; an active row's loss draws
    hashes = d[1] * 2 * k + 3 * d[2] + d[0] * k * (cfg.loss > 0)
    old = None
    if parent is not None and not ring:
        old = parent_send_check(es, parent, work, restore, saved, tick)
    out = {rep: dict(
        **in_turns(lambda: es.exact_send(**work, diag=t_diag),
                   old and (lambda: old(t_diag)),
                   lambda fn: time_inplace_ms(restore, fn, 20)),
        plain_ms=time_inplace_ms(
            restore, lambda: es.exact_send_plain(**work, diag=t_diag), 1, 1),
        bound=(send_bytes, hashes * INT_OPS_PER_HASH),
        shape=f"{rep} {seeds} seeds x {cfg.n_nodes}, tick {tick}, "
              f"{d[0]} active rows",
    )}
    if ring:
        return out
    cw = [work["tx"].clone(), work["next_send"].clone()]
    c_src = [t.clone() for t in cw]

    def c_restore():
        for x, y in zip(cw, c_src):
            x.copy_(y)

    def commit(fn):
        return lambda: fn(args["infected"], new_infected, *cw, tick,
                          cfg.max_transmissions, args["tier"])

    out["commit"] = dict(
        **in_turns(commit(es.exact_commit),
                   parent and commit(parent.exact_commit),
                   lambda fn: time_inplace_ms(c_restore, fn, 20)),
        plain_ms=time_inplace_ms(c_restore, commit(es.exact_commit_plain),
                                 3),
        bound=(commit_bytes(new_infected & ~args["infected"]), 0),
        shape=f"{seeds} seeds x {cfg.n_nodes}, tick {tick}, "
              f"{learned} learners",
    )
    return out


# exact_commit's shapes on the main paths (label, seeds, row of the
# masks, window's first column, width): the dense and sparse runs, the
# host layout's window of the 10M pair (host 1), the sharded-dense
# layout's shard of 12,500 nodes (and one off a 16-byte boundary), the
# frontier layout's replicated [4, 1M]
COMMIT_SHAPES = (
    ("dense_16x100k", 16, 100_000, 0, 100_000),
    ("sparse_4x1m", 4, 1_000_000, 0, 1_000_000),
    ("host_2x5m_of_10m", 2, 10_000_000, 5_000_000, 5_000_000),
    ("sharded_dense_4x12500", 4, 12_500, 0, 12_500),
    ("sharded_dense_4x12500_lo3", 4, 100_000, 3, 12_500),
    ("frontier_4x1m", 4, 1_000_000, 0, 1_000_000),
)
# learners a position: a first chunk's few (the 10M run's first ticks)
# and a busy tick's many
COMMIT_LEARNERS = {"few": 1e-4, "many": 0.3}
L2_FLUSH_BYTES = 128 << 20  # over the card's 50 MB L2


def commit_bytes(learned: torch.Tensor, tier=None) -> int:
    """What ``exact_commit`` must move on these masks: 2 bytes a position
    read, and each 32-byte sector of tx and next_send ([S, n] int32)
    that holds a learner written (of tier, read, with one)."""
    def sectors(flat):
        pad = (-flat.numel()) % 8
        return int(torch.nn.functional.pad(flat, (0, pad)).view(-1, 8)
                   .any(1).sum())

    b = 2 * learned.numel() + 2 * SECTOR * sectors(learned.reshape(-1))
    if tier is not None:
        b += SECTOR * sectors(learned.any(0))
    return b


def commit_case(g, s: int, n_full: int, lo: int, width: int, frac: float,
                dev):
    """Seeded [s, n_full] masks (30% infected, ``frac`` of the rest
    learning; learners at the window's first and last byte), the
    window's tier map and tx / next_send placed between sentinel
    words."""
    inf = torch.rand((s, n_full), generator=g, device=dev) < 0.3
    new = inf | (torch.rand((s, n_full), generator=g, device=dev) < frac)
    for c in (lo, lo + width - 1):
        inf[:, c], new[:, c] = False, True
    tier = torch.randint(1, 5, (width,), generator=g, device=dev,
                         dtype=torch.int32)
    outs = []
    for hi in (9, 40):
        buf, view = placed((s, width), 3, dev)
        view.copy_(torch.randint(0, hi, (s, width), generator=g, device=dev,
                                 dtype=torch.int32))
        outs.append((buf, view))
    return inf, new, tier, outs


def commit_checks(es, dev, parent=None):
    """``exact_commit`` against its plain version, bitwise, at every
    shape of ``COMMIT_SHAPES`` with few and many learners, tier given
    and not, on the window in place (the masks' rows a full row apart),
    the words around tx / next_send untouched; also with the two masks
    off 16-byte alignment from each other (byte loads), and with
    ``parent`` the parent's kernel on the same windows.  Times (no tier)
    behind a GPU sleep, the L2 filled with other, clean lines before
    each call (a read of 128 MB), in turns with the parent's.  Returns
    the checks and {label: times and bound}."""
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def evict():
        flush.sum()
    checks, times = [], {}
    for label, s, n_full, lo, width in COMMIT_SHAPES:
        for dense_label, frac in COMMIT_LEARNERS.items():
            inf, new, tier, outs = commit_case(g, s, n_full, lo, width,
                                               frac, dev)
            w_inf, w_new = inf[:, lo:lo + width], new[:, lo:lo + width]
            learned = w_new & ~w_inf
            start = [v.clone() for _, v in outs]
            row = dict(shape=label, learners=dense_label,
                       count=int(learned.sum()), differs=[])
            for tr in (None, tier):
                want = [t.clone() for t in start]
                es.exact_commit_plain(w_inf, w_new, *want, 5, 8, tr)
                runs = {"kernel": lambda o, tr=tr: es.exact_commit(
                    w_inf, w_new, *o, 5, 8, tr)}
                if parent is not None:
                    runs["parent"] = lambda o, tr=tr: parent.exact_commit(
                        w_inf, w_new, *o, 5, 8, tr)
                if lo:  # new_infected 2 bytes further along its row
                    shifted = torch.zeros((s, n_full + 2), dtype=torch.bool,
                                          device=dev)
                    shifted[:, lo + 2:lo + 2 + width] = w_new
                    runs["apart"] = lambda o, tr=tr: es.exact_commit(
                        w_inf, shifted[:, lo + 2:lo + 2 + width], *o, 5, 8,
                        tr)
                for who, run in runs.items():
                    for (_, v), x in zip(outs, start):
                        v.copy_(x)
                    run([v for _, v in outs])
                    torch.cuda.synchronize()
                    tag = f"{who}{'' if tr is None else ' tier'}"
                    if not all(torch.equal(v, w) for (_, v), w in
                               zip(outs, want)):
                        row["differs"].append(tag)
                    if not all(bool((b[:3] == SENTINEL).all())
                               and bool((b[-4:] == SENTINEL).all())
                               for b, _ in outs):
                        row["differs"].append(f"{tag} sentinels")
            checks.append(row)
            if row["differs"]:
                fail(f"exact_commit differs from its plain version: {row}")
            if label.endswith("lo3"):
                continue
            o = [v for _, v in outs]

            def kernel():
                es.exact_commit(w_inf, w_new, *o, 5, 8)

            old = None
            if parent is not None:
                def old():
                    parent.exact_commit(w_inf, w_new, *o, 5, 8)
            entry = dict(
                **in_turns(kernel, old, lambda fn: time_inplace_ms(
                    evict, fn, 20)),
                plain_ms=time_inplace_ms(evict, lambda:
                                         es.exact_commit_plain(
                                             w_inf, w_new, *o, 5, 8), 3),
                learners=row["count"],
                bound=(commit_bytes(learned), 0),
                shape=f"[{s}, {width}] of [{s}, {n_full}] at {lo}, "
                      f"{row['count']} learners",
            )
            set_bound(entry)
            times[f"{label} {dense_label}"] = entry
            del inf, new, tier, outs, w_inf, w_new, learned, start, old
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    print(json.dumps({"exact_commit": times}), flush=True)
    return checks, times


EXACT_COUNTED = ("exact_send", "exact_commit", "sync_pull", "tick_stats",
                 "threefry_bits")


def exact_full_width(counted) -> dict:
    """The dense 100k x 16-seed and sparse 1M x 4-seed runs through
    ``run_exact_headline`` on the card, each with the launch counters
    zeroed just before; then the 100k partitioned config through the
    sparse kernel, whose per-seed statistics must equal the dense
    run's."""
    from corrosion_tpu_torch.sim.calibrate import run_exact_headline

    (dense, dense_seeds), (sparse, sparse_seeds) = exact_cfgs()
    runs = {}
    for label, cfg, seeds, kernel in (
        ("dense_100k", dense, dense_seeds, "dense"),
        ("sparse_1m", sparse, sparse_seeds, "sparse"),
        ("sparse_100k", dense, dense_seeds, "sparse"),
    ):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_exact_headline(cfg, n_seeds=seeds, seed=0, kernel=kernel,
                                 device="cuda")
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t0
        res["launches"] = {name: counted[name].launches
                           for name in EXACT_COUNTED}
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        runs[label] = res
        print(f"exact {label}: " + json.dumps({k: res[k] for k in (
            "converged_frac", "ticks_p50", "ticks_p99",
            "msgs_per_node_mean", "msgs_per_node_p99", "seed_batch",
            "budget_bytes", "budget_source", "wall_s", "peak_mem_gb",
            "rejection", "launches")}), flush=True)
        if res["converged_frac"] != 1.0:
            fail(f"exact {label} did not converge: {res}")
        idle = [n for n, c in res["launches"].items() if c == 0]
        if idle:
            fail(f"exact {label}: kernels never launched: {idle}")
    for key in ("seed_ticks", "seed_msgs_mean", "seed_msgs_p99"):
        if runs["dense_100k"][key] != runs["sparse_100k"][key]:
            fail(f"dense and sparse differ at 100k in {key}")
    return runs


# card against CPU at 1024 nodes: tests/test_frontier.py's headline
# shape (ring0 64, loss, partition healing at tick 3, sync every 2
# ticks, backoff 0.5) and the scenario families
UNPARTITIONED = dict(partition_blocks=1, heal_tick=0)
EXACT_VARIANTS = {
    "headline": {},
    "het_ring": dict(topology="het_ring", **UNPARTITIONED),
    "wan_two_region": dict(topology="wan_two_region", **UNPARTITIONED),
    "measured_ring": dict(topology="measured_ring",
                          rtt_tier_weights=(0, 0, 2, 2, 6, 1),
                          **UNPARTITIONED),
    "wan_latency": dict(topology="wan_two_region", wan_latency_ticks=3,
                        **UNPARTITIONED),
}


def exact_equal(cfg, seeds: int, sparse: bool, dev, label: str) -> dict:
    """The exact kernels on the card equal the plain versions on the CPU
    tick by tick (every leaf, bitmap or ring, and the tick statistics)
    until every seed has converged, and in ``run_exact_headline``."""
    from corrosion_tpu_torch.convert import exact_state_to_numpy
    from corrosion_tpu_torch.kernels.tick_stats import CONVERGED, tick_stats
    from corrosion_tpu_torch.random import fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    gpu, base = exact_state_at(cfg, seeds, 0, sparse, dev)
    cpu, _ = exact_state_at(cfg, seeds, 0, sparse, "cpu")
    tick_fn = cal.frontier_exact_tick if sparse else cal.packed_exact_tick
    while gpu.tick < cfg.max_ticks:
        keys = [fold_in(k, gpu.tick) for k in base]
        gpu, cpu = tick_fn(gpu, keys, cfg), tick_fn(cpu, keys, cfg)
        a, b = exact_state_to_numpy(gpu), exact_state_to_numpy(cpu)
        for f in a:
            if not np.array_equal(a[f], b[f]):
                fail(f"{label}: card and CPU differ in {f} at tick "
                     f"{gpu.tick}")
        st = [tick_stats(s.infected, None, s.msgs.reshape(-1), None,
                         seeds).cpu() for s in (gpu, cpu)]
        if not torch.equal(torch.nan_to_num(st[0]), torch.nan_to_num(st[1])):
            fail(f"{label}: tick stats differ at tick {gpu.tick}")
        if bool((st[1][:, CONVERGED] == 1.0).all()):
            break
    kernel = "sparse" if sparse else "dense"
    runs = [cal.run_exact_headline(cfg, n_seeds=seeds, kernel=kernel,
                                   device=d) for d in (dev, "cpu")]
    for r in runs:
        for k in ("wall_s", "budget_bytes", "budget_source"):
            r.pop(k)
    if runs[0] != runs[1]:
        fail(f"{label}: run stats differ:\ncard {runs[0]}\ncpu  {runs[1]}")
    return {"ticks_compared": gpu.tick, "stats": runs[0]}


# -- anti-entropy (config #4) and SWIM churn (config #2) ------------------

# the reference's numbers on the CPU (seed 0): config #4 at 10k x 32
# seeds, config #2 at 64 nodes, and the 4096-node churn cycle, whose
# detection does not finish in the reference either
CONFIG4_WANT = dict(converged_frac=1.0, ticks_p50=32.0, ticks_p99=37.0,
                    msgs_per_node_mean=73.22553253173828, ticks_run=40)
CONFIG2_WANT = dict(detect_latency=15, rejoin_latency=4,
                    msgs_per_node_per_tick=4.982421875, ticks_run=64)
CHURN4096_WANT = dict(detect_latency=None, rejoin_latency=None,
                      msgs_per_node_per_tick=4.999860763549805,
                      ticks_run=128)
AE_TICKS = (1, 20)  # phase 8's anti-entropy ticks
# phase 8's SWIM clusters; the last is timed
SWIM_SIZES = (64, 1000, 1003, 4096)
# swim_probe_select timed alone and the dissemination's costs (and the
# parent's)
SWIM_TURNS = (64, 4096)
# gossip widths of the crafted-tie checks: one selection pass of the
# kernel, and two and three passes
SWIM_TIE_ENTRIES = (8, 12, 20)
# the crafted ordering state's clusters and its variants
# (tests/test_torch_swim.py's ordering cases)
ORDERING_SIZES = (16, 4096)
ORDERING_VARIANTS = {"": {}, "_loss_0.15": dict(loss=0.15),
                     "_no_gossip_targets": dict(gossip_targets=0),
                     "_entries_12": dict(gossip_entries=12)}
# a cluster whose dissemination has more entries (N x M) than the card
# holds threads at once
WIDE_SWIM = (16384, 20)
SWIM_KERNELS = ("swim_probe_select", "swim_disseminate", "swim_settle")


def ae_state_at(cfg, seeds: int, tick: int, dev):
    """Config ``cfg``'s seed-flattened carry after ``tick`` ticks of
    ``run_anti_entropy_seeds(seed=0)``, reached through the port on
    ``dev``."""
    from corrosion_tpu_torch.models.sync import seq_sync_step
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import antientropy as ae

    flat = replace(cfg, n_universes=seeds)
    bits, msgs = ae.anti_entropy_init(flat, device=dev)
    for t in range(tick):
        bits, msgs = seq_sync_step(bits, msgs, fold_in(PRNGKey(0), t),
                                   flat.params)
    return flat, bits, msgs


def seq_sync_checks(dev) -> list:
    """Phase 8a: ``seq_sync`` and ``seq_stats`` against their plain
    versions at config #4's full width (10k x 32 seeds) on the inputs
    of ticks ``AE_TICKS``, timed at the last (each call behind a
    GPU-side sleep, so the host's enqueue stays out of the time)."""
    from corrosion_tpu_torch.kernels import seq_sync as ks
    from corrosion_tpu_torch.random import (
        PRNGKey,
        fold_in,
        key_words,
        randint_span,
        split,
    )
    from corrosion_tpu_torch.sim.antientropy import CONFIG4, CONFIG4_SEEDS

    err_sync = err_stats = 0.0
    for tick in AE_TICKS:
        flat, bits, msgs = ae_state_at(CONFIG4, CONFIG4_SEEDS, tick - 1, dev)
        p = flat.params
        k_peers, k_drop = split(fold_in(PRNGKey(0), tick - 1))
        peer_keys = tuple(key_words(k) for k in split(k_peers))
        span, mult = randint_span(1, p.universe)
        args = (bits, msgs, peer_keys, key_words(k_drop), p.universe, span,
                mult)
        kw = dict(peers_per_round=p.peers_per_round,
                  seqs_per_chunk=p.seqs_per_chunk,
                  chunk_budget=p.chunk_budget, loss=p.loss,
                  handshake_msgs=p.handshake_msgs)
        got = ks.seq_sync(*args, **kw)
        want = ks.seq_sync_plain(*args, **kw)
        err_sync = max(err_sync, max_abs_err(got, want))
        s_got = ks.seq_stats(got[0], got[1], CONFIG4_SEEDS)
        s_want = ks.seq_stats_plain(got[0], got[1], CONFIG4_SEEDS,
                                    torch.empty_like(s_got))
        err_stats = max(err_stats, max_abs_err([s_got], [s_want]))
    # the kernel's other paths on random bitmaps: byte loads (S % 16 !=
    # 0), two 64-bit masks, several peers, lost chunks, budget cuts
    g = torch.Generator().manual_seed(3)
    for seqs, peers, budget, spc, loss in ((40, 3, 2, 4, 0.3),
                                           (128, 2, 32, 3, 0.5),
                                           (100, 1, 5, 8, 0.15)):
        n_small = 2000
        rb = (torch.rand((n_small, seqs), generator=g) < 0.4).to(dev)
        rm = torch.randint(0, 50, (n_small,), generator=g,
                           dtype=torch.int32).to(dev)
        span_s, mult_s = randint_span(1, 500)
        sargs = (rb, rm, peer_keys, key_words(k_drop), 500, span_s, mult_s)
        skw = dict(peers_per_round=peers, seqs_per_chunk=spc,
                   chunk_budget=budget, loss=loss, handshake_msgs=3)
        err_sync = max(err_sync, max_abs_err(
            ks.seq_sync(*sargs, **skw), ks.seq_sync_plain(*sargs, **skw)))
        s_got = ks.seq_stats(rb, rm, 4)
        err_stats = max(err_stats, max_abs_err(
            [s_got], [ks.seq_stats_plain(rb, rm, 4, torch.empty_like(s_got))]))
    if err_sync != 0.0 or err_stats != 0.0:
        fail(f"seq_sync / seq_stats differ from their plain versions "
             f"(max |diff| {err_sync}, {err_stats})")
    n, seqs = bits.shape
    s_got = ks.seq_stats(got[0], got[1], CONFIG4_SEEDS)
    out = torch.empty_like(s_got)
    shape = (f"{CONFIG4_SEEDS} seeds x {CONFIG4.n_nodes}, {seqs} seqs, "
             f"tick {AE_TICKS[-1]}")
    res = [
        dict(name="seq_sync", route="cuda",
             source="corrosion_tpu_torch/kernels/csrc/seq_sync.cu",
             replaces="corrosion_tpu/models/sync.py:167",
             max_abs_err=err_sync,
             ms=time_inplace_ms(lambda: None,
                                lambda: ks.seq_sync(*args, **kw), 20),
             plain_ms=time_ms(lambda: ks.seq_sync_plain(*args, **kw), 3),
             # own row, one peer row per draw, the written row; msgs read
             # and written
             bound=(n * seqs * (2 + p.peers_per_round) + 8 * n, 0),
             library_ms=None, shape=shape),
        dict(name="seq_stats", route="cuda",
             source="corrosion_tpu_torch/kernels/csrc/seq_sync.cu",
             replaces="corrosion_tpu/sim/antientropy.py:77",
             max_abs_err=err_stats,
             ms=time_inplace_ms(lambda: None, lambda: ks.seq_stats(
                 got[0], got[1], CONFIG4_SEEDS, out=out), 20),
             plain_ms=time_ms(lambda: ks.seq_stats_plain(
                 got[0], got[1], CONFIG4_SEEDS, out), 3),
             bound=(nbytes(got[0], got[1], out), 0),
             library_ms=None, shape=shape),
    ]
    for r in res:
        set_bound(r)
    return res


def churn_state_at(cfg, tick: int, dev, **overrides):
    """``run_churn(cfg)``'s state before tick ``tick`` (through the port
    on ``dev``, ``cfg.params`` with ``overrides``), the params, and the
    tick's (key, alive, revived, victim)."""
    from corrosion_tpu_torch.models.swim import swim_init, swim_step
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim.churn import _schedule

    params = replace(cfg.params, **overrides)

    def inputs(t):
        victim, dead, rev = _schedule(cfg, t)
        alive = torch.ones(cfg.n_nodes, dtype=torch.bool, device=dev)
        revived = torch.zeros(cfg.n_nodes, dtype=torch.bool, device=dev)
        alive[victim] = not dead
        revived[victim] = rev
        return fold_in(PRNGKey(0), t), alive, revived, victim

    state = swim_init(cfg.n_nodes, device=dev)
    for t in range(tick):
        key, alive, revived, _ = inputs(t)
        state = swim_step(state, key, t, params, alive, revived=revived)
    return state, params, inputs(tick)


def crafted_tie_state(n: int):
    """A state whose update_tx + uniform scores tie in most entries
    (update_tx at 2**24 and 2**24 + 2, a limit far above): the selection
    must break ties by the lower index first."""
    from corrosion_tpu_torch.models.swim import SwimState

    g = torch.Generator().manual_seed(11)
    base = 2**24
    return SwimState(
        view=torch.randint(0, 3, (n, n), generator=g, dtype=torch.int32),
        suspect_since=torch.full((n, n), 2**31 - 1, dtype=torch.int32),
        incarnation=torch.zeros(n, dtype=torch.int32),
        msgs=torch.zeros(n, dtype=torch.int32),
        update_tx=base + 2 * torch.randint(0, 2, (n, n), generator=g,
                                           dtype=torch.int32),
    )


def crafted_ordering_state(n: int, seed: int = 5):
    """Records that differ widely from row to row (incarnations 0..63,
    ALIVE or DOWN), so that the gossip pass raises entries that probers
    then select and the ping and ack passes must read the view as the
    pass before left it (tests/test_torch_swim.py ``ordering_state``)."""
    from corrosion_tpu_torch.models.swim import SwimState

    rng = np.random.default_rng(seed)
    view = (4 * rng.integers(0, 64, (n, n))
            + 2 * rng.integers(0, 2, (n, n))).astype(np.int32)
    inc = rng.integers(0, 64, n).astype(np.int32)
    view[np.arange(n), np.arange(n)] = 4 * inc
    return SwimState(
        view=torch.from_numpy(view),
        suspect_since=torch.full((n, n), 2**31 - 1, dtype=torch.int32),
        incarnation=torch.from_numpy(inc),
        msgs=torch.zeros(n, dtype=torch.int32),
        update_tx=torch.from_numpy(
            rng.integers(0, 3, (n, n)).astype(np.int32)),
    )


def rows_at_limit(state, limit: int):
    """``state`` with every third row's update_tx at the retransmission
    limit and every seventh (from row 1) past it: those rows score all
    +inf, so their lowest indices are taken, none sendable."""
    tx = state.update_tx.clone()
    tx[::3] = limit
    tx[1::7] = limit + 5
    return state._replace(update_tx=tx)


def revive_probed(ksw, n: int, tick: int):
    """A tick key and a victim under which the node the reviving victim
    announces to also probes it (its announce lands in the probed
    cell): the first of fold_in(PRNGKey(100 + s), tick), s = 0, 1, ...,
    with such a victim, and its lowest."""
    from corrosion_tpu_torch.kernels.threefry import threefry_bits_plain
    from corrosion_tpu_torch.models.common import peers_from_offsets
    from corrosion_tpu_torch.random import PRNGKey, fold_in, randint_span

    span, mult = randint_span(1, max(n, 2))
    rows = torch.arange(n)

    def peers(keys, name):
        offs = torch.empty(n, dtype=torch.int32)
        threefry_bits_plain(offs, *keys[name], span=span, mult=mult,
                            minval=1)
        return peers_from_offsets(offs, n).long()

    for s in range(64):
        key = fold_in(PRNGKey(100 + s), tick)
        keys = ksw.tick_keys(key)
        hit = (peers(keys, "probe")[peers(keys, "ann")] == rows).nonzero()
        if len(hit):
            return key, int(hit[0])
    fail(f"no key of 64 has a revived node probed by its seed at N = {n}")


def swim_case(ksw, state, key, tick, params, alive, revived=None,
              victim=None) -> dict:
    """One tick through the kernels and through the plain version on
    the same inputs: every leaf (and the victim counters when a victim
    is given) bitwise."""
    from corrosion_tpu_torch.models.swim import SwimState

    names, got, want = list(SwimState._fields), [], []
    fa = fb = None
    if victim is not None:
        fa = torch.zeros(2, dtype=torch.int32, device=state.view.device)
        fb = torch.zeros_like(fa)
        names.append("flags")
    keys = ksw.tick_keys(key)
    got = [*ksw.swim_tick(*state, key, tick, params, alive, revived,
                          victim=victim, flags=fa)]
    want = [*ksw.swim_tick_plain(*state, keys, tick, params, alive, revived,
                                 victim, fb)]
    if victim is not None:
        got.append(fa)
        want.append(fb)
    # the dissemination alone, on the kernels' own selection
    launch = ksw.prepare(*state, keys, tick, params, alive, revived)
    ksw.swim_probe_select(launch)
    w = launch.work
    probe = w["probe"]
    plain = ksw.swim_disseminate_plain(
        launch.out[0].clone(), w["ge"].long(), w["sendable"].bool(),
        w["target"].long(), (probe & 1).bool(), (probe & 2).bool(), alive,
        keys, params)
    ksw.swim_disseminate(launch, params.gossip_targets > 0)
    names.append("disseminate")
    got.append(launch.out[0])
    want.append(plain)
    return dict(max_abs_err=max_abs_err(got, want),
                differs=[f for f, x, y in zip(names, got, want)
                         if not torch.equal(x, y)],
                **({} if fa is None else {"flags": fa.tolist()}))


def probe_select_turns(ksw, parent, state, key, tick, params, alive,
                       revived) -> dict:
    """``swim_probe_select`` alone on one tick's inputs (device ms a
    launch, 20 behind a GPU-side sleep) and, when ``parent`` is given,
    the parent's in turns; the two must write the same view row, msgs,
    probe work and selection."""
    keys = ksw.tick_keys(key)
    mine = ksw.prepare(*state, keys, tick, params, alive, revived)
    ksw.swim_probe_select(mine)
    old = None
    if parent is not None:
        prev = ksw.prepare(*state, keys, tick, params, alive, revived)
        parent.swim_probe_select(prev)
        names = ["view", "msgs", *mine.work]
        bad = [f for f, x, y in zip(
            names, [mine.out[0], mine.out[3], *mine.work.values()],
            [prev.out[0], prev.out[3], *prev.work.values()])
            if not torch.equal(x, y)]
        if bad:
            fail(f"swim_probe_select differs from the parent's at N = "
                 f"{state.view.shape[0]}, tick {tick}: {bad}")

        def old():
            parent.swim_probe_select(prev)
    return in_turns(lambda: ksw.swim_probe_select(mine), old,
                    lambda fn: time_device_ms(fn, 20))


def swim_kernel_checks(dev, parent=None):
    """Phase 8b: the SWIM kernels against their plain version on the
    card, every leaf and the victim counters bitwise, and
    ``swim_disseminate`` against ``swim_disseminate_plain`` on the
    kernels' own selection (``swim_case``), at N = 64, 1000, 1003 (no
    multiple of 4: rows of both 16-byte alignments, a scalar head and
    tail) and 4096: a tick during suspicion, that tick with whole rows
    at and past the retransmission limit (all +inf, the lowest indices
    taken), the revive tick, the revive tick under a key whose victim
    is probed by the node it announces to, a loss = 0.15 run, a run
    without gossip targets (no gossip pass) and a crafted-tie state at
    one selection pass of gossip entries (``MAX_ENTRIES``) and at two
    and three passes (12, 20); at N = 5 with 9 gossip entries (m = n)
    the suspicion and revive ticks; the crafted ordering state at
    ``ORDERING_SIZES`` in ``ORDERING_VARIANTS``; and ``WIDE_SWIM``'s
    suspicion tick.  Each kernel timed at N = 4096's suspicion tick
    (CUDA events around each call, the host's enqueue hidden behind a
    GPU-side sleep), ``swim_probe_select`` alone at N = 64's and
    4096's and the dissemination's costs there (``swim_costs``),
    against the parent's in turns when given."""
    from corrosion_tpu_torch.kernels import swim as ksw
    from corrosion_tpu_torch.models.swim import SwimState
    from corrosion_tpu_torch.sim.churn import ChurnConfig

    checks, timed, turns, costs = [], None, {}, {}
    for n in SWIM_SIZES:
        cfg = ChurnConfig(n_nodes=n)
        cases = [("suspicion", cfg.kill_tick + 3, {}),
                 ("revive", cfg.revive_tick, {}),
                 ("loss_0.15", cfg.kill_tick + 6, dict(loss=0.15)),
                 ("no_gossip_targets", cfg.kill_tick + 3,
                  dict(gossip_targets=0))]
        for label, tick, overrides in cases:
            state, params, (key, alive, revived, victim) = churn_state_at(
                cfg, tick, dev, **overrides)
            checks.append(dict(n=n, case=label, tick=tick, **swim_case(
                ksw, state, key, tick, params, alive, revived, victim)))
            if label != "suspicion":
                continue
            if n in SWIM_TURNS:
                turns[n] = probe_select_turns(ksw, parent, state, key, tick,
                                              params, alive, revived)
                costs[n] = swim_costs(ksw, parent, state, key, tick, params,
                                      alive, revived)
            if n == SWIM_SIZES[-1]:
                timed = swim_times(ksw, state, key, tick, params, alive,
                                   revived)
            limited = rows_at_limit(state, params.update_tx_limit)
            checks.append(dict(n=n, case="rows_at_limit", tick=tick,
                               **swim_case(ksw, limited, key, tick, params,
                                           alive, revived, victim)))
            launch = ksw.prepare(*limited, ksw.tick_keys(key), tick, params,
                                 alive, revived)
            ksw.swim_probe_select(launch)
            ge, sendable = launch.work["ge"], launch.work["sendable"]
            lowest = torch.arange(ge.shape[1], dtype=torch.int32,
                                  device=dev).expand(ge[::3].shape)
            if not torch.equal(ge[::3], lowest) or bool(sendable[::3].any()):
                fail(f"rows at the limit at N = {n} did not take their "
                     "lowest indices unsendable")
        key, victim = revive_probed(ksw, n, cfg.revive_tick)
        state, params, (_, alive, revived, victim) = churn_state_at(
            replace(cfg, victim=victim), cfg.revive_tick, dev)
        checks.append(dict(n=n, case="revive_probed", tick=cfg.revive_tick,
                           victim=victim, **swim_case(
                               ksw, state, key, cfg.revive_tick, params,
                               alive, revived, victim)))
        tie = SwimState(*(t.to(dev) for t in crafted_tie_state(n)))
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        for entries in SWIM_TIE_ENTRIES:
            params = replace(cfg.params, update_tx_limit=2**30, loss=0.15,
                             gossip_entries=entries)
            checks.append(dict(n=n, case=f"crafted_ties_{entries}", tick=3,
                               **swim_case(ksw, tie, key, 3, params,
                                           alive)))
    small = ChurnConfig(n_nodes=5)
    for label, tick in (("m_eq_n_suspicion", small.kill_tick + 3),
                        ("m_eq_n_revive", small.revive_tick)):
        state, params, (key, alive, revived, victim) = churn_state_at(
            small, tick, dev, gossip_entries=9)
        checks.append(dict(n=5, case=label, tick=tick, **swim_case(
            ksw, state, key, tick, params, alive, revived, victim)))
    from corrosion_tpu_torch.models.swim import SwimParams
    from corrosion_tpu_torch.random import PRNGKey, fold_in

    for n in ORDERING_SIZES:
        state = SwimState(*(t.to(dev) for t in crafted_ordering_state(n)))
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        for label, kw in ORDERING_VARIANTS.items():
            for tick in (0, 1):
                checks.append(dict(n=n, case=f"ordering{label}", tick=tick,
                                   **swim_case(
                                       ksw, state, fold_in(PRNGKey(0), tick),
                                       tick, SwimParams(n_nodes=n, **kw),
                                       alive)))
    n, entries = WIDE_SWIM
    cfg = ChurnConfig(n_nodes=n)
    tick = cfg.kill_tick + 3
    state, params, (key, alive, revived, victim) = churn_state_at(
        cfg, tick, dev, gossip_entries=entries)
    checks.append(dict(n=n, case=f"suspicion_entries_{entries}", tick=tick,
                       **swim_case(ksw, state, key, tick, params, alive,
                                   revived, victim)))
    del state
    for c in checks:
        if c["max_abs_err"] != 0.0 or c["differs"]:
            fail(f"swim kernels differ from their plain version: {c}")
    timed["probe_select_turns"] = turns
    timed["costs"] = costs
    n = SWIM_SIZES[-1]
    timed["swim_disseminate"].update(library_ms=costs[n]["library"]["ms"],
                                     plain_ms=costs[n]["plain_ms"])
    err = max(c["max_abs_err"] for c in checks)
    res = []
    for name, line in (("swim_probe_select", 108), ("swim_disseminate", 226),
                       ("swim_settle", 277)):
        t = timed[name]
        res.append(dict(
            name=name, route="cuda",
            source="corrosion_tpu_torch/kernels/csrc/swim.cu",
            replaces=f"corrosion_tpu/models/swim.py:{line}",
            max_abs_err=err, ms=t["ms"],
            plain_ms=t.get("plain_ms", timed["plain_ms"]),
            bound=t["bound"], library_ms=t.get("library_ms"),
            shape=f"N = {n}, tick {ChurnConfig(n_nodes=n).kill_tick + 3}; "
                  "plain_ms is the whole tick's but swim_disseminate's"))
        set_bound(res[-1])
    return res, checks, timed


def swim_times(ksw, state, key, tick, params, alive, revived,
               reps: int = 10) -> dict:
    """Device ms of each host call's kernels (mean over ``reps`` ticks on
    the same inputs, an event between two calls), the whole tick's ms
    and the plain version's, with each call's bound from this tick's
    data (bytes, integer operations)."""
    n = state.view.shape[0]
    keys = ksw.tick_keys(key)
    order = ksw.launch_order(params.gossip_targets)
    names = [fn.__name__ for fn, _ in order]
    per = dict.fromkeys(SWIM_KERNELS, 0.0)
    tick_ms = 0.0
    for r in range(reps + 1):
        launch = ksw.prepare(*state, keys, tick, params, alive, revived)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(order) + 1)]
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)  # covers the enqueues
        events[0].record()
        for (fn, extra), ev in zip(order, events[1:]):
            fn(launch, *extra)
            ev.record()
        torch.cuda.synchronize()
        if r == 0:
            continue  # warm
        for name, a, b in zip(names, events, events[1:]):
            per[name] += a.elapsed_time(b) / reps
        tick_ms += events[0].elapsed_time(events[-1]) / reps
    plain_ms = time_ms(lambda: ksw.swim_tick_plain(
        *state, keys, tick, params, alive, revived), 3)

    # what this tick's data makes each kernel move
    w = launch.work
    mat = 4 * n * n  # one [N, N] int32 leaf
    entries = w["ge"].numel()
    cells = dissemination_cells(ksw, launch, keys, params, alive)
    scatters = {p: int((cells[p] != n * n).sum())  # cells each pass
                for p in ("gossip", "ping", "ack") if p in cells}
    hashed = int((state.update_tx < params.update_tx_limit).sum())
    suspect = int((state.view % 4 == ksw.SUSPECT).sum())
    bounds = {
        # view and update_tx read, the view written, a sector of
        # suspect_since for each suspect cell, the selection written; a
        # tie uniform for each cell under the retransmission limit
        "swim_probe_select": (3 * mat + suspect * SECTOR + entries * 9,
                              hashed * INT_OPS_PER_UNIFORM),
        # the selection (ge, sendable, pay) and each node's target,
        # probe flags and live flag read once, a sector for each cell a
        # pass scatters into; the passes' payloads are the selection's
        # and what the passes before them scattered, so no view read
        "swim_disseminate": (entries * 9 + n * 6
                             + sum(scatters.values()) * SECTOR, 0),
        # the tick's and the input view, suspect_since and update_tx
        # read, suspect_since and update_tx written, the selection read
        "swim_settle": (6 * mat + entries * 5, 0),
    }
    return {
        **{name: dict(ms=per[name], bound=bounds[name]) for name in names},
        "tick_ms": tick_ms, "plain_ms": plain_ms, "scatters": scatters,
        "suspect_cells": suspect, "hashed_cells": hashed,
    }


def dissemination_cells(ksw, launch, keys, params, alive) -> dict:
    """The flat cells of a tick's dissemination as PyTorch calls, on the
    selection ``swim_probe_select`` left in ``launch.work``: each pass's
    scattered cells (``n * n``, one past the view, for a dropped leg),
    the gossip payload, and the cells each gather reads (the rows'
    entries for the ping, the targets' entries for the ack)."""
    w = launch.work
    n, m = w["ge"].shape
    dev = w["ge"].device
    ge, sendable = w["ge"].long(), w["sendable"].bool()
    target, probe = w["target"].long(), w["probe"].long()
    rows = torch.arange(n, device=dev)[:, None]
    drop = n * n
    out = {}
    g = params.gossip_targets
    if g > 0:
        gt = ksw.rand_peers(keys, "gt", (n, g), n, dev)
        ok = (alive[:, None, None] & alive[gt][:, :, None]
              & sendable[:, None, :]
              & ksw.surviving_legs(keys, "gloss", (n, g, m), params.loss,
                                   dev))
        out["gossip"] = torch.where(ok, gt[:, :, None] * n + ge[:, None, :],
                                    drop).reshape(-1)
        out["gossip_pay"] = w["pay"][:, None, :].expand(n, g, m).reshape(-1)
    out["ping_src"] = (rows * n + ge).reshape(-1)
    out["ping"] = torch.where((probe[:, None] & 1).bool() & sendable,
                              target[:, None] * n + ge, drop).reshape(-1)
    ge_t = ge[target]
    out["ack_src"] = (target[:, None] * n + ge_t).reshape(-1)
    out["ack"] = torch.where((probe[:, None] & 2).bool() & sendable[target],
                             rows * n + ge_t, drop).reshape(-1)
    return out


def library_calls(cells: dict, flat: torch.Tensor) -> list:
    """The dissemination as PyTorch calls on ``flat`` (the view, flat,
    and one cell past it): ``scatter_reduce_`` of the gossip payload
    (with gossip targets), ``torch.gather`` of the rows' entries,
    ``scatter_reduce_`` of them (the ping), ``torch.gather`` of the
    targets' entries, ``scatter_reduce_`` of those (the ack).  Returns
    the calls, to be run in order."""
    calls = []
    if "gossip" in cells:
        calls.append(lambda: flat.scatter_reduce_(
            0, cells["gossip"], cells["gossip_pay"], reduce="amax"))
    held = {}
    for name in ("ping", "ack"):
        calls.append(lambda name=name: held.__setitem__(
            name, torch.gather(flat, 0, cells[f"{name}_src"])))
        calls.append(lambda name=name: flat.scatter_reduce_(
            0, cells[name], held[name], reduce="amax"))
    return calls


def swim_costs(ksw, parent, state, key, tick, params, alive, revived,
               reps: int = 20) -> dict:
    """What a tick's dissemination costs on one tick's inputs: the
    host's time to enqueue a tick (``prepare``, then every call of
    ``launch_order``; the device asleep behind a GPU-side sleep, which
    must outlast it), the dissemination's device ms between two events
    (mean over ``reps`` ticks behind a GPU-side sleep; the parent's in
    turns when given) and the whole tick's, and the dissemination as
    PyTorch calls (``library_calls``), each call's ms and their sum,
    which must leave the kernels' view."""
    from time import perf_counter

    n = state.view.shape[0]
    keys = ksw.tick_keys(key)
    order = ksw.launch_order(params.gossip_targets)
    middle = order[1:-1]
    args = (*state, keys, tick, params, alive, revived)

    # the host's enqueue, the device asleep (a tick run first, so every
    # library and function is loaded)
    launch = ksw.prepare(*args)
    for fn, extra in order:
        fn(launch, *extra)
    prep_us, call_us = [], []
    for r in range(reps + 1):
        torch.cuda.synchronize()
        torch.cuda._sleep(10 * SLEEP_CYCLES)
        t0 = perf_counter()
        launch = ksw.prepare(*args)
        t1 = perf_counter()
        for fn, extra in order:
            fn(launch, *extra)
        t2 = perf_counter()
        done = torch.cuda.Event()
        done.record()
        if done.query():
            fail("swim_costs: the device woke before the tick was "
                 "enqueued")
        if r:
            prep_us.append((t1 - t0) * 1e6)
            call_us.append((t2 - t1) * 1e6)
    torch.cuda.synchronize()

    def windows(disseminate) -> tuple:
        """Mean device ms of ``disseminate`` between two events, and of
        the whole tick with no event inside it."""
        out = []
        for inner in (True, False):
            launches = [ksw.prepare(*args) for _ in range(reps + 1)]
            ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  for _ in launches]
            torch.cuda.synchronize()
            torch.cuda._sleep(SLEEP_CYCLES * (1 + reps // 4))
            for launch, (e0, e1) in zip(launches, ev):
                if not inner:
                    e0.record()
                ksw.swim_probe_select(launch)
                if inner:
                    e0.record()
                disseminate(launch)
                if inner:
                    e1.record()
                ksw.swim_settle(launch)
                if not inner:
                    e1.record()
            torch.cuda.synchronize()
            out.append(sum(e0.elapsed_time(e1) for e0, e1 in ev[1:]) / reps)
        return tuple(out)

    def mine(launch):
        for fn, extra in middle:
            fn(launch, *extra)

    tick_ms = []

    def timer(fn):
        d, t = windows(fn)
        tick_ms.append(t)
        return d

    old = None
    if parent is not None:
        def old(launch):
            parent.swim_disseminate(launch, params.gossip_targets > 0)
    turns = in_turns(mine, old, timer)

    # the PyTorch calls on the kernels' selection, held to their view
    launch = ksw.prepare(*args)
    ksw.swim_probe_select(launch)
    cells = dissemination_cells(ksw, launch, keys, params, alive)
    flat = torch.empty(n * n + 1, dtype=torch.int32, device=alive.device)
    flat[:-1] = launch.out[0].reshape(-1)
    w = launch.work
    view0 = launch.out[0].clone()
    plain_ms = time_ms(lambda: ksw.swim_disseminate_plain(
        view0, w["ge"].long(), w["sendable"].bool(), w["target"].long(),
        (w["probe"] & 1).bool(), (w["probe"] & 2).bool(), alive, keys,
        params), 3)
    mine(launch)
    calls = library_calls(cells, flat)
    for call in calls:
        call()
    if not torch.equal(flat[:-1], launch.out[0].reshape(-1)):
        fail(f"the dissemination's PyTorch calls differ from the kernels' "
             f"view at N = {n}")
    call_ms = [0.0] * len(calls)
    for r in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(calls) + 1)]
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        ev[0].record()
        for call, e in zip(calls, ev[1:]):
            call()
            e.record()
        torch.cuda.synchronize()
        if r:
            for q in range(len(calls)):
                call_ms[q] += ev[q].elapsed_time(ev[q + 1]) / reps
    return {"n": n, "host_calls": len(order),
            "enqueue_us": {"prepare": sorted(prep_us),
                           "calls": sorted(call_us)},
            "dissemination": turns, "tick_ms": tick_ms, "plain_ms": plain_ms,
            "library": {"calls_ms": call_ms, "ms": sum(call_ms)}}


def full_width_paths(counted) -> dict:
    """Phase 9: config #4 (10k x 32 seeds), config #2 (64 nodes) and the
    4096-node churn cycle through their entry points on the card, the
    launch counters zeroed just before each; each held to the
    reference's numbers."""
    from corrosion_tpu_torch.sim.antientropy import (
        CONFIG4,
        CONFIG4_SEEDS,
        run_anti_entropy_seeds,
    )
    from corrosion_tpu_torch.sim.churn import ChurnConfig, run_churn

    runs = {}
    for label, run, want, kernels_ in (
        ("config4", lambda: run_anti_entropy_seeds(
            CONFIG4, n_seeds=CONFIG4_SEEDS, seed=0, device="cuda"),
         CONFIG4_WANT, ("seq_sync", "seq_stats")),
        ("config2", lambda: run_churn(ChurnConfig(n_nodes=64), seed=0,
                                      device="cuda"),
         CONFIG2_WANT, SWIM_KERNELS),
        ("churn4096", lambda: run_churn(ChurnConfig(n_nodes=4096), seed=0,
                                        device="cuda"),
         CHURN4096_WANT, SWIM_KERNELS),
    ):
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t0
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["launches"] = {name: counted[name].launches
                           for name in kernels_}
        runs[label] = res
        print(f"{label}: " + json.dumps(res), flush=True)
        for k, v in want.items():
            ok = (res[k] == v if not isinstance(v, float)
                  else math.isclose(res[k], v, rel_tol=1e-6))
            if not ok:
                fail(f"{label}: {k} = {res[k]}, the reference gives {v}")
        idle = [name for name, c in res["launches"].items() if c == 0]
        if idle:
            fail(f"{label}: kernels never launched: {idle}")
    return runs


def ae_equal(cfg, seeds: int, dev, label: str) -> dict:
    """Anti-entropy on the card == the plain path on the CPU: carry and
    statistics every tick until every seed has converged, and the run's
    stats."""
    from corrosion_tpu_torch.kernels.seq_sync import CONVERGED, seq_stats
    from corrosion_tpu_torch.models.sync import seq_sync_step
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import antientropy as ae

    flat = replace(cfg, n_universes=seeds)
    gpu = ae.anti_entropy_init(flat, device=dev)
    cpu = ae.anti_entropy_init(flat, device="cpu")
    tick = 0
    while tick < cfg.max_ticks:
        key = fold_in(PRNGKey(0), tick)
        gpu = seq_sync_step(*gpu, key, flat.params)
        cpu = seq_sync_step(*cpu, key, flat.params)
        tick += 1
        for x, y in zip(gpu, cpu):
            if not torch.equal(x.cpu(), y):
                fail(f"{label}: card and CPU differ at tick {tick}")
        sg, sc = seq_stats(*gpu, seeds).cpu(), seq_stats(*cpu, seeds)
        if not torch.equal(sg, sc):
            fail(f"{label}: tick stats differ at tick {tick}")
        if bool((sc[:, CONVERGED] == 1.0).all()):
            break
    runs = [ae.run_anti_entropy_seeds(cfg, n_seeds=seeds, device=d)
            for d in (dev, "cpu")]
    for r in runs:
        r.pop("wall_s")
    if runs[0] != runs[1]:
        fail(f"{label}: stats differ:\ncard {runs[0]}\ncpu  {runs[1]}")
    return {"ticks_compared": tick, "stats": runs[0]}


def churn_equal(cfg, dev, label: str) -> dict:
    """SWIM on the card == the plain path on the CPU: every leaf and the
    detection flags every tick of ``run_churn_cycles``' schedule, and
    the run's stats."""
    from corrosion_tpu_torch.models.swim import swim_init
    from corrosion_tpu_torch.random import PRNGKey
    from corrosion_tpu_torch.sim import churn as ch

    total = cfg.cycles * cfg.cycle_period + cfg.cycle_period // 2
    total = -(-total // cfg.chunk_ticks) * cfg.chunk_ticks
    key = PRNGKey(0)
    gpu = swim_init(cfg.n_nodes, device=dev)
    cpu = swim_init(cfg.n_nodes, device="cpu")
    one = replace(cfg, chunk_ticks=1)
    for t in range(total):
        gpu, fg = ch._scan_chunk(gpu, key, t, one)
        cpu, fc = ch._scan_chunk(cpu, key, t, one)
        for f, x, y in zip(gpu._fields, gpu, cpu):
            if not torch.equal(x.cpu(), y):
                fail(f"{label}: card and CPU differ in {f} at tick {t}")
        if any((a != b).any() for a, b in zip(fg, fc)):
            fail(f"{label}: detection flags differ at tick {t}")
    runs = [ch.run_churn_cycles(cfg, device=d) for d in (dev, "cpu")]
    for r in runs:
        r.pop("wall_s")
    if runs[0] != runs[1]:
        fail(f"{label}: stats differ:\ncard {runs[0]}\ncpu  {runs[1]}")
    return {"ticks_compared": total, "stats": runs[0]}


# -- the exact sent_to sampler (calibration and track_sent) ---------------

SENT_SOURCE = "corrosion_tpu_torch/kernels/csrc/sent_sampler.cu"
SENT_KERNELS = ("sent_select", "sent_commit")
# CALIB_MSGS.json's points, which the reference reproduces digit for digit
CALIB_WANT = [
    dict(n=1000, msgs_exact=10.04, msgs_perm=6.26, exact_over_perm=1.604,
         exact_converged_ticks=[7, 7, 7], perm_ticks_p50=6.0, seeds=3),
    dict(n=4000, msgs_exact=10.6, msgs_perm=6.8, exact_over_perm=1.558,
         exact_converged_ticks=[8, 8, 8], perm_ticks_p50=7.0, seeds=3),
    dict(n=16000, msgs_exact=12.41, msgs_perm=7.34, exact_over_perm=1.69,
         exact_converged_ticks=[10, 9, 9], perm_ticks_p50=8.0, seeds=3),
]
# SIMDIFF_N64/256/512.json's "sim" numbers (sim_trace, 8 seeds, no sync)
SIMDIFF_WANT = {
    64: dict(converged_frac=1.0, ticks_p50=6.0, ticks_p99=7.0,
             msgs_per_node_mean=4.53515625, hops_p50=3.0,
             hops_p99=4.921249866485596),
    256: dict(converged_frac=1.0, ticks_p50=12.0, ticks_p99=13.0,
              msgs_per_node_mean=6.9990234375, hops_p50=4.0, hops_p99=6.0),
    512: dict(converged_frac=1.0, ticks_p50=12.5, ticks_p99=14.0,
              msgs_per_node_mean=7.301513671875, hops_p50=4.125,
              hops_p99=6.875),
}
# sim_obs_trace's config (sync every 8 ticks, 16-tick chunks) at 512
# nodes x 8 seeds: the reference's numbers on the CPU (seed 0)
OBS512_WANT = dict(converged_frac=1.0, ticks_p50=8.0, ticks_p99=8.0,
                   msgs_per_node_mean=6.52197265625,
                   msgs_per_node_p99=10.361244201660156, hops_p50=4.125,
                   hops_p99=6.875, hops_broadcast_frac=0.9912109375)
SENT_CHECK_TICK = 4  # phase 11's broadcast tick: the partition holds
SENT_FAULTS = dict(loss=0.1, partition_blocks=2, heal_tick=8,
                   oneway_blocks=((0, 1),))


def sent_variants(n: int) -> dict:
    """The track_sent configs of phases 11 and 13 at ``n`` nodes:
    sim_trace's, two variants with 10% loss, a one-way partition in
    force until tick 8 and hops, on the WAN and the tiered topology,
    and sim_obs_trace's (sync every 8 ticks)."""
    from corrosion_tpu_torch.sim.epidemic import sent_trace_cfg

    base = sent_trace_cfg(n)
    return {
        "sim_trace": base,
        "wan_faults": replace(base, topology="wan_two_region",
                              **SENT_FAULTS),
        "het_ring_faults": replace(base, topology="het_ring",
                                   **SENT_FAULTS),
        "obs_sync": sent_trace_cfg(n, sync_interval=8, chunk_ticks=16),
    }


def clone_state(state):
    return type(state)(*(x.clone() if isinstance(x, torch.Tensor) else x
                         for x in state))


def calib_check_states(cfg, dev):
    """Seed 0 of ``run_exact(cfg)`` advanced on the card: the inputs of
    tick 1 and of the tick with the most active rows (clones)."""
    from corrosion_tpu_torch.kernels.sent_sampler import active_rows
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    key = PRNGKey(0)
    state = cal.exact_init(cfg, device=dev)
    picked, best = {}, (-1, None)
    while not bool(state.infected.all()) and state.tick < cfg.max_ticks:
        active = int(active_rows(state.tx, state.next_send, state.tick,
                                 state.infected).sum())
        if state.tick == 1:
            picked[1] = clone_state(state)
        if active > best[0]:
            best = (active, clone_state(state))
        state = cal.exact_tick(state, fold_in(key, state.tick), cfg)
    picked[best[1].tick] = best[1]
    return key, picked


def tied_rows(select) -> int:
    """Active rows of a calibration tick whose k + 1 smallest scores
    hold a tie (the order among equal scores decides a target)."""
    from corrosion_tpu_torch.kernels.sent_sampler import (
        active_rows,
        chunk_scores,
    )

    sent = select["sent"][0]
    keys = select["keys"][0].tolist()
    c, k = select["chunk"], select["fanout"]
    active = active_rows(select["tx"], select["next_send"], select["tick"],
                         select["infected"])[0]
    ties = 0
    for ck, start in enumerate(range(0, sent.shape[0], c)):
        sc = chunk_scores(sent[start:start + c], tuple(keys[ck]), start)
        v = torch.topk(sc, k + 1, dim=1, largest=False).values
        tie = ((v[:, 1:] == v[:, :-1]) & (v[:, 1:] < math.inf)).any(dim=1)
        ties += int((tie & active[start:start + c]).sum())
        del sc, v
    return ties


SENT_FANOUTS = range(1, 9)  # the k the kernel is built for
# calibration with chunk = N where a row's counters cross 2**32: (N,
# rows); row 65535 of 65537 splits at column 1, row 65472 of 65600 at
# column 4096
SENT_SPLIT_CASES = ((65_537, (0, 40_000, 65_535, 65_536)),
                    (65_600, (1, 65_472, 65_473)))


def sent_kernel_checks(dev, parent=None):
    """Phase 11: ``sent_select`` and ``sent_commit``, and the two from
    one ``sent_tick`` call, against their plain versions on the card at
    the main path's shapes, every output leaf bitwise (``sent``, the
    counts and the fresh buffers included), for every fanout k of 1..8,
    each in the row layout the kernel takes at its N (a block a row at
    16,000 and beyond, a warp a row at 512): calibration at
    ``ExactConfig(16000)`` seed 0, ticks 1 and the busiest tick (which
    must hold tied scores), and that tick with crafted rows that leave
    the filter fewer than k peers (the exact fallback); broadcast at
    512 nodes x 8 seeds on the sim_trace config (int32 and int64 keys)
    and two fault variants at a tick where the partition holds; rows
    whose counters cross 2**32 (``split_checks``).  With ``parent``
    (``ParentDesign``) ``sent_tick`` must also equal the parent's two
    calls in every case but the counter splits.  Times both kernels
    behind a GPU-side sleep, the pair and the commit in turns with the
    parent's, and the host's enqueue of a calibration tick
    (``sent_enqueue``)."""
    from corrosion_tpu_torch.kernels import sent_sampler as ss
    from corrosion_tpu_torch.models.broadcast import sent_inputs
    from corrosion_tpu_torch.random import PRNGKey, fold_in, split
    from corrosion_tpu_torch.sim import calibrate as cal
    from corrosion_tpu_torch.sim.epidemic import (
        _partition_ids,
        sent_seeds_init,
        sent_seeds_tick,
    )

    errs = {name: 0.0 for name in SENT_KERNELS}
    checks, timed = [], {}

    def compare(kernel, got, want, names):
        err = max_abs_err(got, want)
        errs[kernel] = max(errs[kernel], err)
        bad = [nm for nm, x, y in zip(names, got, want)
               if (x is None) != (y is None)
               or x is not None and not torch.equal(x, y)]
        return err, bad

    def run_pair(mode, select, commit):
        """The plain selection and the kernel on the same inputs, and
        the commit on the kernel's results."""
        sent_p = select["sent"].clone()
        want = ss.sent_select_plain(**{**select, "sent": sent_p})
        sel_names = (("new_infected", "counts") if mode == "calibration"
                     else ("new_rows", "cand", "counts"))
        sent_k = select["sent"].clone()
        got = ss.sent_select(**{**select, "sent": sent_k})
        err, bad = compare("sent_select", [*got, sent_k], [*want, sent_p],
                           [*sel_names, "sent"])
        del sent_k
        if mode == "calibration":
            extra = dict(new_infected=got[0])
        else:
            extra = dict(new_rows=got[0], cand=got[1])
        c_got = ss.sent_commit(got[-1], **extra, **commit)
        c_want = ss.sent_commit_plain(got[-1], **extra, **commit)
        c_names = (("tx", "next_send", "msgs") if mode == "calibration"
                   else ("tx", "msgs", "hops", "next_send"))
        c_err, c_bad = compare("sent_commit", list(c_got), list(c_want),
                               c_names)
        # the one host call (each kernel's outputs held as its own), and
        # the parent's two calls
        n_sel = len(sel_names)
        sent_t = select["sent"].clone()
        t_got = ss.sent_tick(**{**select, **commit, "sent": sent_t})
        t_bad = (compare("sent_select", [*t_got[:n_sel], sent_t],
                         [*want, sent_p], [*sel_names, "sent"])[1]
                 + compare("sent_commit", list(t_got[n_sel:]), list(c_want),
                           c_names)[1])
        del sent_t
        p_bad = None
        if parent is not None:
            sent_q = select["sent"].clone()
            p_got = parent.sent_pair({**select, "sent": sent_q}, commit)
            p_bad = [nm for nm, x, y in zip(
                [*sel_names, *c_names, "sent"], [*t_got, sent_p],
                [*p_got, sent_q]) if not (x is None and y is None
                                          or torch.equal(x, y))]
            del sent_q
        active = int(ss.active_rows(select["tx"], select["next_send"],
                                    select["tick"],
                                    select.get("infected")).sum())
        return dict(max_abs_err=err, differs=bad, commit_max_abs_err=c_err,
                    commit_differs=c_bad, tick_differs=t_bad,
                    parent_differs=p_bad, active_rows=active,
                    fanout=select["fanout"],
                    sends=int(got[-1].sum())), got

    # -- calibration mode: ExactConfig(16000), seed 0
    ccfg = cal.ExactConfig(16000)
    key, states = calib_check_states(ccfg, dev)
    ties_total = 0
    for tick, state in sorted(states.items()):
        select, commit = cal.exact_inputs(state, fold_in(key, tick), ccfg)
        ties = tied_rows(select)
        ties_total += ties
        for k in SENT_FANOUTS:
            rec, got = run_pair("calibration", {**select, "fanout": k},
                                commit)
            rec.update(mode="calibration", n=ccfg.n_nodes, seeds=1,
                       tick=tick, tied_rows=ties)
            checks.append(rec)
            if tick > 1 and k == ccfg.fanout:
                timed.update(sent_times(ss, "calibration", select, commit,
                                        got, rec, ccfg.n_nodes, 1, parent))
                timed["enqueue/calibration"] = sent_enqueue(
                    ss, state, fold_in(key, tick), ccfg)
            del got
        if tick > 1:
            checks += fallback_checks(select, commit, run_pair)
        del select, commit
        torch.cuda.empty_cache()
    del states
    if ties_total == 0:
        fail("phase 11: no active row held a tied score in its k + 1 "
             "smallest: the tie path did not run")

    # -- broadcast mode: 512 nodes x 8 seeds at SENT_CHECK_TICK
    for label, cfg in sent_variants(512).items():
        if label == "obs_sync":
            continue  # its broadcast phase is sim_trace's; phase 13 runs it
        seed_keys = list(split(PRNGKey(0), 8))
        state = sent_seeds_init(cfg, 8, device=dev)
        while state.tick < SENT_CHECK_TICK:
            state = sent_seeds_tick(
                state, [fold_in(k, state.tick) for k in seed_keys], cfg)
        pairs = []
        for k in seed_keys:
            k_b, _ = split(fold_in(k, state.tick))
            pairs.append(tuple(split(k_b)))
        select, commit = sent_inputs(
            state.rows, state.tx_remaining, state.msgs, state.hops,
            state.tick, state.next_send, state.sent, pairs,
            cfg.broadcast_params, _partition_ids(cfg, dev),
            state.tick < cfg.heal_tick)
        # the int64 keys of a wide codec (WIDE_CODEC), on the same
        # inputs moved into the high word
        wide = select["rows"].to(torch.int64) * (1 << 32) + 7
        for k in SENT_FANOUTS:
            for keys, sel, com in (
                    ("", select, commit),
                    ("_int64", {**select, "rows": wide},
                     {**commit, "rows": wide})):
                if keys and label != "sim_trace":
                    continue
                rec, got = run_pair("broadcast", {**sel, "fanout": k}, com)
                rec.update(mode="broadcast", variant=label + keys,
                           n=cfg.n_nodes, seeds=8, tick=state.tick,
                           partition_in_force=state.tick < cfg.heal_tick)
                checks.append(rec)
                if label == "sim_trace" and not keys and k == select["fanout"]:
                    timed.update(sent_times(ss, "broadcast", select, commit,
                                            got, rec, cfg.n_nodes, 8,
                                            parent))
    checks += split_checks(ss, dev)
    for c in checks:
        if c["differs"] or c.get("commit_differs") or c.get("tick_differs"):
            fail(f"sent kernels differ from their plain versions: {c}")
        if c.get("parent_differs"):
            fail(f"sent_tick differs from the parent's two calls: {c}")
    results = []
    for name, replaces in (
        ("sent_select", "corrosion_tpu/sim/calibrate.py:71"),
        ("sent_commit", "corrosion_tpu/sim/calibrate.py:105"),
    ):
        t = timed[f"{name}/calibration"]
        results.append(dict(
            name=name, route="cuda", source=SENT_SOURCE, replaces=replaces,
            max_abs_err=errs[name], library_ms=None,
            ms=t["ms"], plain_ms=t["plain_ms"], bound=t["bound"],
            shape=t["shape"]))
        set_bound(results[-1])
    for t in timed.values():
        if "bound" in t:
            b, ops = t["bound"]
            t["bound_ms"] = max(b / HBM_BYTES_PER_S,
                                ops / INT_OPS_PER_S) * 1e3
    return results, checks, timed


def fallback_checks(select, commit, run_pair) -> list:
    """The busiest calibration tick with crafted ``sent`` rows that the
    filter cannot answer: active rows left with k - 1, k + 2 or no peers
    (about 1.5 in 1000 of the open columns pass the filter at 16k, so
    fewer than k come through and the row takes the exact fallback),
    every k."""
    from corrosion_tpu_torch.kernels.sent_sampler import active_rows

    active = torch.nonzero(active_rows(
        select["tx"], select["next_send"], select["tick"],
        select["infected"])[0]).flatten().tolist()
    g = np.random.default_rng(11)
    n = select["sent"].shape[1]
    out = []
    for k in SENT_FANOUTS:
        sent = select["sent"].clone()
        rows = [active[j] for j in g.choice(len(active), 6, replace=False)]
        for r, keep in zip(rows, (k - 1, k + 2, 0, k - 1, k + 2, 0)):
            sent[0, r] = True
            sent[0, r, torch.from_numpy(g.choice(n, keep,
                                                 replace=False))] = False
        rec, _ = run_pair("calibration", {**select, "sent": sent,
                                          "fanout": k}, commit)
        rec.update(mode="calibration", variant="fallback_rows", rows=rows,
                   n=n, seeds=1, tick=select["tick"])
        out.append(rec)
        del sent
    return out


def split_checks(ss, dev) -> list:
    """Calibration rows whose counters cross 2**32 (``SENT_SPLIT_CASES``,
    chunk = N, one seed, every k): the kernel on the listed rows, the
    only active ones, against the plain selection of each row alone
    (its own uniforms at counters row * N + col, ``select_k``), with a
    peer of each row's own pick marked sent beforehand.  The plain
    version of the whole [N, N] block would need some 70 GB."""
    from corrosion_tpu_torch.kernels.threefry import MASK32, threefry2x32

    out = []
    key = (0x9E3779B9, 0x7F4A7C15)
    for n, rows in SENT_SPLIT_CASES:
        sent = torch.zeros((1, n, n), dtype=torch.bool, device=dev)
        rows_t = torch.tensor(rows, device=dev)
        cols = torch.arange(n, dtype=torch.int64, device=dev)

        def scores(r):
            idx = r * n + cols
            x0, x1 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
            u = ((x0 ^ x1) >> 9).to(torch.float32) * 2.0**-23
            return torch.where(sent[0, r] | (cols == r), math.inf, u)

        for r in rows:  # pre-mark each row's best peer
            sent[0, r, int(torch.argmin(scores(r)))] = True
        base_marks = int(sent.sum())
        for k in SENT_FANOUTS:
            infected = torch.zeros((1, n), dtype=torch.bool, device=dev)
            infected[0, rows_t] = True
            tx = torch.where(infected, 8, 0).to(torch.int32)
            select = dict(keys=torch.tensor([[key]], dtype=torch.uint32,
                                            device=dev),
                          fanout=k, chunk=n, tx=tx,
                          next_send=torch.zeros_like(tx), tick=0,
                          infected=infected)
            want_inf = infected.clone()
            want_rows, want_counts = {}, torch.zeros_like(tx)
            for r in rows:
                targets, avail = ss.select_k(scores(r)[None], k)
                t = targets[0][avail[0]]
                want_inf[0, t] = True
                want_counts[0, r] = t.numel()
                want_rows[r] = sent[0, r].clone()
                want_rows[r][t] = True
            commit = dict(msgs=torch.zeros_like(tx), max_tx=8)
            want_commit = ss.sent_commit_plain(
                want_counts, tx, commit["msgs"], tick=0, max_tx=8,
                next_send=select["next_send"], infected=infected,
                new_infected=want_inf)
            bad = []
            for call in ("sent_select", "sent_tick"):
                work = sent.clone()
                if call == "sent_select":
                    new_inf, counts = ss.sent_select(work, **select)
                    rest_ok = True
                else:
                    new_inf, counts, *rest = ss.sent_tick(work, **select,
                                                          **commit)
                    rest_ok = all(map(torch.equal, rest, want_commit))
                marks = int(work.sum()) - base_marks
                if not (torch.equal(new_inf, want_inf)
                        and torch.equal(counts, want_counts) and rest_ok
                        and all(torch.equal(work[0, r], want_rows[r])
                                for r in rows)
                        and marks == int(want_counts.sum())):
                    bad.append(f"{call}: new_infected, counts, sent or "
                               "the commit's outputs")
                del work
            out.append(dict(mode="calibration", variant="counter_split",
                            n=n, rows=list(rows), fanout=k, differs=bad,
                            sends=int(want_counts.sum())))
        del sent
        torch.cuda.empty_cache()
    return out


def sent_times(ss, mode, select, commit, got, rec, n, seeds,
               parent=None) -> dict:
    """Times of ``sent_select`` and ``sent_commit`` (kernel and plain) on
    one tick's inputs, with their bounds: (bytes, integer operations);
    and, in turns with the parent's when given (``in_turns``), the pair
    from one ``sent_tick`` call (the parent's two calls, its counts
    zero-filled first) and the commit alone, each between two events
    behind a GPU-side sleep."""
    work = select["sent"].clone()

    def restore():
        work.copy_(select["sent"])

    sel = {**select, "sent": work}
    total, active, sends = seeds * n, rec["active_rows"], rec["sends"]
    k = select["fanout"]
    calib = mode == "calibration"
    if calib:
        extra = dict(new_infected=got[0])
        # activity reads, new_infected and counts written, the active
        # rows' sent rows, and a sector each for a mark and an infection
        sel_bytes = total * (9 + 5) + active * n + sends * 2 * SECTOR
        hashes, uniforms = active * n, 0
        com_bytes = total * (18 + 12)
    else:
        r = select["rows"].shape[2] * select["rows"].element_size()
        extra = dict(new_rows=got[0], cand=got[1])
        # activity reads; new rows, counts and hop candidates written;
        # the active rows' sent rows and own keys; a sector for a mark
        # and one for each merged row
        sel_bytes = (total * (8 + r + 8) + active * (n + r + 4)
                     + sends * 2 * SECTOR)
        hashes = active * n
        uniforms = active * k * ((select["loss"] > 0)
                                 + (select["region"] is not None))
        com_bytes = total * (2 * r + 24 + 16)
    out = {}
    # the selection compares the scores' words: no uniform epilogue
    out[f"sent_select/{mode}"] = dict(
        ms=time_inplace_ms(restore, lambda: ss.sent_select(**sel), 20),
        plain_ms=time_inplace_ms(restore,
                                 lambda: ss.sent_select_plain(**sel), 1, 1),
        bound=(sel_bytes, hashes * INT_OPS_PER_HASH
               + uniforms * INT_OPS_PER_UNIFORM),
        shape=f"{mode} {seeds} x {n}, tick {select['tick']}, "
              f"{active} active rows, {sends} sends")
    out[f"sent_commit/{mode}"] = dict(
        ms=time_inplace_ms(lambda: None,
                           lambda: ss.sent_commit(got[-1], **extra, **commit),
                           20),
        plain_ms=time_inplace_ms(
            lambda: None,
            lambda: ss.sent_commit_plain(got[-1], **extra, **commit), 3),
        bound=(com_bytes, 0),
        shape=f"{mode} {seeds} x {n}, tick {select['tick']}")
    parent_pair = parent_commit = None
    if parent is not None:
        a, _ = parent.sent_block(sel, commit)
        a.counts = got[-1].data_ptr()  # the commit on this selection
        if calib:
            a.new_infected = got[0].data_ptr()
        else:
            a.new_rows = got[0].data_ptr()
            a.cand = None if got[1] is None else got[1].data_ptr()

        def parent_pair():
            parent.sent_pair(sel, commit)

        def parent_commit():
            parent.sent_launch("sent_commit_launch", a, got[-1])

    out[f"sent_tick/{mode}"] = dict(
        pair=in_turns(lambda: ss.sent_tick(**{**sel, **commit}), parent_pair,
                      lambda fn: time_inplace_ms(restore, fn, 20)),
        commit=in_turns(
            lambda: ss.sent_commit(got[-1], **extra, **commit),
            parent_commit, lambda fn: time_inplace_ms(lambda: None, fn, 20)),
        select_ms=out[f"sent_select/{mode}"]["ms"],
        shape=out[f"sent_select/{mode}"]["shape"])
    return out


def sent_enqueue(ss, state, key, cfg, reps: int = 20) -> dict:
    """The host's time (µs, medians of ``reps``) to enqueue one
    calibration tick's sampler, the device asleep behind a GPU-side
    sleep that must outlast it: ``sent_tick``, and the two wrappers
    ``sent_select`` and ``sent_commit``, in turns (two, one, one, two),
    on a copy of ``sent``; and ``exact_inputs`` before each, the device
    idle (its key upload waits for the stream)."""
    from corrosion_tpu_torch.sim import calibrate as cal

    state = state._replace(sent=state.sent.clone())

    def one_call(select, commit):
        ss.sent_tick(**{**select, **commit})
        return time.perf_counter()

    def two_calls(select, commit):
        new_infected, counts = ss.sent_select(**select)
        t = time.perf_counter()
        ss.sent_commit(counts, new_infected=new_infected, **commit)
        return t

    def measure(fn):
        for _ in range(3):
            fn(*cal.exact_inputs(state, key, cfg))
        inputs, calls, last = [], [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            args = cal.exact_inputs(state, key, cfg)
            t1 = time.perf_counter()
            torch.cuda._sleep(10 * SLEEP_CYCLES)
            t2 = time.perf_counter()
            mid = fn(*args)
            t3 = time.perf_counter()
            done = torch.cuda.Event()
            done.record()
            if done.query():
                fail("sent_enqueue: the device woke before the tick was "
                     "enqueued")
            inputs.append((t1 - t0) * 1e6)
            calls.append((t3 - t2) * 1e6)
            last.append((t3 - mid) * 1e6)
        torch.cuda.synchronize()
        # last_call_us: sent_commit's wrapper of the two, ~0 for one
        return {"inputs_us": float(np.median(inputs)),
                "calls_us": float(np.median(calls)),
                "last_call_us": float(np.median(last))}

    runs = [measure(fn) for fn in (two_calls, one_call, one_call,
                                   two_calls)]
    return {"sent_tick": runs[1:3], "two_calls": [runs[0], runs[3]]}


# every run of phase 12 launches these; the calibration's perm column
# and the sync variant also draw through threefry_bits
SENT_COUNTED = ("sent_select", "sent_commit", "tick_stats")


# the twins' keys beside the runner's: phase 12 holds both
SIMDIFF_KEYS = {"converged_frac": "converged_frac",
                "ticks_to_converge_p50": "ticks_p50",
                "ticks_to_converge_p99": "ticks_p99",
                "msgs_per_node": "msgs_per_node_mean",
                "hops_p50": "hops_p50", "hops_p99": "hops_p99"}
OBS_KEYS = {"converged_frac": "converged_frac", "ticks_p50": "ticks_p50",
            "ticks_p99": "ticks_p99", "msgs_per_node": "msgs_per_node_mean"}


def through(module, call):
    """``call()`` with ``module.run_epidemic_seeds`` wrapped to keep the
    runner's own statistics; returns them with the twin's result under
    ``"twin"``."""
    runner, kept = module.run_epidemic_seeds, []

    def keep(*args, **kw):
        kept.append(runner(*args, **kw))
        return kept[-1]

    module.run_epidemic_seeds = keep
    try:
        twin = call()
    finally:
        module.run_epidemic_seeds = runner
    return {**kept[0], "twin": twin}


def sent_full_width(counted) -> dict:
    """Phase 12: ``run_msgs_calibration`` at N = 1000, 4000 and 16000 x 3
    seeds, ``simdiff.sim_trace`` at 64, 256 and 512 nodes x 8 seeds and
    ``obs.sim_obs_trace`` (sync every 8 ticks) at 512 x 8 through their
    entry points on the card, the launch counters zeroed just before
    each; each held to the reference's numbers, the twins' results and
    the runner's statistics under them."""
    from corrosion_tpu_torch.sim import obs, simdiff
    from corrosion_tpu_torch.sim.calibrate import run_msgs_calibration

    jobs = [("calibration", lambda: run_msgs_calibration(
        ns=(1000, 4000, 16000), seeds=3, device="cuda"), None,
        ("threefry_bits",), None)]
    for n in SIMDIFF_WANT:
        jobs.append((f"sim_trace_{n}", lambda n=n: through(
            simdiff, lambda: simdiff.sim_trace(n, device="cuda")),
            SIMDIFF_WANT[n], (), SIMDIFF_KEYS))
    jobs.append(("obs_sync_512", lambda: through(
        obs, lambda: obs.sim_obs_trace(512, device="cuda")), OBS512_WANT,
        ("threefry_bits", "sync_pull"), OBS_KEYS))
    runs = {}
    for label, run, want, more, twin_keys in jobs:
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t0
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["launches"] = {name: counted[name].launches
                           for name in SENT_COUNTED + more}
        runs[label] = res
        print(f"{label}: " + json.dumps(res), flush=True)
        if want is None:
            if res["points"] != CALIB_WANT:
                fail(f"calibration points differ from CALIB_MSGS.json: "
                     f"{res['points']}")
        else:
            for k, v in want.items():
                if not math.isclose(res[k], v, rel_tol=1e-6):
                    fail(f"{label}: {k} = {res[k]}, the reference gives {v}")
            twin = res["twin"]
            if twin["runtime"] != "tpu-sim" or twin["n_nodes"] != res["n_nodes"]:
                fail(f"{label}: the twin's result is not the runner's: {twin}")
            for tk, k in twin_keys.items():
                if twin[tk] != res[k]:
                    fail(f"{label}: the twin's {tk} = {twin[tk]}, the "
                         f"runner's {k} = {res[k]}")
        idle = [name for name, c in res["launches"].items() if c == 0]
        if idle:
            fail(f"{label}: kernels never launched: {idle}")
    return runs


def calib_equal(cfg, dev, label: str) -> dict:
    """``exact_tick`` on the card == on the CPU, every leaf every tick
    of seed 0's run, and the ``run_exact`` results."""
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    key = PRNGKey(0)
    gpu = cal.exact_init(cfg, device=dev)
    cpu = cal.exact_init(cfg, device="cpu")
    while not bool(cpu.infected.all()) and cpu.tick < cfg.max_ticks:
        k = fold_in(key, cpu.tick)
        gpu, cpu = cal.exact_tick(gpu, k, cfg), cal.exact_tick(cpu, k, cfg)
        if not states_equal(gpu, cpu):
            fail(f"{label}: card and CPU differ at tick {cpu.tick}")
    runs = [cal.run_exact(cfg, seed=0, device=d) for d in (dev, "cpu")]
    for r in runs:
        r.pop("wall_s")
    if runs[0] != runs[1]:
        fail(f"{label}: results differ:\ncard {runs[0]}\ncpu  {runs[1]}")
    return {"ticks_compared": cpu.tick, "stats": runs[0]}


def track_sent_equal(cfg, seeds: int, dev, label: str) -> dict:
    """The ``track_sent`` runner's tick on the card == on the CPU, every
    leaf and the tick statistics every tick until every seed has
    converged, and the ``run_epidemic_seeds`` stats."""
    from corrosion_tpu_torch.kernels.tick_stats import CONVERGED, tick_stats
    from corrosion_tpu_torch.random import PRNGKey, fold_in, split
    from corrosion_tpu_torch.sim.epidemic import (
        run_epidemic_seeds,
        sent_seeds_init,
        sent_seeds_tick,
    )

    seed_keys = list(split(PRNGKey(0), seeds))
    gpu = sent_seeds_init(cfg, seeds, device=dev)
    cpu = sent_seeds_init(cfg, seeds, device="cpu")
    n, r = cfg.n_nodes, cfg.n_rows
    target = cpu.rows[0, 0].clone()

    def stats(st):
        hops = None if st.hops is None else st.hops.reshape(-1)
        return tick_stats(st.rows.reshape(-1, r), target.to(st.rows.device),
                          st.msgs.reshape(-1), hops, seeds).cpu()

    while cpu.tick < cfg.max_ticks:
        keys = [fold_in(k, cpu.tick) for k in seed_keys]
        gpu = sent_seeds_tick(gpu, keys, cfg)
        cpu = sent_seeds_tick(cpu, keys, cfg)
        if not states_equal(gpu, cpu):
            fail(f"{label}: card and CPU differ at tick {cpu.tick}")
        sg, sc = stats(gpu), stats(cpu)
        if not torch.equal(torch.nan_to_num(sg), torch.nan_to_num(sc)):
            fail(f"{label}: tick stats differ at tick {cpu.tick}")
        if bool((sc[:, CONVERGED] == 1.0).all()):
            break
    runs = [run_epidemic_seeds(cfg, n_seeds=seeds, seed=0, device=d)
            for d in (dev, "cpu")]
    for x in runs:
        x.pop("wall_s")
    if runs[0] != runs[1]:
        fail(f"{label}: stats differ:\ncard {runs[0]}\ncpu  {runs[1]}")
    return {"ticks_compared": cpu.tick, "nodes": n, "stats": runs[0]}


# -- the segmented sort and the winner selection ----------------------------

SORT_SOURCE = "corrosion_tpu_torch/kernels/csrc/seg_sort.cu"
WINNERS_SOURCE = "corrosion_tpu_torch/kernels/csrc/winners.cu"
# 23-bit threefry scores: the headline's global and ring0 columns and the
# 1M sweep row's (bench.py:3670)
SORT_SHAPES = ((32, 100_000), (12_800, 250), (128_000, 250),
               (32, 1_000_000))
# the headline's numbers (PERF.md), which the sort kernel must keep
HEADLINE_WANT = {"converged_frac": 1.0, "ticks_p50": 15.0, "ticks_p99": 15.0,
                 "msgs_per_node_mean": 16.03, "msgs_per_node_p99": 34.97}
WINNERS_COUNTED = ("seg_argsort", "seg_cummax", "winners_a", "winners_b")


def sort_checks(dev) -> list:
    """Phase 14: ``seg_argsort``'s flat indices against its plain
    version, bitwise, on 23-bit threefry keys at every shape the sweeps
    sort, on all-equal and two-valued keys, on int64 keys of 2**20
    (the winners' 21 bits, and many ties), and on the regimes' edges:
    the warp regime's register counts (L = 1, 7, 32, 33, 64, 65, 128,
    129, 256), the shared regime (257, 4096), the radix regime (4097),
    every key and composite width, one-pass 8-bit and eight-pass int64
    keys."""
    from corrosion_tpu_torch.kernels import seg_sort
    from corrosion_tpu_torch.random import PRNGKey, bits, fold_in

    rng = np.random.default_rng(14)

    def host(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = [(f"threefry {list(shape)}", bits(fold_in(PRNGKey(7), i), shape,
                                              dev), 23, 9)
             for i, shape in enumerate(SORT_SHAPES)]
    cases += [
        ("all equal", host(np.full((32, 100_000), 0x2345 << 9, np.uint32)),
         23, 9),
        ("two-valued", host((rng.integers(0, 2, (32, 100_000)) << 9)
                            .astype(np.uint32)), 23, 9),
        ("int64 2^20, 4096 values", host(
            rng.integers(0, 4096, (1, 1 << 20)) << 28), 40, 0),
        ("int64 2^20 all equal", host(np.full((1, 1 << 20), 7, np.int64)),
         21, 0),
        ("uint32 [4, 4096] 64-bit composite", host(
            rng.integers(0, 1 << 23, (4, 4096)).astype(np.uint32) << 9),
         23, 9),
        ("int64 [64, 3000] 32-bit composite", host(
            rng.integers(0, 1 << 20, (64, 3000))), 20, 0),
        ("int64 [1, 1000] 40 bits", host(rng.integers(0, 1 << 40,
                                                      (1, 1000))), 40, 0),
        ("L = 1", host(rng.integers(0, 9, (5, 1)).astype(np.uint32)), 4, 0),
        ("L = 7", host(rng.integers(0, 3, (3, 7)).astype(np.uint32)), 2, 0),
        ("L = 4097, 8-bit", host(rng.integers(0, 256, (2, 4097))
                                 .astype(np.uint32)), 8, 0),
        ("int64 2^20, 21 bits (the winners' width)", host(
            rng.integers(0, 1 << 21, (1, 1 << 20))), 21, 0),
        ("uint32 [100, 200] 32-bit keys, 64-bit composite", host(
            rng.integers(0, 1 << 32, (100, 200), dtype=np.uint64)
            .astype(np.uint32)), 32, 0),
        ("int64 [64, 200] 40 bits, 64-bit composite", host(
            rng.integers(0, 1 << 40, (64, 200))), 40, 0),
        ("int64 [3, 5000] 62 bits, eight passes", host(
            rng.integers(0, 1 << 62, (3, 5000))), 62, 0),
        ("all equal [16, 250]", host(np.full((16, 250), 5 << 9, np.uint32)),
         23, 9),
        ("two-valued [64, 4096]", host((rng.integers(0, 2, (64, 4096)) << 9)
                                       .astype(np.uint32)), 23, 9),
    ]
    # the regimes' edges on 23-bit threefry keys with ties
    for length in (1, 32, 33, 64, 65, 128, 129, 256, 257, 4096, 4097):
        raw = (rng.integers(0, max(2, length // 3), (37, length)) << 9
               | rng.integers(0, 512, (37, length))).astype(np.uint32)
        cases.append((f"L = {length}, ties", host(raw), 23, 9))
    checks = []
    for label, keys, key_bits, shift in cases:
        got = seg_sort.seg_argsort(keys, key_bits, shift)
        want = seg_sort.seg_argsort_plain(keys, key_bits, shift)
        err = max_abs_err([got], [want])
        checks.append(dict(case=label, shape=list(keys.shape),
                           key_bits=key_bits, max_abs_err=err))
        if err != 0.0:
            fail(f"seg_argsort differs from its plain version: {label}")
    return checks


def sort_kernel_names(cfg) -> list:
    """The sort kernels one headline tick launches (``torch.profiler``):
    the port's ``seg_sort_*``, and none of PyTorch's sorts."""
    from corrosion_tpu_torch.random import PRNGKey
    from corrosion_tpu_torch.sim.epidemic import epidemic_init, epidemic_tick

    state = epidemic_init(cfg, device="cuda")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        epidemic_tick(state, PRNGKey(0), cfg)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    sorts = [k for k in names if "sort" in k.lower()]
    foreign = [k for k in sorts if "seg_sort_" not in k]
    if foreign or not sorts:
        fail(f"a headline tick's sorts are not the port's: {sorts}")
    return sorts


def winners_full_width(counted) -> dict:
    """Phase 15: ``select_winners(device="cuda")`` on 2**20 changes
    (262,144 rows x 4 cells) encoded through ``encode_changes``, cold
    and warm, pk-grouped and interleaved, each run with the launch
    counters zeroed just before, held bitwise to the NumPy twin and to
    the plain torch core on the card."""
    from corrosion_tpu_torch.convert import decision_diff
    from corrosion_tpu_torch.ops import merge
    from corrosion_tpu_torch.profile_tick import resync_batch

    runs, plans = {}, {}
    warm_up = merge.encode_changes(*resync_batch(4096))
    merge.select_winners(warm_up, backend="torch", device="cuda")
    for interleaved in (False, True):
        for warm in (False, True):
            label = (f"{'interleaved' if interleaved else 'pk_grouped'}_"
                     f"{'warm' if warm else 'cold'}")
            t0 = time.perf_counter()
            plan = merge.encode_changes(*resync_batch(
                interleaved=interleaved, warm=warm))
            encode_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = merge.select_winners(plan, backend="numpy")
            numpy_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            for fn in counted.values():
                fn.launches = 0
            t0 = time.perf_counter()
            got = merge.select_winners(plan, backend="torch", device="cuda")
            call_s = time.perf_counter() - t0
            launches = {k: counted[k].launches for k in WINNERS_COUNTED}
            plain = merge._winners_torch(plan, "cuda", plain=True)
            for other, name in ((want, "the NumPy twin"),
                                (plain, "the plain torch core")):
                diff = decision_diff(got, other)
                if diff:
                    fail(f"winners {label}: the kernels differ from {name} "
                         f"in {diff}")
            idle = [k for k, c in launches.items() if c == 0]
            if idle:
                fail(f"winners {label}: kernels never launched: {idle}")
            runs[label] = dict(
                n=plan.n, n_pk=plan.n_pk, n_cid=plan.n_cid,
                impacted=got.impacted,
                winners=int((got.winner_idx >= 0).sum()),
                gen_rows=int(got.gen.sum()), encode_s=encode_s,
                numpy_s=numpy_s, call_s=call_s, launches=launches)
            plans[label] = plan
            print(f"winners {label}: " + json.dumps(runs[label]), flush=True)
    return runs, plans


# value columns of every type, as profile_tick.RESYNC_VALUES
WINNERS_VALUES = (None, 1, -4, 2.5, "x", b"\x01", "yy", "")
WINNERS_TIMED = ("interleaved_warm", "pk_grouped_warm")


def winners_edge_plans() -> dict:
    """Phase 15's edge batches, drawn with numpy from a seed through
    ``encode_changes``, cold and warm: n = 1, 31, 32, 33 and 4097 (either
    side of a warp's tile and of a block's), one row of 5,000 changes
    between short rows (cl rising with the stream, so a tile's partial
    max is below the row's final), 1,000 rows of one change, one cell's
    300 accepts after 50 other changes (in stream order and shuffled:
    the cell crosses warps' tiles), sentinels only, one column and 64."""
    from corrosion_tpu_torch.ops import merge

    rng = np.random.default_rng(15)

    def recs(pks, cols, sentinel=0.25, cl=None):
        n = len(pks)
        sent = rng.random(n) < sentinel
        cid = rng.integers(0, cols, n)
        cl = rng.integers(1, 6, n) if cl is None else cl
        ver = rng.integers(1, 5, n)
        val = rng.integers(0, len(WINNERS_VALUES), n)
        return [(f"p{p}", None, int(c), 0, None) if s
                else (f"p{p}", f"c{ci}", int(c), int(v), WINNERS_VALUES[x])
                for p, s, ci, c, v, x in zip(pks, sent, cid, cl, ver, val)]

    cell = (recs(rng.integers(1, 10, 50), 4)
            + [("p0", "c1", 1, v + 1, WINNERS_VALUES[v % 8])
               for v in range(300)])
    batches = {f"n = {n}": (recs(rng.integers(0, max(1, n // 4), n), 4), 4)
               for n in (1, 31, 32, 33, 4097)}
    batches.update({
        "one row of 5,000": (
            recs(rng.integers(1, 20, 37), 4)
            + recs(np.zeros(5000, np.int64), 4,
                   cl=1 + np.arange(5000) * 5 // 5000)
            + recs(rng.integers(1, 20, 91), 4), 4),
        "1,000 rows of one change": (recs(rng.permutation(1000), 4), 4),
        "a cell's 300 accepts": (cell, 4),
        "a cell's 300 accepts, shuffled": (
            [cell[i] for i in rng.permutation(len(cell))], 4),
        "sentinels only": (recs(rng.integers(0, 120, 500), 4, 1.0), 4),
        "one column": (recs(rng.integers(0, 300, 2000), 1), 1),
        "64 columns": (recs(rng.integers(0, 300, 2000), 64), 64)})
    plans = {}
    for label, (records, cols) in batches.items():
        rows = sorted({r[0] for r in records})
        seed_cls = {p: int(rng.integers(1, 5)) for p in rows
                    if rng.random() < 0.9}
        seed_cells = {(p, f"c{c}"): (int(rng.integers(1, 5)),
                                     WINNERS_VALUES[int(rng.integers(0, 4))])
                      for p in seed_cls for c in range(cols)
                      if rng.random() < 0.5}
        for mode, seeds in (("cold", ({}, {})),
                            ("warm", (seed_cls, seed_cells))):
            plan = merge.encode_changes(records, *seeds)
            if plan is None:
                fail(f"winners edge batch {label}, {mode}: not encodable")
            plans[f"{label}, {mode}"] = plan
    return plans


class WinnersPasses:
    """One plan's intermediates on the card (the two orders by
    ``seg_argsort``) and its two winner passes: this tree's kernels,
    their plain versions and, when given, the parent's kernels, each
    into fresh result views."""

    def __init__(self, plan, dev, parent=None):
        from corrosion_tpu_torch.kernels import seg_sort, winners

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.w, self.parent, self.dev = winners, parent, dev
        self.pk, self.cid, self.sent, self.cl, self.key = (
            put(getattr(plan, f)) for f in ("pk", "cid", "sent", "cl", "key"))
        self.seed_cl, self.seed_key = put(plan.seed_cl), put(plan.seed_key)
        self.n, self.n_pk, self.n_cid = plan.n, plan.n_pk, plan.n_cid
        self.comp = self.pk * (self.n_cid + 2) + (self.cid + 1)
        self.bits_b = ((self.n_pk - 1) * (self.n_cid + 2)
                       + self.n_cid).bit_length()
        self.o_a = seg_sort.seg_argsort(
            self.pk[None], (self.n_pk - 1).bit_length())[0]
        self.o_b = seg_sort.seg_argsort(self.comp[None], self.bits_b)[0]
        self.prev_a = winners.seg_cummax(self.o_a, self.pk, self.cl)

    def outputs(self):
        from corrosion_tpu_torch.kernels.winners import BIG

        z = torch.zeros(self.n_pk, dtype=torch.int64, device=self.dev)
        return dict(
            final_cl=self.seed_cl.clone(), sent_flag=z.clone(),
            ensure=z.clone(),
            part=torch.zeros(self.n, dtype=torch.bool, device=self.dev),
            counts=torch.zeros(3, dtype=torch.int64, device=self.dev),
            winner=torch.full((self.n_pk * self.n_cid,), -1,
                              dtype=torch.int64, device=self.dev),
            clrow=torch.full((self.n_pk,), BIG, dtype=torch.int64,
                             device=self.dev))

    def cummax_args(self, part=None) -> dict:
        """``seg_cummax``'s arguments in domain A and domain B (the
        mask ``part``, the plain pass's unless given)."""
        part = self.part if part is None else part
        return {"A": (self.o_a, self.pk, self.cl, None),
                "B": (self.o_b, self.comp, self.key, part)}

    def run_a(self, fn, o):
        """Domain A by ``fn`` into ``o``; returns its pk_pos."""
        return fn(self.o_a, self.prev_a, self.pk, self.cl, self.sent,
                  self.seed_cl, o["final_cl"], o["sent_flag"], o["ensure"],
                  o["part"], o["counts"])

    def run_b(self, fn, o, pk_pos, prev_b, part, final_cl):
        fn(self.o_b, prev_b, pk_pos, self.cid, self.cl, self.key, part,
           self.seed_key, final_cl, self.n_cid, o["winner"], o["clrow"],
           o["counts"])

    def check(self) -> dict:
        """Both passes by the kernels, the plain versions and the
        parent's kernels; max |diff| of every output against the plain
        versions' and the parent's (domain B on the plain versions'
        part, final_cl and pk_pos for all three, so each pass is held
        alone)."""
        w = self.w
        a_keys = ("final_cl", "sent_flag", "ensure", "part", "counts")
        b_keys = ("winner", "clrow", "counts")
        a_got, a_want = self.outputs(), self.outputs()
        pos = self.run_a(w.winners_a, a_got)
        pos_want = self.run_a(w.winners_a_plain, a_want)
        res = {"a_err": max_abs_err([a_got[k] for k in a_keys] + [pos],
                                    [a_want[k] for k in a_keys]
                                    + [pos_want])}
        part, final_cl = a_want["part"], a_want["final_cl"]
        self.prev_b = w.seg_cummax(self.o_b, self.comp, self.key, mask=part)
        b_got, b_want = self.outputs(), self.outputs()
        self.run_b(w.winners_b, b_got, pos_want, self.prev_b, part, final_cl)
        self.run_b(w.winners_b_plain, b_want, pos_want, self.prev_b, part,
                   final_cl)
        res["b_err"] = max_abs_err([b_got[k] for k in b_keys],
                                   [b_want[k] for k in b_keys])
        # seg_cummax in both domains, exclusive (the passes' prev) and
        # inclusive, against its plain version and the parent's kernel
        doms = self.cummax_args(part).values()
        mine = [self.prev_a, self.prev_b] + [
            w.seg_cummax(*a, exclusive=False) for a in doms]
        res["cummax_err"] = mismatches(mine, [
            w.seg_cummax_plain(*a, exclusive=ex) for ex in (True, False)
            for a in doms])
        if self.parent is not None:
            res["cummax_parent_err"] = mismatches(mine, [
                self.parent.seg_cummax(*a, exclusive=ex)
                for ex in (True, False) for a in doms])
        if self.parent is not None:
            a_old, b_old = self.outputs(), self.outputs()
            pos_old = self.run_a(self.parent.winners_a, a_old)
            self.run_b(self.parent.winners_b, b_old, pos_want, self.prev_b,
                       part, final_cl)
            res["a_parent_err"] = max_abs_err(
                [a_got[k] for k in a_keys] + [pos],
                [a_old[k] for k in a_keys] + [pos_old])
            res["b_parent_err"] = max_abs_err([b_got[k] for k in b_keys],
                                              [b_old[k] for k in b_keys])
        self.part, self.final_cl, self.pk_pos = part, final_cl, pos_want
        self.a_out, self.b_out = a_got, b_got
        return res

    def timers(self) -> dict:
        """{pass: (this tree's launch, the parent's or None)} into
        scratch views, on the plain versions' intermediates."""
        w, old = self.w, self.parent
        scratch = self.outputs()

        def a(fn):
            return lambda: self.run_a(fn, scratch)

        def b(fn, pk):
            return lambda: self.run_b(fn, scratch, pk, self.prev_b,
                                      self.part, self.final_cl)

        return {"winners_a": (a(w.winners_a), old and a(old.winners_a)),
                "winners_b": (b(w.winners_b, self.pk_pos),
                              old and b(old.winners_b, self.pk_pos))}


def cummax_bytes(order, seg, values, mask=None) -> int:
    """The bytes ``seg_cummax`` must move on these inputs: order, the
    segment key and (under a mask) the mask read at every position, the
    value read where the mask keeps the position, out written."""
    n = order.shape[0]
    kept = n if mask is None else int(mask.sum())
    return n * (4 + 8 + 8 + (0 if mask is None else 1)) + 8 * kept


# either side of one tile of 1024 positions, of two, and of four
CUMMAX_EDGE_NS = (1, 2, 1023, 1024, 1025, 2047, 2048, 2049, 4097)
CUMMAX_BIG = 1 << 22  # one segment over more tiles than the card holds


def cummax_edge_inputs(dev) -> dict:
    """``seg_cummax``'s own edge inputs, drawn with numpy from a seed:
    {label: (order, seg, values, mask)}, position i reading seg, values
    and mask at order[i], a random permutation."""
    from corrosion_tpu_torch.kernels.winners import NEG_KEY

    rng = np.random.default_rng(20)
    top = (1 << 62) - 1
    cases = {}

    def case(label, seg, vals, mask=None):
        order = rng.permutation(seg.shape[0]).astype(np.int32)

        def by_stream(a):
            out = np.empty_like(a)
            out[order] = a
            return torch.from_numpy(out).to(dev)

        cases[label] = (torch.from_numpy(order).to(dev), by_stream(seg),
                        by_stream(vals),
                        None if mask is None else by_stream(mask))

    def vals(n):
        return rng.integers(NEG_KEY, top, n, dtype=np.int64)

    for n in CUMMAX_EDGE_NS:
        case(f"n = {n}", np.cumsum(rng.random(n) < 0.3), vals(n),
             rng.random(n) < 0.7)
    big = np.zeros(CUMMAX_BIG, np.int64)
    case("one segment of 2^22", big, vals(CUMMAX_BIG))
    case("one segment of 2^22, rising", big,
         np.arange(CUMMAX_BIG, dtype=np.int64))
    case("one segment of 2^22, falling", big,
         -np.arange(CUMMAX_BIG, dtype=np.int64))
    n = 1 << 16
    case("starts at every tile's first position", np.arange(n) // 1024,
         vals(n))
    case("segments of one position", np.arange(n), vals(n))
    case("mask all false", np.arange(n) // 300, vals(n), np.zeros(n, bool))
    case("mask all true", np.arange(n) // 300, vals(n), np.ones(n, bool))
    case("values at NEG_KEY and 2^62 - 1", np.arange(n) // 5000,
         rng.choice(np.array([NEG_KEY, NEG_KEY + 1, top, top - 1]), n),
         rng.random(n) < 0.8)
    return cases


def cummax_edge_checks(dev, parent=None) -> list:
    """``seg_cummax`` on its edge inputs, exclusive and inclusive,
    against its plain version (and the parent's kernel), and three
    calls at falling n on one stream with no synchronisation between
    them (a larger call's tile words lie under the smaller ones'),
    bitwise; returns the cases."""
    from corrosion_tpu_torch.kernels import winners

    cases = cummax_edge_inputs(dev)
    checks = []
    for label, args in cases.items():
        for ex in (True, False):
            got = winners.seg_cummax(*args, exclusive=ex)
            r = dict(case=label, n=args[0].shape[0], exclusive=ex,
                     mismatches=mismatches([got], [
                         winners.seg_cummax_plain(*args, exclusive=ex)]))
            if parent is not None:
                r["parent_mismatches"] = mismatches([got], [
                    parent.seg_cummax(*args, exclusive=ex)])
            checks.append(r)
    chain = ("one segment of 2^22, rising", "n = 4097", "n = 2049")
    torch.cuda.synchronize()
    outs = [winners.seg_cummax(*cases[c]) for c in chain]
    torch.cuda.synchronize()
    checks.append(dict(
        case="falling n, no synchronisation: " + ", ".join(chain),
        mismatches=mismatches(outs, [winners.seg_cummax_plain(*cases[c])
                                     for c in chain])))
    # a CUDA graph of two calls, replayed three times: each launch must
    # leave its scratch (ticket, epoch) ready for the next; the outputs
    # are cleared before each replay, so one a replay leaves unwritten
    # shows
    graphed = ("one segment of 2^22, falling", "mask all true")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in graphed:  # the stream's scratch, made before capture
            winners.seg_cummax(*cases[c])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [winners.seg_cummax(*cases[c]) for c in graphed]
    wants = [winners.seg_cummax_plain(*cases[c]) for c in graphed]
    for replay in range(3):
        for out in outs:
            out.fill_(7)
        graph.replay()
        torch.cuda.synchronize()
        checks.append(dict(
            case=f"a CUDA graph of {', '.join(graphed)}, replay {replay}",
            mismatches=mismatches(outs, wants)))
    bad = [c for c in checks
           if c["mismatches"] or c.get("parent_mismatches")]
    if bad:
        fail(f"seg_cummax differs on its edge inputs: {bad}")
    return checks


def winners_kernel_checks(plans: dict, dev, parent=None) -> list:
    """Each winner-selection kernel against its plain version on the
    card, and ``winners_a`` / ``winners_b`` against the parent's when
    given, on the intermediates of the four 2**20 plans and of the edge
    batches (every output bitwise; the edge batches' whole call also
    against the NumPy twin); the kernels timed with their bytes bound,
    the winner passes behind a GPU sleep in turns with the parent's."""
    from corrosion_tpu_torch.convert import decision_diff
    from corrosion_tpu_torch.kernels import seg_sort, winners
    from corrosion_tpu_torch.ops import merge

    cases, kept = [], {}
    for label, plan in {**plans, **winners_edge_plans()}.items():
        if plan.n < 1 << 20:
            diff = decision_diff(
                merge.select_winners(plan, backend="torch", device="cuda"),
                merge.select_winners(plan, backend="numpy"))
            if diff:
                fail(f"winners {label}: the kernels differ from the NumPy "
                     f"twin in {diff}")
        passes = WinnersPasses(plan, dev, parent)
        errs = passes.check()
        cases.append(dict(case=label, n=plan.n, n_pk=plan.n_pk,
                          n_cid=plan.n_cid, **errs))
        if any(errs.values()):
            fail(f"winners {label}: the winner passes differ: {errs}")
        if label in WINNERS_TIMED:
            kept[label] = passes
    print(f"winners_a / winners_b bitwise their plain versions"
          f"{' and the parent' if parent else ''} in {len(cases)} batches",
          flush=True)
    t = kept[WINNERS_TIMED[0]]
    sort_args = (t.comp[None], t.bits_b)
    err = max(max_abs_err([t.o_b], [seg_sort.seg_argsort_plain(
        *sort_args)[0]]), max_abs_err([t.o_a], [seg_sort.seg_argsort_plain(
            t.pk[None], (t.n_pk - 1).bit_length())[0]]))
    n, n_pk, n_cid = t.n, t.n_pk, t.n_cid
    res = [dict(
        name="seg_argsort (int64, one segment)", max_abs_err=err,
        ms=time_device_ms(lambda: seg_sort.seg_argsort(*sort_args), 20),
        plain_ms=time_ms(lambda: seg_sort.seg_argsort_plain(*sort_args), 5),
        library_ms=time_device_ms(lambda: torch.sort(t.comp, stable=True),
                                  20),
        bound=(n * (8 + 4), 0),
        shape=f"int64 [1, {n}], {t.bits_b} key bits (the (pk, cid) sort)")]
    edges = cummax_edge_checks(dev, parent)
    print(f"seg_cummax bitwise its plain version"
          f"{' and the parent' if parent else ''} in {len(cases)} batches "
          f"(both domains) and {len(edges)} edge cases", flush=True)

    def device_ms(fn):
        return time_device_ms(fn, 20)

    turns = {label: {name: in_turns(mine, old, device_ms)
                     for name, (mine, old) in p.timers().items()}
             for label, p in kept.items()}
    cummax_turns = {
        label: {dom: in_turns(
            lambda a=args: winners.seg_cummax(*a),
            parent and (lambda a=args: parent.seg_cummax(*a)), device_ms)
            for dom, args in p.cummax_args().items()}
        for label, p in kept.items()}
    cummax_bound = {label: {dom: bound_ms(cummax_bytes(*a), 0)[0]
                            for dom, a in p.cummax_args().items()}
                    for label, p in kept.items()}
    cummax_b = t.cummax_args()["B"]
    cummax_events = in_turns(lambda: winners.seg_cummax(*cummax_b),
                             parent and (lambda: parent.seg_cummax(
                                 *cummax_b)),
                             lambda fn: time_ms(fn, 20))
    scratch = t.outputs()
    a_keys = ("final_cl", "sent_flag", "ensure", "part", "counts")
    res += [
        dict(name="seg_cummax",
             max_abs_err=float(max(c["cummax_err"] for c in cases)),
             ms=cummax_turns[WINNERS_TIMED[0]]["B"]["ms"],
             plain_ms=time_ms(lambda: winners.seg_cummax_plain(
                 t.o_b, t.comp, t.key, mask=t.part), 3),
             library_ms=None, bound=(cummax_bytes(*cummax_b), 0),
             shape=f"domain B, n = {n}", turns=cummax_turns,
             events=cummax_events, bound_by_domain=cummax_bound,
             edge_cases=edges),
        dict(name="winners_a", max_abs_err=max(c["a_err"] for c in cases),
             ms=turns[WINNERS_TIMED[0]]["winners_a"]["ms"],
             plain_ms=time_ms(lambda: t.run_a(winners.winners_a_plain,
                                              t.outputs()), 3),
             library_ms=None,
             # the function's inputs and outputs; pk_pos is the design's
             bound=(nbytes(t.o_a, t.prev_a, t.pk, t.cl, t.sent, t.seed_cl,
                           *(t.a_out[k] for k in a_keys)), 0),
             shape=f"n = {n}, {n_pk} rows", turns=turns, cases=cases),
        dict(name="winners_b", max_abs_err=max(c["b_err"] for c in cases),
             ms=turns[WINNERS_TIMED[0]]["winners_b"]["ms"],
             plain_ms=time_ms(lambda: t.run_b(
                 winners.winners_b_plain, scratch, t.pk_pos, t.prev_b,
                 t.part, t.final_cl), 3),
             library_ms=None,
             bound=(nbytes(t.o_b, t.prev_b, t.pk, t.cid, t.cl, t.key,
                           t.part, t.seed_key, t.final_cl,
                           *(t.b_out[k] for k in ("winner", "clrow",
                                                  "counts"))), 0),
             shape=f"n = {n}, {n_pk} x {n_cid} cells", turns=turns),
    ]
    for r in res:
        set_bound(r)
        if r["max_abs_err"] != 0.0:
            fail(f"{r['name']} differs from its plain version "
                 f"(max |diff| {r['max_abs_err']})")
    return res


# -- the device-resident apply path (ops/devcache under agent/storage) ----

STORE_SOURCE = "corrosion_tpu_torch/kernels/csrc/store.cu"
STORE_NS = (0, 1, 2_500, 10_000, 65_536, 262_144)
STORE_CAPS = (1_024, 65_536, 524_288)
APPLY_WAVE, APPLY_WAVES = 10_000, 12  # APPLY_BENCH device_arm's shape
# the apply path's widest store calls, every cell of a full cache
# (262,144 of a 524,288-slot cell_ver) and every row (65,536 of row_cl),
# and a steady wave's cells
STORE_TIMED = ((262_144, 524_288), (65_536, 65_536), (APPLY_WAVE, 524_288))
# n of three times the threads an H100 holds at once (132 SMs x 2048),
# plus 17: the write grid's first blocks are scheduled, and wait, while
# claim blocks of later waves have yet to run
STORE_WIDE = 3 * 132 * 2048 + 17
CACHE_METRICS = ("corro_apply_cache_hits_total",
                 "corro_apply_cache_misses_total",
                 "corro_apply_cache_evictions_total",
                 "corro_apply_cache_invalidations_total")


def store_case(g, cap: int, n: int, kind: str):
    """(base [cap], idx [n], vals [n]) int64: ``kind`` "unique" draws
    distinct indices, "repeat" with replacement (the last one repeats
    the first, with another value), "same" one index n times."""
    base = g.integers(-5, 1 << 40, cap)
    if kind == "unique":
        idx = g.permutation(cap)[:n]
    elif kind == "same":
        idx = np.full(n, g.integers(0, cap))
    else:
        idx = g.integers(0, cap, n)
        if n > 1:
            idx[-1] = idx[0]
    vals = g.integers(-(1 << 62), 1 << 62, n)
    return base, idx.astype(np.int64), vals


def store_checks(dev) -> list:
    """Phase 16a: ``store_set`` and ``store_gather`` against their
    plain versions and NumPy on the card, bitwise, at every (cap, n) of
    the apply path's range, unique and repeated indices (the last pair
    wins), n = 0 and 1; one index repeated n times; ``STORE_WIDE``
    pairs into 2**20, repeated and unique; an index out of range must
    raise ``IndexError`` and leave the array untouched; the owner
    buffer must come back all -1 after every call."""
    from corrosion_tpu_torch.kernels import store as kst

    g = np.random.default_rng(16)
    checks = []
    wide = STORE_WIDE
    cases = [(cap, n, kind) for cap in STORE_CAPS for n in STORE_NS
             for kind in ("unique", "repeat") if kind == "repeat" or n <= cap]
    cases += [(cap, n, "same") for cap in STORE_CAPS for n in (2, 10_000)]
    cases += [(1 << 20, wide, "repeat"), (1 << 20, wide, "unique")]
    owners = {}
    for cap, n, kind in cases:
        if cap not in owners:
            owners[cap] = kst.new_owner(cap, dev)
        owner = owners[cap]
        base, idx, vals = store_case(g, cap, n, kind)
        want = base.copy()
        want[idx] = vals
        arr = torch.from_numpy(base).to(dev)
        plain = arr.clone()
        kst.store_set(arr, idx, vals, owner)
        kst.store_set_plain(plain, torch.from_numpy(idx).to(dev),
                            torch.from_numpy(vals).to(dev))
        got_g = kst.store_gather(arr, idx)
        plain_g = kst.store_gather_plain(
            arr, torch.from_numpy(idx).to(dev)).cpu().numpy()
        torch.cuda.synchronize()
        ok = (torch.equal(arr, plain)
              and np.array_equal(arr.cpu().numpy(), want)
              and np.array_equal(got_g, want[idx])
              and np.array_equal(plain_g, want[idx])
              and bool((owner == -1).all()))
        checks.append(dict(cap=cap, n=n, kind=kind, equal=ok,
                           max_abs_err=max_abs_err(
                               [arr, torch.from_numpy(got_g)],
                               [plain, torch.from_numpy(plain_g)])))
    for cap, owner in owners.items():
        arr = torch.zeros(cap, dtype=torch.int64, device=dev)
        for bad in ([0, cap], [-cap - 1]):
            for call in (lambda: kst.store_gather(arr, np.array(bad)),
                         lambda: kst.store_set(arr, np.array(bad),
                                               np.ones(len(bad)), owner)):
                try:
                    call()
                except IndexError:
                    continue
                fail(f"store kernels: index {bad} into {cap} did not raise")
        if bool(arr.any()):
            fail("store_set wrote before refusing an out-of-range index")
    bad = [c for c in checks if not c["equal"] or c["max_abs_err"] != 0.0]
    if bad:
        fail(f"store kernels differ from their plain versions: {bad}")
    return checks


def store_times(dev, checks: list) -> list:
    """Both store kernels at the apply path's widest calls and a steady
    wave's, unique indices, on device tensors: an event pair around
    each of 30 launches behind a GPU-side sleep that hides the host's
    enqueue (``ms``); the plain versions and
    ``index_select`` / ``index_put_``
    (the library calls that compute the same functions) the same way;
    and the whole wrapper call from host arrays (``call_ms``, events
    over 20 calls: the range check, the host-to-device copies and, for
    the gather, the fetch)."""
    from corrosion_tpu_torch.kernels import store as kst

    def timed(fn):
        return time_inplace_ms(lambda: None, fn, 30)

    g = np.random.default_rng(17)
    err = max(c["max_abs_err"] for c in checks)
    out = []
    for n, cap in STORE_TIMED:
        base, idx, vals = store_case(g, cap, n, "unique")
        arr = torch.from_numpy(base).to(dev)
        idx_d = torch.from_numpy(idx).to(dev)
        vals_d = torch.from_numpy(vals).to(dev)
        owner = kst.new_owner(cap, dev)
        shape = f"n = {n} into cap {cap}, unique indices"
        out.append(dict(
            name="store_gather", max_abs_err=err, shape=shape,
            ms=timed(lambda: kst.gather_launch(arr, idx_d)),
            plain_ms=timed(lambda: kst.store_gather_plain(arr, idx_d)),
            library_ms=timed(lambda: torch.index_select(arr, 0, idx_d)),
            call_ms=time_ms(lambda: kst.store_gather(arr, idx), 20),
            # idx read, one sector of arr a lookup, out written
            bound=(n * (8 + SECTOR + 8), 0)))
        out.append(dict(
            name="store_set", max_abs_err=err, shape=shape,
            ms=timed(lambda: kst.set_launch(arr, idx_d, vals_d, owner)),
            plain_ms=timed(lambda: kst.store_set_plain(arr, idx_d, vals_d)),
            library_ms=timed(lambda: arr.index_put_((idx_d,), vals_d)),
            call_ms=time_ms(lambda: kst.store_set(arr, idx, vals, owner), 20),
            # idx and vals read, one sector of arr written a pair; the
            # owner passes (claim, test-and-reset) add 2 sectors a pair
            bound=(n * (8 + 8 + SECTOR), 0),
            bytes_with_owner=n * (8 + 8 + 3 * SECTOR)))
    for r in out:
        set_bound(r)
    return out


def bench_dump(db) -> dict:
    """tests/test_apply_batched.py ``_dump``'s queries over ``bench``."""
    q = db.conn.execute
    return {
        "data": sorted(q('SELECT * FROM "bench"').fetchall(), key=repr),
        "clock": sorted(q(
            'SELECT pk, cid, col_version, db_version, seq, site_ordinal '
            'FROM "bench__corro_clock"').fetchall()),
        "cl": sorted(q(
            'SELECT pk, cl, db_version, seq, site_ordinal, sentinel '
            'FROM "bench__corro_cl"').fetchall()),
        "sites": q("SELECT ordinal, site_id FROM __corro_sites "
                   "ORDER BY ordinal").fetchall(),
        "impacted": sorted(q("SELECT site_ordinal, db_version FROM "
                             "__corro_versions_impacted").fetchall()),
    }


def cache_state(db) -> dict:
    """The cache's counters, metric series and, per table, its host
    index and store arrays (``to_host``)."""
    dc = db.device_cache
    tables = {}
    for name, tc in dc._tables.items():
        tables[name] = dict(
            pk_slot=dict(tc.pk_slot), next_slot=tc.next_slot,
            caps=(tc.cap_rows, tc.cap_cells, tc.cells_used),
            # copies: the NumPy store's to_host is the live array
            row_cl=np.array(tc.store.to_host(tc.row_cl)),
            cell_ver=np.array(tc.store.to_host(tc.cell_ver)),
            cell_keys=tc.cell_keys.copy(), row_known=tc.row_known.copy(),
            row_present=tc.row_present.copy())
    return dict(stats=dc.stats(), invalidations=dict(dc.invalidations),
                metrics={k: db.metrics.get_counter_sum(k)
                         for k in CACHE_METRICS},
                tables=tables)


def state_diff(a: dict, b: dict, path: str = "") -> list:
    """The keys (paths) where two nested dicts of values and ndarrays
    differ."""
    if a.keys() != b.keys():
        return [path or "keys"]
    out = []
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict) and isinstance(y, dict):
            out += state_diff(x, y, f"{path}{k}.")
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not np.array_equal(x, y):
                out.append(f"{path}{k}")
        elif x != y:
            out.append(f"{path}{k}")
    return out


def local_write(db) -> None:
    """bench.py's mid-flood local write (a whole-cache invalidation)."""
    db.execute("INSERT OR REPLACE INTO bench (id, a) VALUES (?, ?)",
               (-1, "local"))


def capacity_streams() -> dict:
    """The capacity run's batches, made once (port types): the prefill
    (every row of the default cache, 4 cells each, so its cell budget
    exactly), 12 steady waves over 2,500 hot rows and one superseding
    wave over every row, 12 flood waves of fresh rows, and one batch of
    more rows than the cache holds."""
    from corrosion_tpu_torch.profile_tick import (
        APPLY_ROWS,
        APPLY_SITE,
        apply_bench_changes,
    )

    rows, site = APPLY_ROWS, APPLY_SITE
    steady = [apply_bench_changes(APPLY_WAVE, site, 2 + w)
              for w in range(APPLY_WAVES)]
    steady.append(apply_bench_changes(4 * rows, site, 2 + APPLY_WAVES))
    flood = [apply_bench_changes(APPLY_WAVE, site, 1,
                                 row_offset=rows + w * (APPLY_WAVE // 4))
             for w in range(APPLY_WAVES)]
    evict = apply_bench_changes(4 * (rows + 1), site, 1,
                                row_offset=rows + APPLY_WAVES * APPLY_WAVE)
    return dict(prefill=[apply_bench_changes(4 * rows, site, 1)],
                steady=steady, flood=flood, eviction=[evict])


def run_capacity(db, streams: dict, on_segment) -> dict:
    """Apply every capacity segment in order (a local write before flood
    wave 6), each ending in ``flush_barrier()``; ``on_segment(name)``
    after each.  Returns the host-clock wall of each segment."""
    walls = {}
    for name, batches in streams.items():
        t0 = time.perf_counter()
        for w, batch in enumerate(batches):
            if name == "flood" and w == APPLY_WAVES // 2:
                local_write(db)
            db.apply_changes_batched(batch)
        db.flush_barrier()
        walls[name] = time.perf_counter() - t0
        on_segment(name)
    return walls


def capacity_arm(path: str, mode: str) -> dict:
    """One arm of the capacity run at ``path``: ``"torch"``,
    ``enable_device_cache()`` with its defaults (the store must be on
    the card), or ``"numpy"``, the NumPy store.  Makes its own streams
    and returns its changes per segment, its segment walls and, after
    each segment, the cache's state (and the state dump after the steady
    and the last segments)."""
    from corrosion_tpu_torch.profile_tick import bench_conn

    streams = capacity_streams()
    db = bench_conn(path, {} if mode == "torch" else {"backend": "numpy"})
    snaps = {}

    def on_segment(name):
        dump = bench_dump(db) if name in ("steady", "eviction") else None
        snaps[name] = (dump, cache_state(db))

    try:
        dc = db.device_cache
        if mode == "torch" and (dc.backend != "torch"
                                or dc.store.device.type != "cuda"):
            fail(f"enable_device_cache() chose {dc.backend} on "
                 f"{getattr(dc.store, 'device', 'the host')}, not the card")
        walls = run_capacity(db, streams, on_segment)
        on_card = all(t.row_cl.is_cuda and t.cell_ver.is_cuda
                      for t in dc._tables.values()) if mode == "torch" \
            else None
    finally:
        db.close()
    return dict(changes={k: sum(len(b) for b in v)
                         for k, v in streams.items()},
                walls=walls, snaps=snaps, on_card=on_card)


def bench_scenarios() -> dict:
    """APPLY_BENCH ``device_arm``'s two scenarios (bench.py:538):
    (prefill or None, waves)."""
    from corrosion_tpu_torch.profile_tick import APPLY_SITE, \
        apply_bench_changes

    site = APPLY_SITE
    return {
        "steady": (apply_bench_changes(APPLY_WAVE, site, 1),
                   [apply_bench_changes(APPLY_WAVE, site, 2 + w)
                    for w in range(APPLY_WAVES)]),
        "flood": (None, [apply_bench_changes(APPLY_WAVE, site, 1,
                                             row_offset=w * (APPLY_WAVE // 4))
                         for w in range(APPLY_WAVES)]),
    }


def bench_arm(path: str, mode: str, prefill, waves) -> dict:
    """One arm of bench.py ``_apply_device_arm``'s scenario: the wall of
    its waves with the final ``flush_barrier()`` (host clock), its state
    dump and, on the device arms, the cache's state."""
    from corrosion_tpu_torch.profile_tick import bench_conn

    cache = {"torch": {}, "numpy": {"backend": "numpy"}}.get(mode)
    db = bench_conn(path, cache)
    try:
        if prefill is not None:
            db.apply_changes_batched(prefill)
            db.flush_barrier()
        t0 = time.perf_counter()
        for w, batch in enumerate(waves):
            if prefill is None and w == APPLY_WAVES // 2:
                local_write(db)
            if mode == "per_change":
                with db.apply_tx():
                    db.apply_changes_sequential_in_tx(list(batch))
            else:
                db.apply_changes_batched(batch)
        db.flush_barrier()
        out = dict(wall_s=time.perf_counter() - t0, dump=bench_dump(db))
        if db.device_cache is not None:
            out["cache"] = cache_state(db)
        return out
    finally:
        db.close()


def bench_reference_arms(tmp: str) -> dict:
    """The APPLY_BENCH scenarios' per-change, batched and NumPy-store
    arms, {scenario: {mode: bench_arm's result}}."""
    return {name: {mode: bench_arm(f"{tmp}/bench-{name}-{mode}.db", mode,
                                   prefill, waves)
                   for mode in ("per_change", "batched", "numpy")}
            for name, (prefill, waves) in bench_scenarios().items()}


def apply_phase(counted: dict, tmp: str) -> dict:
    """Phase 16b: the device-resident apply through the port's
    ``CrConn`` with ``enable_device_cache()`` (defaults: the torch store
    on the card), held to a ``CrConn`` on the NumPy store and, at the
    APPLY_BENCH shape, to one with no cache and to the per-change
    oracle.  The arms it is held to run in two spawned worker processes
    beside the torch store's arms, which run here (the host work is
    SQLite and Python, a core each); every wall is its own arm's."""
    record = {}
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=2, mp_context=spawn) as pool:
        ref_bench = pool.submit(bench_reference_arms, tmp)
        ref_cap = pool.submit(capacity_arm, f"{tmp}/cap-numpy.db", "numpy")
        torch_bench = {name: bench_arm(f"{tmp}/bench-{name}-torch.db",
                                       "torch", prefill, waves)
                       for name, (prefill, waves)
                       in bench_scenarios().items()}
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        cap = capacity_arm(f"{tmp}/cap-torch.db", "torch")
        torch.cuda.synchronize()
        launches = {k: counted[k].launches for k in (
            "store_set", "store_gather", "seg_argsort", "seg_cummax",
            "winners_a", "winners_b")}
        bench = ref_bench.result()
        cap_numpy = ref_cap.result()

    # APPLY_BENCH device_arm's scenarios: four arms each, equal state
    for name, arms in bench.items():
        arms["torch"] = torch_bench[name]
        want = arms["per_change"]["dump"]
        for mode, arm in arms.items():
            got = arm.pop("dump")
            if got != want:
                fail(f"apply {name}: the {mode} arm's state differs from "
                     "the per-change oracle's in "
                     f"{[k for k in want if got[k] != want[k]]}")
        diff = state_diff(arms["torch"]["cache"], arms["numpy"]["cache"])
        if diff:
            fail(f"apply {name}: the torch store's cache differs from "
                 f"the NumPy store's in {diff}")
        record[f"bench_{name}"] = {
            "walls_s": {m: a["wall_s"] for m, a in arms.items()},
            "cache": arms["torch"]["cache"]["stats"],
            "metrics": arms["torch"]["cache"]["metrics"]}
        print(f"apply {name} (APPLY_BENCH shape): per-change == batched == "
              f"numpy store == torch store; " + json.dumps(
                  record[f"bench_{name}"]), flush=True)

    # the capacity run: torch store (the main path) against NumPy store
    for name in cap["snaps"]:
        (dump_t, cache_t), (dump_n, cache_n) = (cap["snaps"][name],
                                                cap_numpy["snaps"][name])
        if dump_t is not None and dump_t != dump_n:
            fail(f"apply capacity {name}: the torch store's state differs "
                 "from the NumPy store's in "
                 f"{[k for k in dump_n if dump_t[k] != dump_n[k]]}")
        diff = state_diff(cache_t, cache_n)
        if diff:
            fail(f"apply capacity {name}: the caches differ in {diff}")
    idle = [k for k, c in launches.items() if c == 0]
    if idle or not cap["on_card"]:
        fail(f"apply capacity: kernels never launched {idle} or arrays "
             f"off the card (on card: {cap['on_card']})")
    record["capacity"] = dict(
        changes=cap["changes"],
        walls_s={"torch": cap["walls"], "numpy": cap_numpy["walls"]},
        stats={name: snap[1]["stats"] for name, snap in cap["snaps"].items()},
        launches=launches)
    print("apply capacity run (torch store == NumPy store per segment): "
          + json.dumps(record["capacity"]), flush=True)
    return record


def apply_phases(record: dict, counted: dict, tmp: str,
                 earlier: list) -> list:
    """Phase 16: the store kernels, then the apply path; returns the
    store kernels' results with the capacity run's launches, and adds
    that run's winner-selection launches to their results in
    ``earlier``."""
    cuda = torch.device("cuda")
    checks = store_checks(cuda)
    record["store_checks"] = checks
    record["store_times"] = store_times(cuda, checks)
    widest = f"n = {STORE_TIMED[0][0]} into cap {STORE_TIMED[0][1]}"
    results = [dict(r) for r in record["store_times"]
               if r["shape"].startswith(widest)]
    print(f"store kernels match their plain versions and NumPy in "
          f"{len(checks)} cases; " + json.dumps(record["store_times"]),
          flush=True)
    t0 = time.perf_counter()
    record["apply"] = apply_phase(counted, tmp)
    record["apply"]["phase_s"] = time.perf_counter() - t0
    launches = record["apply"]["capacity"]["launches"]
    replaces = {"store_set": "corrosion_tpu/ops/devcache.py:143",
                "store_gather": "corrosion_tpu/ops/devcache.py:155"}
    for r in results:
        r.update(route="cuda", source=STORE_SOURCE,
                 replaces=replaces[r["name"]], launches=launches[r["name"]])
    for r in earlier:
        if r["name"] in launches:
            r["launches"] += launches[r["name"]]
    return results


# -- phases 17-19: the multi-device layouts ----------------------------

FABRIC_SOURCE = "corrosion_tpu_torch/kernels/csrc/fabric.cu"
DELIVER_SOURCE = "corrosion_tpu_torch/kernels/csrc/deliver_perm.cu"
SHARD_SOURCE = "corrosion_tpu_torch/kernels/csrc/exact_send.cu"
# BENCH_FRONTIER.json "headline": host-sparse on 2 hosts, 2 seeds.  Its
# ticks and p99 hold; its msgs mean (19.12) does not.  The reference's
# statistics over this run's per-node msgs on a 2-host CPU mesh give
# HOST_SEED_MEANS (``python -m tests.test_torch_sharded_exact`` over
# HOST_MSGS, which phase 18 writes), and the reference's own host-sparse
# run at this point on the CPU gives their mean, 19.1469
# (``python -m tests.test_torch_sharded_exact --reference-run 10000000``)
HOST_WANT = {"converged_frac": 1.0, "ticks_p50": 13.0, "ticks_p99": 13.0,
             "msgs_per_node_mean": 19.15, "msgs_per_node_p99": 33.0,
             "n_hosts": 2}
HOST_SEED_MEANS = (19.171838760375977, 19.121925354003906)
HOST_MSGS = os.path.join(HERE, "corrosion_tpu_torch", "kernels", "build",
                         "host_msgs_10m.npz")
MESH_COUNTED = ("shard_round", "shard_commit", "exact_commit", "sync_pull",
                "tick_stats", "threefry_bits")
HOST_COUNTED = MESH_COUNTED + ("bits_pack_above", "bits_pack_active",
                               "bits_unpack", "bits_unpack_add")
FABRIC_COUNTED = {"all_gather": ("deliver_perm", "seg_argsort",
                                 "threefry_bits"),
                  "ring": ("route_pack", "ring_receive", "seg_argsort",
                           "threefry_bits")}
SHARD_TICKS = (1, BUSY_TICK)


def mesh_cfgs():
    """(label, config, seeds, axis, shards, sparse, host-sharded) of the
    three full-width mesh runs (phase 18)."""
    from corrosion_tpu_torch.sim import calibrate as cal

    return (
        ("host_sparse_10m", cal.headline_exact_cfg(10_000_000, False), 2,
         "hosts", 2, True, True),
        ("sharded_sparse_1m", cal.EXACT_SPARSE, 4, "nodes", 8, True, False),
        ("sharded_dense_100k", cal.EXACT_DENSE, 4, "nodes", 8, False,
         False),
    )


# route_pack's bitwise cases (phase 17a): (label, nodes, shards, maps,
# R, shards packed, caps, active senders, words that rows_l and the
# outputs lie past a 16-byte boundary, None for fresh tensors).  The
# fabrics' own maps and state at every cap edge and the first, a middle
# and the last shard; no sender and every sender active; one, two and
# 64 destinations (two: the host layout's width; 64: more than the
# warp that sums the overflow); one map; a shard of
# 12,497 rows (no multiple of the kernel's 256-row tile); R = 4 (one
# 16-byte word a row, outputs between sentinel words) and R = 6 and 8
# with rows_l 4 bytes past a boundary (a lane an int)
ROUTE_CASES = (
    ("fabric", 100_000, 8, 4, 8, (0, 3, 7), (1, 256, 12_500), "state",
     None),
    ("no sender active", 100_000, 8, 4, 8, (3,), (256, 12_500), "none",
     None),
    ("every sender active", 100_000, 8, 4, 8, (3,), (256, 12_500), "all",
     None),
    ("D = 1", 100_000, 1, 4, 8, (0,), (256, 100_000), "state", None),
    ("D = 2", 100_000, 2, 4, 8, (0, 1), (256, 50_000), "state", None),
    ("D = 64", 99_968, 64, 4, 8, (0, 63), (16, 1562), "state", None),
    ("K = 1", 100_000, 8, 1, 8, (3,), (256, 12_500), "state", None),
    ("ragged tiles", 99_976, 8, 4, 8, (0, 7), (1, 256, 12_497), "state",
     None),
    ("R = 4", 100_000, 8, 4, 4, (3,), (256, 12_500), "state", (0, 4)),
    ("R = 6", 100_000, 8, 4, 6, (3,), (1, 256, 12_500), "state", (1, 1)),
    ("R = 8 unaligned", 100_000, 8, 4, 8, (3,), (256, 12_500), "state",
     (1, 1)),
)


def placed(shape, off: int, dev):
    """(buffer, view): a contiguous int32 ``shape`` view ``off`` words
    into a buffer of sentinels four words longer than it."""
    size = math.prod(shape)
    buf = torch.full((size + off + 4,), SENTINEL, dtype=torch.int32,
                     device=dev)
    return buf, buf[off:off + size].view(shape)


def route_case_state(g, n: int, k: int, r: int, act: str, fabric, dev):
    """One ``ROUTE_CASES`` layout's maps [K, N], loss draws [N, K], rows
    [N, R], budgets and msgs [N]: the fabrics' own (``fabric``: senders,
    draws, rows, tx, msgs at their width) where the layout has their N
    (and R), else drawn from ``g``; budgets forced to 3 or 0 where
    ``act`` is "all" or "none"."""
    from corrosion_tpu_torch.profile_tick import FABRIC_N, FABRIC_R

    senders, loss_u, rows, tx, msgs = fabric
    if n == FABRIC_N:
        maps, draws = senders[:k], loss_u[:, :k].contiguous()
    else:
        maps = torch.randint(0, n, (k, n), generator=g,
                             dtype=torch.int32).to(dev)
        draws = torch.rand((n, k), generator=g).to(dev)
    if n == FABRIC_N and r == FABRIC_R:
        keys, budget, sent = rows, tx, msgs
    else:
        keys = torch.randint(0, 1 << 20, (n, r), generator=g,
                             dtype=torch.int32).to(dev)
        budget = torch.where(torch.rand(n, generator=g) < 0.33,
                             torch.randint(1, 9, (n,), generator=g),
                             0).to(torch.int32).to(dev)
        sent = torch.randint(0, 99, (n,), generator=g,
                             dtype=torch.int32).to(dev)
    if act != "state":
        budget = torch.full((n,), 3 if act == "all" else 0,
                            dtype=torch.int32, device=dev)
    return maps, draws, keys, budget, sent


def route_pack_cases(fabric, dev, parent=None):
    """Phase 17a's ``route_pack`` cases (``ROUTE_CASES``), each bitwise
    ``route_pack_plain`` and, with ``parent``, the parent's kernel, the
    sentinels around placed outputs untouched and the kernel's marks
    all zero after every call (``fabric`` as ``route_case_state``
    takes it); returns (worst error, cases)."""
    from corrosion_tpu_torch.kernels import fabric as kf

    g = torch.Generator(device="cpu").manual_seed(15)
    worst, cases = 0.0, []
    for label, n, d, k, r, shards, caps, act, offs in ROUTE_CASES:
        nl = n // d
        maps, _, keys, budget, _ = route_case_state(g, n, k, r, act, fabric,
                                                    dev)
        busy = budget > 0
        for sh, cap in ((sh, cap) for sh in shards for cap in caps):
            w = slice(sh * nl, (sh + 1) * nl)
            active_l, rows_l = busy[w].contiguous(), keys[w].contiguous()
            bufs = []
            if offs is None:
                got = kf.route_pack(maps, active_l, rows_l, sh, cap)
            else:
                rows_l = placed((nl, r), offs[0], dev)[1].copy_(rows_l)
                bufs = [placed(shape, offs[1], dev)
                        for shape in ((d, cap), (d, cap, r), (1,))]
                got = kf._pack_into(maps, active_l, rows_l, sh,
                                        *(v for _, v in bufs))
            want = kf.route_pack_plain(maps, active_l, rows_l, sh, cap)
            err = max_abs_err(got, want)
            if parent is not None:
                err = max(err, max_abs_err(
                    got, parent.route_pack(maps, active_l, rows_l, sh, cap)))
            for buf, view in bufs:
                off = offs[1]
                if not (bool((buf[:off] == SENTINEL).all())
                        and bool((buf[off + view.numel():]
                                  == SENTINEL).all())):
                    fail(f"route_pack {label} wrote past its outputs")
            if not kf.marks_clear(got[0].device, nl, d):
                fail(f"route_pack {label} left marks set")
            if err:
                fail(f"route_pack {label}, shard {sh}, cap {cap} differs "
                     f"from its plain version or the parent's: {err}")
            worst = max(worst, err)
            cases.append(dict(kernel="route_pack", case=label, shard=sh,
                              cap=cap, overflow=int(want[2]),
                              max_abs_err=err))
    return worst, cases


def source_delivery_bytes(maps, draws, loss: float, slot_of, r: int) -> int:
    """The bytes a delivery from a source must move for the receivers
    whose K sender ids ``maps`` [K, n] and loss draws ``draws`` [n, K]
    are given, through ``slot_of``: each receiver's row, tx and msgs
    read and written, its K ids and draws read, a random sector for
    each of its K slots, and one for each row it takes (present and not
    lost)."""
    k, n = maps.shape
    taken = (slot_of[maps.to(torch.int64)] >= 0) & ~(draws.T < loss)
    return (n * (2 * r * 4 + 4 * 4) + n * k * 8 + n * k * SECTOR
            + int(taken.sum()) * max(r * 4, SECTOR))


def received_for(maps, busy, keys, sh: int, d: int, cap: int):
    """Shard ``sh``'s (recv_ids [d, cap], recv_rows [d, cap, R]) as the
    all_to_all hands every source shard's ``route_pack`` buffers to it."""
    from corrosion_tpu_torch.kernels import fabric

    nl = keys.shape[0] // d
    sends = [fabric.route_pack(maps, busy[e * nl:(e + 1) * nl],
                               keys[e * nl:(e + 1) * nl], e, cap)
             for e in range(d)]
    return (torch.stack([sends[e][0][sh] for e in range(d)]),
            torch.stack([sends[e][1][sh] for e in range(d)]))


def ring_receive_cases(fabric, dev, parent=None):
    """Phase 17a's ``ring_receive`` cases: in every ``ROUTE_CASES``
    layout, each of its shards and caps receives every source shard's
    ``route_pack`` buffers and delivers them through ``ring_receive``,
    bitwise ``ring_receive_plain`` (``route_slots_plain`` and
    ``deliver_perm_plain``) and, with ``parent``, the parent's
    ``ring_receive``, its flag clear; every call
    finds the earlier calls' tags in the one slot map.  Then four
    broken orders of received ids (two ids swapped, an id after the
    pads, an id of another shard's rows, a pad other than -1), which
    the kernel and ``route_order_bad`` must both flag.  ``fabric`` is
    as ``route_case_state`` takes it.  Returns (worst error, cases)."""
    from corrosion_tpu_torch.kernels import fabric as kf
    from corrosion_tpu_torch.profile_tick import FABRIC_N

    g = torch.Generator(device="cpu").manual_seed(16)
    worst, cases = 0.0, []
    for label, n, d, k, r, shards, caps, act, _ in ROUTE_CASES:
        nl = n // d
        maps, draws, keys, budget, sent = route_case_state(
            g, n, k, r, act, fabric, dev)
        for sh, cap in ((sh, cap) for sh in shards for cap in caps):
            w = slice(sh * nl, (sh + 1) * nl)
            mine = (keys[w].contiguous(), budget[w].contiguous(),
                    sent[w].contiguous(), maps)
            recv = received_for(maps, budget > 0, keys, sh, d, cap)
            kw = dict(loss_u=draws, loss=0.05, max_tx=8, lo=sh * nl)
            got = kf.ring_receive(*mine, *recv, **kw)
            err = max_abs_err(got, kf.ring_receive_plain(*mine, *recv, **kw))
            if parent is not None:
                err = max(err, max_abs_err(got[:3], parent.ring_receive(
                    *mine, *recv, draws, 0.05, 8, sh * nl)))
            if err or int(got[3]):
                fail(f"ring_receive {label}, shard {sh}, cap {cap} differs "
                     f"from its plain version or the parent's, or flags "
                     f"route_pack's order: {err}, {int(got[3])}")
            worst = max(worst, err)
            cases.append(dict(kernel="ring_receive", case=label, shard=sh,
                              cap=cap, received=int((recv[0] >= 0).sum()),
                              max_abs_err=err))
    # broken orders at the fabric's shard 3, cap 12,500
    senders, loss_u, rows, tx, msgs = fabric
    n, d = FABRIC_N, 8
    nl, sh = n // d, 3
    w = slice(sh * nl, (sh + 1) * nl)
    mine = (rows[w].contiguous(), tx[w].contiguous(), msgs[w].contiguous(),
            senders)
    ids, recv_rows = received_for(senders, tx > 0, rows, sh, d, nl)
    kw = dict(loss_u=loss_u, loss=0.05, max_tx=8, lo=sh * nl)
    last = int((ids[5] >= 0).sum()) - 1
    for label, e, at, value in (
            ("swapped", 2, 1, int(ids[2, 0])),
            ("after the pads", 5, last + 2, int(ids[5, last]) + 1),
            ("another shard's row", 6, 0, int(ids[1, 0])),
            ("a pad not -1", 4, int((ids[4] >= 0).sum()), -2)):
        bad = ids.clone()
        if label == "swapped":
            bad[e, 0] = ids[e, 1]
        bad[e, at] = value
        got = kf.ring_receive(*mine, bad, recv_rows, **kw)[3]
        want = kf.ring_receive_plain(*mine, bad, recv_rows, **kw)[3]
        if int(got) != 1 or int(want) != 1:
            fail(f"ring_receive did not flag ids out of route_pack's order "
                 f"({label}): kernel {int(got)}, plain {int(want)}")
        cases.append(dict(kernel="ring_receive", case=f"order: {label}",
                          shard=sh, cap=nl, flagged=True))
    return worst, cases


# phase 17a's validity wire: the host layout's shapes (10M nodes x 2
# seeds over 2 hosts) and odd ones; each case's input and output offsets
# in bytes (int32 buffers: in elements), the first pair the aligned one
VALIDITY_HOST = (2, 10_000_000)
VALIDITY_ODD = ((3, 8), (7, 24), (1, 4096), (5, 1000))
VALIDITY_OFFSETS = ((0, 0), (3, 4), (8, 1), (1, 3))
VALIDITY_PAD = 64  # sentinel bytes (or int32 words) around each output
VALIDITY_TICK = 7
VALIDITY_SOURCE = "corrosion_tpu/models/sharded.py"
VALIDITY_KERNELS = ("bits_pack", "bits_pack_above", "bits_pack_active",
                    "bits_unpack", "bits_unpack_add")


def validity_inputs(s: int, m: int, dev, g):
    """Seeded inputs of one shape: the still-bad rows' rounds [s, m]
    int32, a mask [s, m], the replicated infected [s, 2m] with tx and
    next_send [s, m] of the window at m (the host layout's shard 1),
    and wires [s, m / 8] dense (a fifth of the bits) and sparse (a
    bit in about 600)."""
    def bools(shape, p):
        return (torch.rand(shape, generator=g) < p).to(dev)

    return dict(
        rounds=torch.randint(0, 4, (s, m), generator=g,
                             dtype=torch.int32).to(dev),
        mask=bools((s, m), 0.2),
        infected=bools((s, 2 * m), 0.5),
        tx=torch.randint(0, 3, (s, m), generator=g,
                         dtype=torch.int32).to(dev),
        next_send=torch.randint(0, 2 * VALIDITY_TICK, (s, m), generator=g,
                                dtype=torch.int32).to(dev),
        wire=torch.randint(0, 256, (s, m // 8), generator=g).to(
            torch.uint8).to(dev),
        sparse=(torch.randint(0, 256, (s, m // 8), generator=g)
                * (torch.rand((s, m // 8), generator=g) < 0.02)).to(
            torch.uint8).to(dev))


def validity_cases(x: dict, dev) -> tuple:
    """The five entry points' direct launches on ``x``'s shape at every
    ``VALIDITY_OFFSETS`` pair, into sentinel-padded outputs (inputs at
    the offsets too: copies inside sentinel-padded buffers), against
    the plain versions: {name: max |diff|}, the cases, and the failures
    (a difference, a sentinel overwritten, a wrong count, the count
    scratch left set)."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.kernels import fabric as kf

    s, m = x["rounds"].shape
    nb = s * m // 8
    p = kernels.ptr
    scratch = kf._count_scratch(dev)
    errs = dict.fromkeys(VALIDITY_KERNELS, 0.0)
    cases, bad = [], []

    def at(t, off):
        """A copy of ``t`` ``off`` elements into a buffer of its dtype."""
        buf = torch.empty(t.numel() + off + VALIDITY_PAD, dtype=t.dtype,
                          device=dev)
        view = buf[off:off + t.numel()]
        view.copy_(t.reshape(-1))
        return view.view(t.shape)

    def out(nbytes, off, dtype=torch.uint8):
        """(buffer, output view) with sentinels around the view."""
        sent = SENTINEL if dtype == torch.int32 else 0x7F
        buf = torch.full((off + nbytes + VALIDITY_PAD,), sent, dtype=dtype,
                         device=dev)
        return buf, buf[off:off + nbytes]

    def kept(buf, off, nbytes):
        sent = SENTINEL if buf.dtype == torch.int32 else 0x7F
        return bool((buf[:off] == sent).all()) and bool(
            (buf[off + nbytes:] == sent).all())

    def compare(name, label, got, want, buf, off, nbytes, count=None,
                want_count=None):
        err = max_abs_err([got.reshape(-1).to(torch.int32)],
                          [want.reshape(-1).to(torch.int32)])
        errs[name] = max(errs[name], err)
        row = dict(kernel=name, case=label, shape=(s, m), err=err,
                   sentinels=kept(buf, off, nbytes))
        if count is not None:
            row["count"] = int(count)
            row["count_ok"] = int(count) == int(want_count)
            row["scratch_zero"] = not bool(scratch.any())
        cases.append(row)
        if err or not row["sentinels"] or not row.get("count_ok", True) \
                or not row.get("scratch_zero", True):
            bad.append(row)

    def fn(symbol, argtypes):
        return kernels.function("fabric", symbol, argtypes)

    for i_off, o_off in VALIDITY_OFFSETS:
        label = f"in +{i_off}, out +{o_off}"
        stream = kernels.stream(x["rounds"])
        # bits_pack: the mask at a byte offset, the wire at a byte offset
        mask = at(x["mask"], i_off)
        buf, wire = out(nb, o_off)
        kernels.raise_on_error("bits_pack", fn(
            "bits_pack_launch", kf._PACK_ARGTYPES)(
                p(mask), p(wire), nb, stream))
        compare("bits_pack", label, wire, kf.bits_pack_plain(x["mask"]),
                buf, o_off, nb)
        # bits_pack_above: x at an int32 offset, the wire 4-byte aligned
        rounds = at(x["rounds"], i_off)
        w_off = 4 * (o_off % 3)
        buf, wire = out(nb, w_off)
        kernels.raise_on_error("bits_pack_above", fn(
            "bits_pack_above_launch", kf._ABOVE_ARGTYPES)(
                p(rounds), 1, p(wire), s * m, stream))
        compare("bits_pack_above", label, wire,
                kf.bits_pack_above_plain(x["rounds"], 1), buf, w_off, nb)
        # bits_pack_active: the window at column m, or m - i_off, of the
        # replicated mask; both outputs padded
        lo = m - min(i_off, m - 1) if i_off else m
        window = x["infected"][:, lo:lo + m]
        a_buf, active = out(s * m, o_off)
        w_buf, wire = out(nb, w_off)
        kernels.raise_on_error("bits_pack_active", fn(
            "bits_pack_active_launch", kf._ACTIVE_ARGTYPES)(
                p(window), window.stride(0), p(x["tx"]), p(x["next_send"]),
                VALIDITY_TICK, p(active), p(wire), s, m, stream))
        want_a, want_w = kf.bits_pack_active_plain(
            window, x["tx"], x["next_send"], VALIDITY_TICK)
        compare("bits_pack_active", f"{label}, window at {lo}", active,
                want_a, a_buf, o_off, s * m)
        compare("bits_pack_active", f"{label} (wire)", wire, want_w, w_buf,
                w_off, nb)
        # bits_unpack with its count: the wire at a byte offset
        src = at(x["wire"], i_off)
        buf, mask_out = out(s * m, o_off)
        count = torch.empty(1, dtype=torch.int32, device=dev)
        kernels.raise_on_error("bits_unpack", fn(
            "bits_unpack_launch", kf._UNPACK_ARGTYPES)(
                p(src), p(mask_out), nb, p(scratch), p(count), stream))
        want = kf.bits_unpack_plain(x["wire"], m)
        compare("bits_unpack", label, mask_out, want, buf, o_off, s * m,
                count, want.sum())
        # bits_unpack_add: a first round over the sentinels' neighbours,
        # then a dense and a sparse later round; accepted at an int32
        # offset, the wires at byte offsets
        buf, acc = out(s * m, o_off, torch.int32)
        plain = torch.full((s, m), 9, dtype=torch.int32, device=dev)
        for r, key in enumerate(("wire", "wire", "sparse")):
            src = at(x[key], i_off)
            kernels.raise_on_error("bits_unpack_add", fn(
                "bits_unpack_add_launch", kf._UNPACK_ADD_ARGTYPES)(
                    p(src), p(acc), nb, int(r == 0), p(scratch), p(count),
                    stream))
            want_c = kf.bits_unpack_add_plain(x[key], m, plain, r == 0)
            compare("bits_unpack_add", f"{label}, round {r} ({key})", acc,
                    plain, buf, o_off, s * m, count, want_c)
    return errs, cases, bad


def validity_wrapper_cases(x: dict, dev) -> tuple:
    """The five wrappers as the host layout calls them, on ``x``'s
    shape: my [s, m] rows packed (``bits_pack_active`` on the window at
    m of the replicated [s, 2m] mask, both outputs), the wire of both
    shards (``x``'s wires side by side) unpacked to [s, 2m],
    ``bits_unpack`` with its count, ``bits_unpack_add`` in a first round
    over a filled ``accepted`` and then a sparse later one with their
    returned counts; each output bitwise its plain version on the same
    inputs and the count scratch zero after each unpack.  Returns
    ({name: max |diff|}, the cases, the failures)."""
    from corrosion_tpu_torch.kernels import fabric as kf

    s, m = x["rounds"].shape
    wire = torch.cat([x["wire"], x["wire"]], dim=1)
    sparse = torch.cat([x["sparse"], x["sparse"]], dim=1)
    window = x["infected"][:, m:]
    scratch = kf._count_scratch(dev)
    errs = dict.fromkeys(VALIDITY_KERNELS, 0.0)
    cases, bad = [], []

    def compare(name, label, got, want, count=None, want_count=None):
        err = max_abs_err([got.reshape(-1).to(torch.int32)],
                          [want.reshape(-1).to(torch.int32)])
        errs[name] = max(errs[name], err)
        row = dict(kernel=name, case=f"wrapper, {label}", shape=(s, m),
                   err=err)
        if count is not None:
            row["count"] = int(count)
            row["count_ok"] = int(count) == int(want_count)
            row["scratch_zero"] = not bool(scratch.any())
        cases.append(row)
        if err or not row.get("count_ok", True) \
                or not row.get("scratch_zero", True):
            bad.append(row)

    compare("bits_pack", "mask", kf.bits_pack(x["mask"]),
            kf.bits_pack_plain(x["mask"]))
    compare("bits_pack_above", "rounds > 1", kf.bits_pack_above(
        x["rounds"], 1), kf.bits_pack_above_plain(x["rounds"], 1))
    got = kf.bits_pack_active(window, x["tx"], x["next_send"],
                              VALIDITY_TICK)
    want = kf.bits_pack_active_plain(window, x["tx"], x["next_send"],
                                     VALIDITY_TICK)
    compare("bits_pack_active", f"window at {m}", got[0], want[0])
    compare("bits_pack_active", f"window at {m} (wire)", got[1], want[1])
    count = torch.empty(1, dtype=torch.int32, device=dev)
    want = kf.bits_unpack_plain(wire, 2 * m)
    compare("bits_unpack", f"to [{s}, {2 * m}]",
            kf.bits_unpack(wire, 2 * m, count=count), want, count,
            want.sum())
    acc = torch.full((s, 2 * m), 9, dtype=torch.int32, device=dev)
    plain = acc.clone()
    for r, w in enumerate((wire, sparse)):
        got = kf.bits_unpack_add(w, 2 * m, acc, r == 0)
        want = kf.bits_unpack_add_plain(w, 2 * m, plain, r == 0)
        compare("bits_unpack_add", f"round {r} into [{s}, {2 * m}]", acc,
                plain, got, want)
    return errs, cases, bad


def validity_graph_check(dev) -> dict:
    """The unpacks' counts under CUDA graph replay: one graph of
    ``bits_unpack_add`` (first round) and ``bits_unpack`` with its
    count, captured after a warm call on its stream (so the count
    scratch exists before the capture and no fill is captured), then
    replayed on three wires: the counts and outputs must follow each
    and the scratch be zero after each replay."""
    from corrosion_tpu_torch.kernels import fabric as kf

    g = torch.Generator(device="cpu").manual_seed(8)
    s, m = 3, 4096
    wires = [torch.randint(0, 256, (s, m // 8), generator=g).to(
        torch.uint8).to(dev) for _ in range(2)]
    wires.append(torch.zeros_like(wires[0]))
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        wire = wires[0].clone()
        acc = torch.empty((s, m), dtype=torch.int32, device=dev)
        count = torch.empty(1, dtype=torch.int32, device=dev)
        kf.bits_unpack_add(wire, m, acc, True)
        kf.bits_unpack(wire, m, count=count)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            c_add = kf.bits_unpack_add(wire, m, acc, True)
            mask = kf.bits_unpack(wire, m, count=count)
        scratch = kf._count_scratch(dev)
    torch.cuda.current_stream(dev).wait_stream(stream)
    replays = []
    for w in wires + wires[:1]:
        wire.copy_(w)
        graph.replay()
        torch.cuda.synchronize()
        want = kf.bits_unpack_plain(w, m)
        replays.append(dict(
            bits=int(want.sum()), add_count=int(c_add), count=int(count),
            equal=torch.equal(mask, want) and torch.equal(
                acc, want.to(torch.int32)),
            scratch_zero=not bool(scratch.any())))
    bad = [r for r in replays if not (
        r["equal"] and r["scratch_zero"]
        and r["add_count"] == r["count"] == r["bits"])]
    if bad:
        fail(f"the unpacks under CUDA graph replay: {replays}")
    return dict(replays=replays)


def validity_kernel_checks(dev, parent=None) -> tuple:
    """Phase 17a, the validity wire: ``bits_pack``, ``bits_pack_above``,
    ``bits_pack_active``, ``bits_unpack`` and ``bits_unpack_add`` each
    bitwise its plain version at the host layout's shapes ([2, 5M]
    packed, the active window [2, 5M] at 5M of the replicated [2, 10M],
    unpacked to [2, 10M]) and at ``VALIDITY_ODD``: through the wrappers
    with their counts (``validity_wrapper_cases``), and by direct
    launches with every input and output at ``VALIDITY_OFFSETS`` (the
    scalar heads and tails) and sentinels around the outputs
    (``validity_cases``), the count scratch checked, and under CUDA
    graph replay; each timed behind a GPU-side
    sleep at the host layout's shapes (``bits_unpack_add`` in a first
    round and in a sparse later one), ``bits_pack`` / ``bits_unpack``
    in turns with ``parent``'s.  Returns (results, cases)."""
    from corrosion_tpu_torch.kernels import fabric as kf

    g = torch.Generator(device="cpu").manual_seed(3)
    s, n = VALIDITY_HOST
    m = n // 2
    errs = dict.fromkeys(VALIDITY_KERNELS, 0.0)
    cases, bad = [], []
    host = None
    for shape in ((s, m), *VALIDITY_ODD):
        x = validity_inputs(*shape, dev, g)
        if shape == (s, m):
            host = x
        for check in (validity_cases, validity_wrapper_cases):
            e, c, b = check(x, dev)
            errs = {k: max(errs[k], e[k]) for k in errs}
            cases += c
            bad += b
        del x
    if bad:
        fail(f"the validity wire differs from its plain versions: "
             f"{bad[:4]}")
    graph = validity_graph_check(dev)
    # the host layout's shapes: my [2, 5M] rows, the wire of all [2, 10M]
    x = host
    wire = torch.cat([x["wire"], x["wire"]], dim=1)
    sparse = torch.cat([x["sparse"], x["sparse"]], dim=1)
    acc = torch.zeros((s, n), dtype=torch.int32, device=dev)
    window = x["infected"][:, m:]
    count = torch.empty(1, dtype=torch.int32, device=dev)
    set_sectors = int((sparse != 0).sum())

    def none():
        pass

    def timer(fn):
        return time_inplace_ms(none, fn, 30)

    nb = s * n // 8
    rows = (
        ("bits_pack", lambda: kf.bits_pack(x["mask"]),
         lambda: kf.bits_pack_plain(x["mask"]),
         parent and (lambda: parent.bits_pack(x["mask"])),
         s * m + nb // 2, f"{VALIDITY_SOURCE}:57", f"[{s}, {m}] bool"),
        ("bits_pack_above", lambda: kf.bits_pack_above(x["rounds"], 1),
         lambda: kf.bits_pack_above_plain(x["rounds"], 1), None,
         4 * s * m + nb // 2, f"{VALIDITY_SOURCE}:679",
         f"[{s}, {m}] int32 > 1"),
        ("bits_pack_active", lambda: kf.bits_pack_active(
            window, x["tx"], x["next_send"], VALIDITY_TICK),
         lambda: kf.bits_pack_active_plain(
             window, x["tx"], x["next_send"], VALIDITY_TICK), None,
         s * m * (1 + 4 + 4 + 1) + nb // 2, f"{VALIDITY_SOURCE}:639",
         f"[{s}, {m}] window at {m} of [{s}, {n}]"),
        ("bits_unpack", lambda: kf.bits_unpack(wire, n, count=count),
         lambda: kf.bits_unpack_plain(wire, n),
         parent and (lambda: parent.bits_unpack(wire, n)),
         nb + s * n, f"{VALIDITY_SOURCE}:68", f"[{s}, {n // 8}] to "
                                              f"[{s}, {n}] bool"),
        ("bits_unpack_add", lambda: kf.bits_unpack_add(wire, n, acc, True),
         lambda: kf.bits_unpack_add_plain(wire, n, acc, True), None,
         nb + 4 * s * n, f"{VALIDITY_SOURCE}:669",
         f"[{s}, {n // 8}] into [{s}, {n}] int32, first round"),
    )
    results = []
    for name, fn, plain, old, nbytes, replaces, shape in rows:
        turns = in_turns(fn, old, timer)
        r = dict(name=name, route="cuda", source=FABRIC_SOURCE,
                 replaces=replaces, max_abs_err=errs[name], ms=turns["ms"],
                 turns=turns, plain_ms=time_inplace_ms(none, plain, 3, 1),
                 bound=(nbytes, 0), library_ms=None, shape=shape)
        results.append(r)
    later = dict(
        ms=timer(lambda: kf.bits_unpack_add(sparse, n, acc, False)),
        bound_ms=bound_ms(nb + 2 * SECTOR * set_sectors, 0)[0],
        set_bytes=set_sectors, shape=f"[{s}, {n // 8}], a later round")
    return results, cases, dict(graph=graph, later_round=later)


def fabric_kernel_checks(dev, parent=None) -> list:
    """Phase 17a: ``bits_pack`` / ``bits_unpack`` at the host layout's
    wire shapes (10M nodes x 2 seeds over 2 hosts) and odd shapes;
    ``route_pack`` in ``ROUTE_CASES``; ``ring_receive`` in the same
    layouts and on broken orders (``ring_receive_cases``); the all_gather
    fabric's delivery (``deliver_perm`` with its identity slot map and a
    receiver window) at the broadcast fabrics' width (shard 3 of 8);
    each bitwise its plain version and timed behind a GPU-side sleep,
    ``route_pack`` and ``ring_receive`` at caps 12,500 and 256 and the
    all_gather delivery in turns with ``parent``'s kernels when
    given."""
    from corrosion_tpu_torch.kernels import deliver, fabric
    from corrosion_tpu_torch.models.sharded import _loss_u, _senders
    from corrosion_tpu_torch.profile_tick import (
        FABRIC_D,
        FABRIC_N,
        FABRIC_R,
        fabric_params,
        fabric_state,
    )
    from corrosion_tpu_torch.random import PRNGKey, split

    results, cases, validity = validity_kernel_checks(dev, parent)

    def none():
        pass

    params = fabric_params()
    n, r, d = FABRIC_N, FABRIC_R, FABRIC_D
    nl, k = n // d, params.fanout
    rows, tx, msgs = fabric_state(dev)
    key_t, key_l = split(PRNGKey(4))
    senders = _senders(key_t, params, dev)
    loss_u = _loss_u(key_l, params, dev)
    sh = 3
    w = slice(sh * nl, (sh + 1) * nl)
    state = (senders, loss_u, rows, tx, msgs)
    route_err, route_cases = route_pack_cases(state, dev, parent)
    cases += route_cases
    active_l = tx[w] > 0
    route_bytes = (k * n * 4 + nl + nl * r * 4 + d * nl * (r + 1) * 4 + 4)
    args = (senders, active_l, rows[w], sh)
    turns = {}
    for cap in (nl, 256):
        turns[cap] = in_turns(
            lambda c=cap: fabric.route_pack(*args, c),
            parent and (lambda c=cap: parent.route_pack(*args, c)),
            lambda fn: time_inplace_ms(none, fn, 20))
    results.append(dict(
        name="route_pack", route="cuda", source=FABRIC_SOURCE,
        replaces="corrosion_tpu/models/sharded.py:216",
        max_abs_err=route_err, ms=turns[nl]["ms"],
        plain_ms=time_inplace_ms(none, lambda: fabric.route_pack_plain(
            *args, nl), 3, 1),
        bound=(route_bytes, 0), library_ms=None, turns=turns,
        shape=f"K={k} x {n} maps, shard {sh} of {d}, cap {nl}, R={r}"))

    # the receive side: ring_receive at shard 3, caps 12,500 and 256, in
    # turns with the parent's
    recv_err, recv_cases = ring_receive_cases(state, dev, parent)
    cases += recv_cases
    mine = (rows[w].contiguous(), tx[w].contiguous(), msgs[w].contiguous(),
            senders)
    rkw = dict(loss_u=loss_u, loss=params.loss,
               max_tx=params.max_transmissions, lo=sh * nl)
    recv, turns = {}, {}
    for cap in (nl, 256):
        recv[cap] = received_for(senders, tx > 0, rows, sh, d, cap)
        turns[cap] = in_turns(
            lambda c=cap: fabric.ring_receive(*mine, *recv[c], **rkw),
            parent and (lambda c=cap: parent.ring_receive(
                *mine, *recv[c], loss_u, params.loss,
                params.max_transmissions, sh * nl)),
            lambda fn: time_inplace_ms(none, fn, 20))
    recv_ids, recv_rows = recv[nl]
    slot_of = fabric.route_slots_plain(recv_ids.reshape(-1), n)
    received = int((recv_ids >= 0).sum())
    results.append(dict(
        name="ring_receive", route="cuda", source=DELIVER_SOURCE,
        replaces="corrosion_tpu/models/sharded.py:253",
        max_abs_err=recv_err, ms=turns[nl]["ms"], turns=turns,
        plain_ms=time_inplace_ms(none, lambda: fabric.ring_receive_plain(
            *mine, recv_ids, recv_rows, **rkw), 3, 1),
        bound=(recv_ids.numel() * 4 + received * SECTOR
               + source_delivery_bytes(senders[:, w], loss_u[w], params.loss,
                                       slot_of, r), 0),
        library_ms=None, received=received,
        shape=f"shard {sh}'s {nl} receivers of {n}, {d} x {nl} slots "
              f"({received} ids), R={r}, K={k}"))

    # the all_gather fabric's delivery: the identity slot map of the
    # active senders through the same kernel
    gather = dict(loss_u=loss_u, loss=params.loss,
                  max_tx=params.max_transmissions, lo=sh * nl, src_rows=rows,
                  slot_of=torch.where(tx > 0, torch.arange(
                      n, dtype=torch.int32, device=dev), -1).to(torch.int32))
    err = max_abs_err(deliver.deliver_perm(*mine, **gather)[:3],
                      deliver.deliver_perm_plain(*mine, **gather)[:3])
    old = None
    if parent is not None:
        full = dict(gather, hops=None, next_send=None, tick=0, wan_u=None,
                    region=None, partition_id=None, sev=None,
                    partition_active=False, tier=None, wan_loss=0.0,
                    backoff=0.0)
        err = max(err, max_abs_err(deliver.deliver_perm(*mine, **gather),
                                   parent.deliver_perm(*mine, **full)))

        def old():
            parent.deliver_perm(*mine, **full)
    turns = in_turns(lambda: deliver.deliver_perm(*mine, **gather), old,
                     lambda fn: time_inplace_ms(none, fn, 20))
    results.append(dict(
        name="deliver_perm (source, window)", route="cuda",
        source=DELIVER_SOURCE,
        replaces="corrosion_tpu/models/sharded.py:94", max_abs_err=err,
        ms=turns["ms"], turns=turns,
        plain_ms=time_inplace_ms(none, lambda: deliver.deliver_perm_plain(
            *mine, **gather), 3, 1),
        bound=(source_delivery_bytes(senders[:, w], loss_u[w], params.loss,
                                     gather["slot_of"], r), 0),
        library_ms=None,
        shape=f"shard {sh}'s {nl} receivers of {n}, R={r}, K={k}"))
    for rr in results:
        set_bound(rr)
        if rr["max_abs_err"] != 0.0:
            fail(f"{rr['name']} differs from its plain version")
    return results, cases, validity


def shard_inputs(args, kind: str, sh: int, d: int, tick: int):
    """Shard ``sh``'s ``shard_round`` / ``shard_commit`` operands under
    layout ``kind`` from one tick's single-device ``exact_send``
    arguments (leaves after the latency queue's promote pass)."""
    infected, tx, nxt, msgs, pending, sent = (
        args[f] for f in ("infected", "tx", "next_send", "msgs", "pending",
                          "sent"))
    n = infected.shape[1]
    nl = n // d
    w = slice(sh * nl, (sh + 1) * nl)

    def win(x):
        return None if x is None else x[:, w].contiguous()

    active = infected & (tx > 0) & (nxt <= tick)
    target = (win(infected), win(pending)) if kind == "dense" else (
        infected, pending)
    budget = ((tx, nxt, msgs) if kind == "frontier"
              else (win(tx), win(nxt), win(msgs)))
    return dict(active=active, active_l=win(active), sent_l=win(sent),
                target=target, budget=budget, lo=sh * nl)


def shard_kernel_checks(dev, parent=None):
    """Phase 17b: ``shard_round`` and ``shard_commit`` against their plain
    versions, every output bitwise, at ticks 1 and ``BUSY_TICK`` of the
    three mesh runs' configs and seed counts and of a WAN-latency
    variant of the dense and host layouts: the round on every shard's
    rows, the commit of shard 0 and of a shard away from it in the
    writer's partition block; timed there at ``BUSY_TICK`` on the
    uniform configs (``shard_times``), the ring kernels on the host
    layout (10M nodes, the headline shape) and the frontier layout (1M),
    the bitmap kernels on the dense layout; with ``parent``, held to the
    parent's kernels there and timed beside them in turns."""
    from corrosion_tpu_torch.kernels import shard_exact as sx
    from corrosion_tpu_torch.random import fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    latency = dict(topology="wan_two_region", partition_blocks=1,
                   heal_tick=0, wan_latency_ticks=2)
    cases = []
    for label, cfg, seeds, _, d, sparse, host in mesh_cfgs():
        kind = "host" if host else ("frontier" if sparse else "dense")
        cases.append((kind, cfg, seeds, d, sparse, True))
        if kind != "frontier":
            cases.append((kind, replace(cfg, **latency), seeds, d, sparse,
                          False))
    errs = {"round": {}, "commit": {}}
    timed, checks = {}, []
    for kind, cfg, seeds, d, sparse, time_it in cases:
        rep = "ring" if sparse else "bitmap"
        state, base = exact_state_at(cfg, seeds, 0, sparse, dev)
        for tick in SHARD_TICKS:
            state = exact_advance(state, base, cfg, tick, sparse)
            args, _, _ = cal._send_inputs(
                state, [fold_in(k, tick) for k in base], cfg)
            n = cfg.n_nodes
            mid = max(1, d // 2 - 1)  # in the writer's partition block
            rounds, r_err = [], 0.0
            for sh in range(d):
                x = shard_inputs(args, kind, sh, d, tick)
                rounds.append(sx.shard_round(
                    x["active_l"], x["sent_l"], args["keys"], x["lo"], n,
                    args["p"], cal._zero_diag(dev), tick))
                want = sx.shard_round_plain(
                    x["active_l"], x["sent_l"], args["keys"], x["lo"], n,
                    args["p"], cal._zero_diag(dev))
                r_err = max(r_err, max_abs_err([rounds[-1]], [want]))
                del x, want
            accepted = (torch.cat(rounds, dim=1) - 1).clamp_min(0)
            del rounds
            errs["round"][rep] = max(errs["round"].get(rep, 0.0), r_err)
            for sh in (0, mid):
                x = shard_inputs(args, kind, sh, d, tick)
                copies = []
                for _ in range(2):
                    t_pend = x["target"][1]
                    copies.append(dict(
                        pending=None if t_pend is None else t_pend.clone(),
                        budget=[b.clone() for b in x["budget"]],
                        sent=x["sent_l"].clone()))
                got = shard_commit_call(sx.shard_commit, x, args, tick,
                                        x["active"], accepted, copies[0])()
                want = shard_commit_call(sx.shard_commit_plain, x, args,
                                         tick, x["active"], accepted,
                                         copies[1])()
                c_err = max_abs_err(commit_leaves(got, copies[0]),
                                    commit_leaves(want, copies.pop()))
                del got, want
                errs["commit"][rep] = max(errs["commit"].get(rep, 0.0),
                                          c_err)
                active_rows = int(x["active"].sum())
                checks.append(dict(
                    layout=kind, rep=rep, n=n, seeds=seeds, shards=d,
                    shard=sh, tick=tick, topology=cfg.topology,
                    rounds_max_abs_err=r_err, commit_max_abs_err=c_err,
                    active_rows=active_rows,
                    my_active_rows=int(x["active_l"].sum()),
                    rounds_max=int(accepted.max()) + 1))
                if time_it and tick == BUSY_TICK and sh == mid:
                    timed[kind] = shard_times(sx, cfg, seeds, d, x, args,
                                              tick, accepted, copies[0],
                                              active_rows, kind, parent)
                    checks[-1]["times"] = timed[kind]
                del x, copies
            del accepted, args
            torch.cuda.empty_cache()
        del state
        torch.cuda.empty_cache()
    for c in checks:
        if c["rounds_max_abs_err"] != 0.0 or c["commit_max_abs_err"] != 0.0:
            fail(f"shard kernels differ from their plain versions: {c}")
    results = []
    for name, part, kinds, replaces in (
        ("shard_round<Bitmap>", "round", ("dense",),
         "corrosion_tpu/sim/calibrate.py:817"),
        ("shard_round<Ring>", "round", ("host", "frontier"),
         "corrosion_tpu/models/sharded.py:403"),
        ("shard_commit<Bitmap>", "commit", ("dense",),
         "corrosion_tpu/sim/calibrate.py:848"),
        ("shard_commit<Ring>", "commit", ("host", "frontier"),
         "corrosion_tpu/models/sharded.py:428"),
    ):
        shapes = [dict(timed[k][part]) for k in kinds]
        for sh in shapes:
            set_bound(sh)
        rep = "ring" if "Ring" in name else "bitmap"
        results.append(dict(
            name=name, route="cuda", source=SHARD_SOURCE, replaces=replaces,
            max_abs_err=errs[part][rep], library_ms=None, **shapes[0],
            shapes=shapes))
    return results, checks


def shard_turns(results) -> dict:
    """Phase 17b's times for its printed line: each shard kernel at each
    timed shape, its rows scattered and gathered (``narrowed``), the
    parent's beside it when it was timed."""
    keys = ("ms", "ms_runs", "parent_ms")
    return {r["name"]: [
        dict(shape=sh["shape"], bound_ms=sh["bound_ms"],
             **{f: sh[f] for f in keys if f in sh},
             narrowed={f: sh["narrowed"][f] for f in keys
                       if f in sh["narrowed"]})
        for sh in r["shapes"]] for r in results}


def shard_commit_call(fn, x, args, tick: int, active, accepted, c):
    """A call of ``fn`` (``shard_commit``, its plain version or the
    parent's) on shard inputs ``x`` with the mutated leaves of ``c``."""
    return lambda: fn(active, accepted, x["target"][0], c["pending"],
                      *c["budget"], c["sent"], args["keys"], x["lo"], tick,
                      args["p"], args["tier"])


def commit_leaves(new_infected, c) -> list:
    return [new_infected, c["pending"], *c["budget"], c["sent"]]


def clone_leaves(c) -> dict:
    """A copy of a commit's mutated leaves (``shard_commit_call``'s
    ``c``)."""
    return {"pending": None if c["pending"] is None else c["pending"].clone(),
            "budget": [b.clone() for b in c["budget"]],
            "sent": c["sent"].clone()}


def narrowed_rows(active, lo: int, nl: int):
    """``active`` [S, N] with its rows gathered into contiguous blocks:
    as many of my rows (lo .. lo + nl - 1 of each seed) as it holds
    active, the first in flat order, and as many of the other rows, the
    first in flat order.  The same count and split, with no lane of a
    row's warp idle but at a block's ends."""
    mine = torch.zeros_like(active)
    mine[:, lo:lo + nl] = True
    flat, m = active.reshape(-1), mine.reshape(-1)
    take_mine = m.cumsum(0) <= int((flat & m).sum())
    take_other = (~m).cumsum(0) <= int((flat & ~m).sum())
    return torch.where(m, take_mine, take_other).reshape(active.shape)


def shard_times(sx, cfg, seeds, d, x, args, tick, accepted, work,
                active_rows, kind, parent) -> dict:
    """Times of ``shard_round`` and ``shard_commit`` on one shard's
    operands with their bounds (``work``: the kernel's copies of the
    commit's mutated leaves, restored before every call).  Each is also
    timed with its active rows gathered into contiguous blocks
    (``narrowed_rows``, rounds drawn for them and every budget left at 1
    or more, so their marks stay in their rows): a design that runs a
    warp for each 32 rows takes the same time there only if idle lanes
    cost it nothing.  With ``parent``, the parent's kernels must write
    what this tree's write (both commits from restored copies) and are
    timed beside them in turns."""
    from corrosion_tpu_torch.sim import calibrate as cal

    k, n = cfg.fanout, cfg.n_nodes
    nl = n // d
    lo = x["lo"]
    dev = x["active"].device
    ring = x["sent_l"].dtype == torch.int32
    my_active = int(x["active_l"].sum())
    diag = cal._zero_diag(dev)
    sx.shard_round(x["active_l"], x["sent_l"], args["keys"], lo, n,
                   args["p"], diag, tick)
    rounds_sum, rounds_max = int(diag[1]), int(diag[2])
    saved = clone_leaves(work)
    narrow = narrowed_rows(x["active"], lo, nl)
    narrow_l = narrow[:, lo:lo + nl].contiguous()
    accepted_n = (torch.cat([sx.shard_round(
        narrow[:, w:w + nl].contiguous(),
        args["sent"][:, w:w + nl].contiguous(), args["keys"], w, n,
        args["p"], cal._zero_diag(dev), tick) for w in range(0, n, nl)],
        dim=1) - 1).clamp_min(0)
    saved_n = {**saved, "budget": [saved["budget"][0].clamp_min(1),
                                   *saved["budget"][1:]]}

    def restorer(src):
        def restore():
            for a, b in zip(work["budget"], src["budget"]):
                a.copy_(b)
            work["sent"].copy_(src["sent"])
            if src["pending"] is not None:
                work["pending"].copy_(src["pending"])
        return restore

    t_diag = cal._zero_diag(dev)
    p_round = getattr(parent, "shard_round", None)
    p_commit = getattr(parent, "shard_commit", None)

    def rnd(fn, active_l):
        return fn and (lambda: fn(active_l, x["sent_l"], args["keys"], lo,
                                  n, args["p"], t_diag))

    def cmt(fn, active, acc):
        return fn and shard_commit_call(fn, x, args, tick, active, acc,
                                        work)

    if parent is not None:
        rounds, commits = [], []
        for fn in (sx.shard_round, p_round):
            dg = cal._zero_diag(dev)
            rounds.append([fn(x["active_l"], x["sent_l"], args["keys"], lo,
                              n, args["p"], dg, tick), dg])
        for fn in (sx.shard_commit, p_commit):
            restorer(saved)()
            inf = cmt(fn, x["active"], accepted)()
            commits.append(commit_leaves(inf, clone_leaves(work)))
        bad = [f for f, pair in (("round", rounds), ("commit", commits))
               if max_abs_err(*pair) != 0.0]
        del rounds, commits
        if bad:
            fail(f"shard kernels differ from the parent's ({kind}, tick "
                 f"{tick}): {bad}")

    def turns(restore, mine, old):
        return in_turns(mine, old,
                        lambda fn: time_inplace_ms(restore, fn, 20))

    shape = (f"{kind} {seeds} seeds x {n} over {d}, shard {lo // nl}, "
             f"tick {tick}, {my_active} of {active_rows} active rows mine")
    # round: my activity bytes read and round counts written; a ring row
    # read once, or K bitmap sectors a round; a drawn candidate's two
    # hashes and the round keys' 3 for the busiest row's rounds (as
    # exact_send's)
    memory = (my_active * 4 * frontier_cap(cfg) if ring
              else rounds_sum * k * SECTOR)
    out = {"round": dict(
        **turns(lambda: None, rnd(sx.shard_round, x["active_l"]),
                rnd(p_round, x["active_l"])),
        narrowed=turns(lambda: None, rnd(sx.shard_round, narrow_l),
                       rnd(p_round, narrow_l)),
        plain_ms=time_inplace_ms(
            lambda: None, rnd(sx.shard_round_plain, x["active_l"]), 1, 1),
        bound=(seeds * nl * 5 + memory,
               (rounds_sum * 2 * k + 3 * rounds_max) * INT_OPS_PER_HASH),
        shape=shape)}
    # commit: every row's activity byte and accepted round; an active
    # row's K infection stores; the budget rows' 12 bytes read and
    # written; my rows' marks (a ring sector, or K bitmap sectors read
    # and written)
    budget_rows = active_rows if kind == "frontier" else my_active
    marks = my_active * (SECTOR if ring else 2 * k * SECTOR)
    draws = k * ((cfg.loss > 0) + (cfg.topology == "wan_two_region"))
    out["commit"] = dict(
        **turns(restorer(saved), cmt(sx.shard_commit, x["active"], accepted),
                cmt(p_commit, x["active"], accepted)),
        narrowed=turns(restorer(saved_n),
                       cmt(sx.shard_commit, narrow, accepted_n),
                       cmt(p_commit, narrow, accepted_n)),
        plain_ms=time_inplace_ms(
            restorer(saved), cmt(sx.shard_commit_plain, x["active"],
                                 accepted), 1, 1),
        bound=(seeds * n * 5 + active_rows * k * SECTOR + budget_rows * 24
               + marks,
               active_rows * (3 + 2 * k + draws) * INT_OPS_PER_HASH),
        shape=shape)
    return out


def host_msgs_at_convergence(cfg, seeds: int, mesh, first_ticks) -> list:
    """Each seed's [N] msgs/node at its convergence tick, the host
    layout stepped again from its initial state on ``mesh``."""
    from corrosion_tpu_torch.convert import shard_state, unshard_state
    from corrosion_tpu_torch.models.sharded import sharded_frontier_host_step
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    base = [PRNGKey(s) for s in range(seeds)]
    state = shard_state(cal.frontier_exact_init(
        cfg, [fold_in(k, 2**20) for k in base], device=mesh.device),
        cal.HOST_LAYOUT, mesh)
    step = sharded_frontier_host_step(mesh, cfg)
    out = [None] * seeds
    for t in range(int(max(first_ticks))):
        state = step(state, [fold_in(k, t) for k in base])
        for s, first in enumerate(first_ticks):
            if int(first) == t + 1:
                out[s] = unshard_state(state, cal.HOST_LAYOUT).msgs[s].cpu()
    return out


def write_host_msgs(path: str, cfg, seeds: int, mesh, res: dict) -> None:
    """The host-sparse run's per-node msgs at each seed's convergence
    tick, with the run's per-seed means, to ``path`` for the reference's
    statistics (``python -m tests.test_torch_sharded_exact``).  Fails
    unless the run's means are those msgs' exact means."""
    msgs = torch.stack(host_msgs_at_convergence(cfg, seeds, mesh,
                                                res["seed_ticks"]))
    exact = [float(m.double().mean()) for m in msgs]
    if not all(math.isclose(a, b, rel_tol=1e-6)
               for a, b in zip(exact, res["seed_msgs_mean"])):
        fail(f"host-sparse 10M: the run's means {res['seed_msgs_mean']} "
             f"are not its msgs' {exact}")
    if int(msgs.max()) >= 2**16:
        fail("host-sparse 10M: msgs past uint16")
    np.savez_compressed(path, msgs=msgs.numpy().astype(np.uint16),
                        n_hosts=res["n_hosts"],
                        seed_ticks=np.array(res["seed_ticks"]),
                        seed_msgs_mean=np.array(res["seed_msgs_mean"]))
    print(f"host-sparse 10M: per-node msgs written to {path}", flush=True)


def mesh_full_width(counted, single_runs, dev) -> dict:
    """Phase 18: ``run_exact_headline`` over a ``LocalFabric`` on the
    card, launch counters zeroed just before each run: host-sparse
    10M x 2 seeds on 2 hosts held to BENCH_FRONTIER.json's headline
    (and its fabric to packed validity bits plus the statistics'
    gather), sharded-sparse 1M x 4 and sharded-dense 100k x 4 over 8
    node shards held per seed to phase 6's single-device runs."""
    from corrosion_tpu_torch.mesh import LocalFabric, Mesh
    from corrosion_tpu_torch.sim.calibrate import run_exact_headline

    runs = {}
    for label, cfg, seeds, axis, d, sparse, host in mesh_cfgs():
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        mesh = Mesh(axis, LocalFabric(d, dev))
        t0 = time.perf_counter()
        res = run_exact_headline(cfg, n_seeds=seeds, seed=0, mesh=mesh,
                                 kernel="sparse" if sparse else "dense",
                                 host_sharded=host)
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t0
        names = HOST_COUNTED if host else MESH_COUNTED
        res["launches"] = {nm: counted[nm].launches for nm in names}
        if host:  # the bool pack is off the main path: none expected
            res["bits_pack_launches"] = counted["bits_pack"].launches
            if res["bits_pack_launches"]:
                fail(f"mesh {label} packed a bool mask "
                     f"{res['bits_pack_launches']} times; its masks are "
                     f"packed from their sources")
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        runs[label] = res
        print(f"mesh {label}: " + json.dumps({k: res[k] for k in (
            "kernel", "n_shards", "n_hosts", "converged_frac", "ticks_p50",
            "ticks_p99", "msgs_per_node_mean", "msgs_per_node_p99",
            "seed_batch", "wall_s", "peak_mem_gb", "rejection", "fabric",
            "launches")}), flush=True)
        if res["converged_frac"] != 1.0:
            fail(f"mesh {label} did not converge: {res}")
        idle = [nm for nm, c in res["launches"].items() if c == 0]
        if idle:
            fail(f"mesh {label}: kernels never launched: {idle}")
        if host:
            write_host_msgs(HOST_MSGS, cfg, seeds, mesh, res)
            got = {k: res[k] for k in HOST_WANT}
            got["msgs_per_node_mean"] = round(got["msgs_per_node_mean"], 2)
            if got != HOST_WANT or not all(
                    math.isclose(a, b, rel_tol=1e-6)
                    for a, b in zip(res["seed_msgs_mean"], HOST_SEED_MEANS)):
                fail(f"host-sparse 10M moved: {got}, want {HOST_WANT}; "
                     f"per-seed means {res['seed_msgs_mean']}, the "
                     f"reference's {HOST_SEED_MEANS}")
            if set(res["fabric"]) - {"delta", "stats"}:
                fail(f"host-sparse moved more than validity bits: "
                     f"{res['fabric']}")
        else:
            single = single_runs["sparse_1m" if sparse else "dense_100k"]
            for key in ("seed_ticks", "seed_msgs_mean", "seed_msgs_p99"):
                if res[key] != single[key][:seeds]:
                    fail(f"mesh {label} differs from the single-device run "
                         f"in {key}: {res[key]} vs {single[key][:seeds]}")
    return runs


def fabric_full_width(counted, dev) -> dict:
    """Phase 18b: the all_gather and the ring broadcast fabrics at the
    headline's width over a ``LocalFabric`` of 8 shards on the card,
    ``profile_tick.FABRIC_TICKS`` ticks each with the launch counters
    zeroed just before, both bitwise the single-device
    ``broadcast_step`` after every tick; then the seq-sync fabric at
    config #4's width."""
    from corrosion_tpu_torch import convert
    from corrosion_tpu_torch.mesh import LocalFabric, Mesh
    from corrosion_tpu_torch.models import sharded as ms
    from corrosion_tpu_torch.models.broadcast import broadcast_step
    from corrosion_tpu_torch.models.sync import SeqSyncParams, seq_sync_step
    from corrosion_tpu_torch.profile_tick import (
        FABRIC_D,
        FABRIC_TICKS,
        fabric_params,
        fabric_state,
    )
    from corrosion_tpu_torch.random import PRNGKey, fold_in

    params = fabric_params()
    runs = {}
    lay = ms.BroadcastShard(0, 0, 0)
    for label in ("all_gather", "ring"):
        rows, tx, msgs = fabric_state(dev)
        mesh = Mesh("nodes", LocalFabric(FABRIC_D, dev))
        state = convert.shard_state(ms.BroadcastShard(rows, tx, msgs), lay,
                                    mesh)
        step = (ms.sharded_broadcast_step_ring(mesh, params)
                if label == "ring" else ms.sharded_broadcast_step(mesh,
                                                                  params))
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        overflow = 0
        for t in range(FABRIC_TICKS):
            state = step(state, fold_in(PRNGKey(8), t))
            if label == "ring":
                state, ov = state
                overflow += ov
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {nm: counted[nm].launches
                    for nm in FABRIC_COUNTED[label]}
        for t in range(FABRIC_TICKS):
            out = broadcast_step(rows, tx, msgs, fold_in(PRNGKey(8), t),
                                 params)
            rows, tx, msgs = out.rows, out.tx_remaining, out.msgs_sent
        got = convert.unshard_state(state, lay)
        if not all(torch.equal(a, b) for a, b in zip(got, (rows, tx, msgs))):
            fail(f"the {label} fabric differs from broadcast_step")
        runs[label] = dict(ticks=FABRIC_TICKS, wall_s=wall, overflow=overflow,
                           launches=launches, fabric=dict(mesh.fabric.bytes),
                           learned=int((rows == rows[0]).all(1).sum()))
        print(f"fabric {label}: " + json.dumps(runs[label]), flush=True)
        idle = [nm for nm, c in launches.items() if c == 0]
        if idle:
            fail(f"fabric {label}: kernels never launched: {idle}")
    # the seq-sync fabric at config #4's width (10k nodes, 64 seqs)
    sp = SeqSyncParams(n_nodes=10_000, n_seqs=64, loss=0.02)
    bits = torch.zeros((10_000, 64), dtype=torch.bool, device=dev)
    bits[0] = True
    smsgs = torch.zeros(10_000, dtype=torch.int32, device=dev)
    mesh = Mesh("nodes", LocalFabric(FABRIC_D, dev))
    seq = convert.shard_state(ms.SeqShard(bits, smsgs), ms.SeqShard(0, 0),
                              mesh)
    step = ms.sharded_seq_sync_step(mesh, sp)
    counted["seq_sync"].launches = 0
    for t in range(20):
        k = fold_in(PRNGKey(10), t)
        seq = step(seq, k)
        bits, smsgs = seq_sync_step(bits, smsgs, k, sp)
    got = convert.unshard_state(seq, ms.SeqShard(0, 0))
    if not (torch.equal(got.bits, bits) and torch.equal(got.msgs, smsgs)):
        fail("the seq-sync fabric differs from seq_sync_step")
    runs["seq_sync"] = dict(ticks=20, launches=counted["seq_sync"].launches,
                            fabric=dict(mesh.fabric.bytes),
                            holders=int(bits.all(1).sum()))
    print("fabric seq_sync: " + json.dumps(runs["seq_sync"]), flush=True)
    return runs


# card against CPU, small: (label, n, shards, axis, sparse, host, overrides)
MESH_EQUAL = (
    ("dense 2048 x 8", 2048, 8, "nodes", False, False, {}),
    ("frontier 2048 x 8", 2048, 8, "nodes", True, False, {}),
    ("host 2048 x 2", 2048, 2, "hosts", True, True, {}),
    ("host 256 x 8 (multi_host_gate)", 256, 8, "hosts", True, True,
     dict(ring0_size=16, partition_blocks=1, heal_tick=0, sync_interval=4)),
    ("dense 2048 x 8 latency", 2048, 8, "nodes", False, False,
     EXACT_VARIANTS["wan_latency"]),
    ("host 2048 x 2 latency", 2048, 2, "hosts", True, True,
     EXACT_VARIANTS["wan_latency"]),
)


def mesh_equal(dev) -> dict:
    """Phase 19: the three layouts at small sizes on the card and on the
    CPU, every leaf per tick equal between them and to the port's
    single-device tick on the card, for 12 ticks; the broadcast fabrics
    at 256 nodes (the ring also at a cap of 2) and the seq-sync fabric
    at config #4's width for 4 ticks, card against CPU."""
    from corrosion_tpu_torch import convert
    from corrosion_tpu_torch.mesh import LocalFabric, Mesh
    from corrosion_tpu_torch.models import sharded as ms
    from corrosion_tpu_torch.models.broadcast import BroadcastParams
    from corrosion_tpu_torch.models.sync import SeqSyncParams
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    out = {}
    for label, n, d, axis, sparse, host, over in MESH_EQUAL:
        cfg = cal.HeadlineExactConfig(**{
            "n_nodes": n, "fanout": 4, "ring0_size": 64,
            "max_transmissions": 8, "loss": 0.05, "partition_blocks": 2,
            "heal_tick": 3, "sync_interval": 2, "backoff_ticks": 0.5,
            "max_ticks": 48, "chunk_ticks": 8, **over})
        base = [PRNGKey(s) for s in (5, 6)]
        init = cal.frontier_exact_init if sparse else cal.packed_exact_init
        tick_fn = cal.frontier_exact_tick if sparse else cal.packed_exact_tick
        single = init(cfg, [fold_in(k, 2**20) for k in base], device=dev)
        sides = {}
        for where in (dev, "cpu"):
            mesh = Mesh(axis, LocalFabric(d, where))
            layout = cal._layout(mesh, cfg, sparse, host)
            sides[where] = [layout, convert.shard_state(
                init(cfg, [fold_in(k, 2**20) for k in base], device=where),
                layout.leaves, mesh), cal._mesh_step(mesh, cfg, layout)]
        for t in range(12):
            keys = [fold_in(k, t) for k in base]
            single = tick_fn(single, keys, cfg)
            got = {}
            for where, side in sides.items():
                side[1] = side[2](side[1], keys)
                got[where] = convert.unshard_state(side[1], side[0].leaves)
            for f in single._fields:
                if f == "tick":
                    continue
                a, b, c = (getattr(x, f) for x in (single, got[dev],
                                                   got["cpu"]))
                if not (torch.equal(a, b) and torch.equal(b.cpu(), c)):
                    fail(f"{label} tick {t}: {f} differs (card layout, "
                         "one device, CPU layout)")
        out[label] = dict(ticks=12, infected=int(single.infected.sum()))
    for label, kw, cap in (
        ("all_gather 256", dict(fanout_ring0=1, fanout_global=2,
                                ring0_size=16, loss=0.1), None),
        ("ring 256", dict(fanout_ring0=1, fanout_global=2, ring0_size=16,
                          loss=0.1), None),
        ("ring 256 cap 2", dict(fanout_ring0=0, fanout_global=3,
                                ring0_size=1), 2),
    ):
        params = BroadcastParams(n_nodes=256, max_transmissions=4, **kw)
        g = torch.Generator(device="cpu").manual_seed(1)
        rows = torch.randint(0, 1 << 20, (256, 4), generator=g,
                             dtype=torch.int32)
        rows[0] += 1 << 22
        tx = torch.zeros(256, dtype=torch.int32)
        tx[0], tx[100:140] = 4, 3
        lay = ms.BroadcastShard(0, 0, 0)
        sides = {}
        for where in (dev, "cpu"):
            mesh = Mesh("nodes", LocalFabric(8, where))
            step = (ms.sharded_broadcast_step(mesh, params)
                    if label.startswith("all") else
                    ms.sharded_broadcast_step_ring(mesh, params, cap))
            sides[where] = [convert.shard_state(ms.BroadcastShard(
                rows.to(where), tx.to(where),
                torch.zeros(256, dtype=torch.int32, device=where)), lay,
                mesh), step]
        for t in range(6):
            got = {}
            for where, side in sides.items():
                res = side[1](side[0], fold_in(PRNGKey(2), t))
                side[0] = res[0] if isinstance(res, tuple) else res
                got[where] = (convert.unshard_state(side[0], lay),
                              res[1] if isinstance(res, tuple) else 0)
            if got[dev][1] != got["cpu"][1] or not all(
                    torch.equal(a.cpu(), b)
                    for a, b in zip(got[dev][0], got["cpu"][0])):
                fail(f"fabric {label} tick {t}: card differs from CPU")
        out[label] = dict(ticks=6, overflow=got["cpu"][1])
    sp = SeqSyncParams(n_nodes=10_000, n_seqs=64, loss=0.02)
    sides = {}
    for where in (dev, "cpu"):
        bits = torch.zeros((10_000, 64), dtype=torch.bool, device=where)
        bits[0] = True
        mesh = Mesh("nodes", LocalFabric(8, where))
        sides[where] = [convert.shard_state(ms.SeqShard(
            bits, torch.zeros(10_000, dtype=torch.int32, device=where)),
            ms.SeqShard(0, 0), mesh), ms.sharded_seq_sync_step(mesh, sp)]
    for t in range(4):
        got = {}
        for where, side in sides.items():
            side[0] = side[1](side[0], fold_in(PRNGKey(3), t))
            got[where] = convert.unshard_state(side[0], ms.SeqShard(0, 0))
        if not all(torch.equal(a.cpu(), b)
                   for a, b in zip(got[dev], got["cpu"])):
            fail(f"seq-sync fabric tick {t}: card differs from CPU")
    out["seq_sync 10k x 64"] = dict(ticks=4)
    return out


GLOO_TIMEOUT_S = 240


def gloo_scenario(fabric) -> dict:
    """The host layout at 4096 nodes x 2 seeds on 2 hosts for 4 ticks
    over ``fabric``, on the card: this process's shards after each tick
    (host copies) and the fabric's bytes."""
    from corrosion_tpu_torch.convert import shard_state
    from corrosion_tpu_torch.mesh import Mesh
    from corrosion_tpu_torch.models.sharded import sharded_frontier_host_step
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim import calibrate as cal

    cfg = cal.HeadlineExactConfig(n_nodes=4096, fanout=4, ring0_size=64,
                                  max_transmissions=8, loss=0.05,
                                  sync_interval=2, max_ticks=16,
                                  chunk_ticks=8)
    mesh = Mesh("hosts", fabric)
    base = [PRNGKey(1), PRNGKey(2)]
    state = shard_state(cal.frontier_exact_init(
        cfg, [fold_in(k, 2**20) for k in base], device="cuda"),
        cal.HOST_LAYOUT, mesh)
    step = sharded_frontier_host_step(mesh, cfg)
    out = {}
    for t in range(4):
        state = step(state, [fold_in(k, t) for k in base])
        out[t] = {sh: [x.cpu() if torch.is_tensor(x) else x
                       for x in state[sh]] for sh in state.shards()}
    out["bytes"] = dict(fabric.bytes)
    return out


def _gloo_rank(rank: int, world: int, init_file: str, out_file: str):
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from corrosion_tpu_torch.mesh import DistFabric

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        torch.save(gloo_scenario(DistFabric(device="cuda")),
                   f"{out_file}.{rank}")
    finally:
        dist.destroy_process_group()


def gloo_phase(tmp: str) -> dict:
    """Phase 20: a ``DistFabric`` over two gloo ranks (spawned processes)
    with CUDA tensors on the one card, held to the ``LocalFabric`` on the
    card: every shard after every tick equal, the ranks' bytes summing to
    the local fabric's."""
    import torch.multiprocessing as torch_mp

    from corrosion_tpu_torch.mesh import LocalFabric

    local = gloo_scenario(LocalFabric(2, "cuda"))
    out = os.path.join(tmp, "gloo")
    t0 = time.perf_counter()
    ctx = torch_mp.start_processes(
        _gloo_rank, args=(2, os.path.join(tmp, "rendezvous"), out),
        nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1):
            if time.perf_counter() - t0 > GLOO_TIMEOUT_S:
                fail(f"two gloo ranks still running after "
                     f"{GLOO_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    ranks = [torch.load(f"{out}.{r}") for r in range(2)]
    for r, got in enumerate(ranks):
        for t in range(4):
            same = all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                       for a, b in zip(got[t][r], local[t][r]))
            if not same:
                fail(f"gloo rank {r} differs from the LocalFabric at tick {t}")
    for kind, b in local["bytes"].items():
        if sum(got["bytes"][kind] for got in ranks) != b:
            fail(f"gloo ranks' {kind} bytes do not sum to the local fabric's")
    return dict(ranks=2, ticks=4, s=time.perf_counter() - t0,
                bytes=local["bytes"])


def mesh_phases(record: dict, counted: dict, single_runs: dict,
                cuda, parent=None) -> list:
    """Phases 17-20; returns the new kernels' results with the main
    path's launches."""
    fabric_results, record["fabric_cases"], validity = fabric_kernel_checks(
        cuda, parent)
    shard_results, record["shard_checks"] = shard_kernel_checks(cuda,
                                                                parent)
    print("fabric and shard kernels match their plain versions: "
          + ", ".join(f"{r['name']} {r['max_abs_err']}"
                      for r in fabric_results + shard_results), flush=True)
    print(json.dumps({"shard": shard_turns(shard_results)}), flush=True)
    print(json.dumps({"validity": {
        **{r["name"]: dict(turns=r["turns"], bound_ms=r["bound_ms"],
                           shape=r["shape"])
           for r in fabric_results if r["name"] in VALIDITY_KERNELS},
        "cases": sum(c.get("kernel") in VALIDITY_KERNELS
                     for c in record["fabric_cases"]),
        **validity}}), flush=True)
    for name in ("route_pack", "ring_receive",
                 "deliver_perm (source, window)"):
        res = next(r for r in fabric_results if r["name"] == name)
        print(json.dumps({name: dict(
            turns=res["turns"], bound_ms=res["bound_ms"],
            cases=sum(c.get("kernel") == name
                      for c in record["fabric_cases"]))}), flush=True)
    runs = mesh_full_width(counted, single_runs, cuda)
    record["mesh_runs"] = runs
    fabric_runs = fabric_full_width(counted, cuda)
    record["fabric_runs"] = fabric_runs
    dense = runs["sharded_dense_100k"]["launches"]
    sparse = [runs[k]["launches"] for k in ("host_sparse_10m",
                                            "sharded_sparse_1m")]
    host = runs["host_sparse_10m"]["launches"]
    launches = {
        **{name: host[name] for name in VALIDITY_KERNELS if name in host},
        "route_pack": fabric_runs["ring"]["launches"]["route_pack"],
        "ring_receive": fabric_runs["ring"]["launches"]["ring_receive"],
        "deliver_perm (source, window)":
            fabric_runs["all_gather"]["launches"]["deliver_perm"],
        "shard_round<Bitmap>": dense["shard_round"],
        "shard_commit<Bitmap>": dense["shard_commit"],
        "shard_round<Ring>": sum(s["shard_round"] for s in sparse),
        "shard_commit<Ring>": sum(s["shard_commit"] for s in sparse),
    }
    # bits_pack packs no mask of a main path since the host layout packs
    # from the sources: held and timed in phase 17a, off the kernels line
    results = [r for r in fabric_results + shard_results
               if r["name"] in launches]
    for r in results:
        r["launches"] = launches[r["name"]]
    record["mesh_equal"] = mesh_equal(cuda)
    print("mesh layouts and fabrics card == CPU == one device per tick: "
          + ", ".join(record["mesh_equal"]), flush=True)
    from corrosion_tpu_torch import kernels

    with tempfile.TemporaryDirectory(prefix="gloo-",
                                     dir=kernels.BUILD_DIR) as tmp:
        record["gloo"] = gloo_phase(tmp)
    print("two gloo ranks on the card == LocalFabric: "
          + json.dumps(record["gloo"]), flush=True)
    return results


# -- the harness twins' predictions (phase 21) -----------------------------

# the kernels each twin's path launches: the exact sent_to sampler with
# anti-entropy every 8 ticks, and the perm-fanout path
TRACK_SENT_SYNC = ("threefry_bits", "sent_select", "sent_commit",
                   "sync_pull", "tick_stats")
PERM_PATH = ("threefry_bits", "seg_argsort", "deliver_perm", "sync_pull",
             "tick_stats")
# the subscription matcher's headline burst (SUBS_BENCH.json: 10,000
# changes in waves of 512 over 3,333 pks, drawn first from bench.py
# ``_subs_matcher_headline``'s seed 7) and one wave of 131,072 changes,
# twice ``select_winners``' auto threshold
SUBS_HEADLINE = dict(seed=7, n_changes=10_000, pk_space=3_333,
                     wave_size=512)
SUBS_WIDE = dict(seed=23, n_changes=131_072, pk_space=43_690,
                 wave_size=131_072)
# lists the twins round to 4 places: each entry within 1e-4
COVERAGE_KEYS = ("coverage", "coverage_p10", "coverage_p90")
# the reference's results for the same calls on the CPU (JAX 0.9.0, seed
# 0; ``wall_s`` left out).  Where a committed record differs from them
# (CHAOS_N32, OBS_N32, SCENARIOS_N32 / N512, TIMELINE_N32 / N512), the
# record is stale against today's reference and is not a gate
HARNESS_WANT = {
    "sim_obs_trace(32)": {
        "runtime": "tpu-sim", "n_nodes": 32, "converged_frac": 1.0,
        "ticks_p50": 5.0, "ticks_p99": 6.93, "predicted_wall_p50_s": 0.1,
        "predicted_wall_p99_s": 0.1386, "msgs_per_node": 4.16015625,
        "tick_seconds": 0.02,
    },
    "sim_chaos_trace(32)": {
        "runtime": "tpu-sim", "n_nodes": 32, "loss": 0.05,
        "partition_blocks": 2, "heal_tick": 32, "oneway_blocks": None,
        "converged_frac": 1.0, "ticks_to_converge_p50": 44.0,
        "ticks_to_converge_p99": 56.0, "msgs_per_node": 15.1953125,
    },
    "sim_chaos_trace(512, oneway_blocks=((0, 1),))": {
        "runtime": "tpu-sim", "n_nodes": 512, "loss": 0.05,
        "partition_blocks": 2, "heal_tick": 32, "oneway_blocks": [[0, 1]],
        "converged_frac": 1.0, "ticks_to_converge_p50": 40.0,
        "ticks_to_converge_p99": 40.0, "msgs_per_node": 15.398681640625,
    },
    "sim_prediction('clock_skew', 32, 0.64)": {
        "runtime": "tpu-sim", "n_nodes": 32, "converged_frac": 1.0,
        "ticks_p50": 5.0, "ticks_p99": 6.93, "predicted_wall_p50_s": 0.1,
        "predicted_wall_p99_s": 0.1386, "msgs_per_node": 4.16015625,
        "tick_seconds": 0.02,
        "residual": (
            "the kernel does not model clock skew / disk latency / hostile "
            "peers — they alter timestamps, lock holds and screening, not "
            "the message dynamics — so the cell compares against the "
            "fault-free prediction"
        ),
    },
    "sim_prediction('asym_partition', 32, 0.64)": {
        "runtime": "tpu-sim", "n_nodes": 32, "loss": 0.0,
        "partition_blocks": 2, "heal_tick": 32, "oneway_blocks": [[0, 1]],
        "converged_frac": 1.0, "ticks_to_converge_p50": 44.0,
        "ticks_to_converge_p99": 56.0, "msgs_per_node": 15.2109375,
    },
    "sim_prediction('slow_io', 32, 0.64)": {
        "runtime": "tpu-sim", "n_nodes": 32, "converged_frac": 1.0,
        "ticks_p50": 5.0, "ticks_p99": 6.93, "predicted_wall_p50_s": 0.1,
        "predicted_wall_p99_s": 0.1386, "msgs_per_node": 4.16015625,
        "tick_seconds": 0.02,
        "residual": (
            "the kernel does not model clock skew / disk latency / hostile "
            "peers — they alter timestamps, lock holds and screening, not "
            "the message dynamics — so the cell compares against the "
            "fault-free prediction"
        ),
    },
    "sim_prediction('equivocation', 32, 0.64)": {
        "runtime": "tpu-sim", "n_nodes": 32, "converged_frac": 1.0,
        "ticks_p50": 5.0, "ticks_p99": 6.93, "predicted_wall_p50_s": 0.1,
        "predicted_wall_p99_s": 0.1386, "msgs_per_node": 4.16015625,
        "tick_seconds": 0.02,
        "residual": (
            "the kernel does not model clock skew / disk latency / hostile "
            "peers — they alter timestamps, lock holds and screening, not "
            "the message dynamics — so the cell compares against the "
            "fault-free prediction"
        ),
    },
    "sim_prediction('compound', 32, 0.64)": {
        "runtime": "tpu-sim", "n_nodes": 32, "loss": 0.05,
        "partition_blocks": 2, "heal_tick": 32, "oneway_blocks": [[0, 1]],
        "converged_frac": 1.0, "ticks_to_converge_p50": 44.0,
        "ticks_to_converge_p99": 56.0, "msgs_per_node": 15.1953125,
        "residual": (
            "the kernel models the cell's loss + one-way partition exactly; "
            "clock skew (the cell's third fault) alters timestamps, not "
            "message dynamics, and carries no kernel-side model"
        ),
    },
    "sim_prediction('clock_skew', 512, 0.64)": {
        "runtime": "tpu-sim", "n_nodes": 512, "converged_frac": 1.0,
        "ticks_p50": 8.0, "ticks_p99": 8.0, "predicted_wall_p50_s": 0.16,
        "predicted_wall_p99_s": 0.16, "msgs_per_node": 6.52197265625,
        "tick_seconds": 0.02,
        "residual": (
            "the kernel does not model clock skew / disk latency / hostile "
            "peers — they alter timestamps, lock holds and screening, not "
            "the message dynamics — so the cell compares against the "
            "fault-free prediction"
        ),
    },
    "sim_prediction('asym_partition', 512, 0.64)": {
        "runtime": "tpu-sim", "n_nodes": 512, "loss": 0.0,
        "partition_blocks": 2, "heal_tick": 32, "oneway_blocks": [[0, 1]],
        "converged_frac": 1.0, "ticks_to_converge_p50": 40.0,
        "ticks_to_converge_p99": 40.0, "msgs_per_node": 15.514892578125,
    },
    "sim_prediction('slow_io', 512, 0.64)": {
        "runtime": "tpu-sim", "n_nodes": 512, "converged_frac": 1.0,
        "ticks_p50": 8.0, "ticks_p99": 8.0, "predicted_wall_p50_s": 0.16,
        "predicted_wall_p99_s": 0.16, "msgs_per_node": 6.52197265625,
        "tick_seconds": 0.02,
        "residual": (
            "the kernel does not model clock skew / disk latency / hostile "
            "peers — they alter timestamps, lock holds and screening, not "
            "the message dynamics — so the cell compares against the "
            "fault-free prediction"
        ),
    },
    "sim_prediction('equivocation', 512, 0.64)": {
        "runtime": "tpu-sim", "n_nodes": 512, "converged_frac": 1.0,
        "ticks_p50": 8.0, "ticks_p99": 8.0, "predicted_wall_p50_s": 0.16,
        "predicted_wall_p99_s": 0.16, "msgs_per_node": 6.52197265625,
        "tick_seconds": 0.02,
        "residual": (
            "the kernel does not model clock skew / disk latency / hostile "
            "peers — they alter timestamps, lock holds and screening, not "
            "the message dynamics — so the cell compares against the "
            "fault-free prediction"
        ),
    },
    "sim_prediction('compound', 512, 0.64)": {
        "runtime": "tpu-sim", "n_nodes": 512, "loss": 0.05,
        "partition_blocks": 2, "heal_tick": 32, "oneway_blocks": [[0, 1]],
        "converged_frac": 1.0, "ticks_to_converge_p50": 40.0,
        "ticks_to_converge_p99": 40.0, "msgs_per_node": 15.398681640625,
        "residual": (
            "the kernel models the cell's loss + one-way partition exactly; "
            "clock skew (the cell's third fault) alters timestamps, not "
            "message dynamics, and carries no kernel-side model"
        ),
    },
    "kernel_coverage_prediction(32, 64)": {
        "runtime": "tpu-sim", "n_nodes": 32, "heal_tick": 64, "heal_s": 1.28,
        "tick_seconds": 0.02,
        "times_s": [
            0.02, 0.04, 0.06, 0.08, 0.1, 0.12, 0.14, 0.16, 0.18, 0.2, 0.22,
            0.24, 0.26, 0.28, 0.3, 0.32, 0.34, 0.36, 0.38, 0.4, 0.42, 0.44,
            0.46, 0.48, 0.5, 0.52, 0.54, 0.56, 0.58, 0.6, 0.62, 0.64, 0.66,
            0.68, 0.7, 0.72, 0.74, 0.76, 0.78, 0.8, 0.82, 0.84, 0.86, 0.88,
            0.9, 0.92, 0.94, 0.96, 0.98, 1.0, 1.02, 1.04, 1.06, 1.08, 1.1,
            1.12, 1.14, 1.16, 1.18, 1.2, 1.22, 1.24, 1.26, 1.28, 1.3, 1.32,
            1.34, 1.36, 1.38, 1.4, 1.42, 1.44, 1.46, 1.48, 1.5, 1.52, 1.54,
            1.56, 1.58, 1.6, 1.62, 1.64, 1.66, 1.68, 1.7, 1.72, 1.74, 1.76,
            1.78, 1.8, 1.82, 1.84, 1.86, 1.88, 1.9, 1.92,
        ],
        "coverage": [
            0.0664, 0.1211, 0.1914, 0.2578, 0.3359, 0.3906, 0.4141, 0.4766,
            0.4805, 0.4805, 0.4883, 0.4961, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.7773, 0.7773, 0.7773, 0.7773, 0.7773, 0.7773, 0.7773, 0.7773,
            0.9531, 0.9531, 0.9531, 0.9531, 0.9531, 0.9531, 0.9531, 0.9531,
            0.9961, 0.9961, 0.9961, 0.9961, 0.9961, 0.9961, 0.9961, 0.9961,
            1.0,
        ],
        "coverage_p10": [
            0.0312, 0.0312, 0.0625, 0.0938, 0.1781, 0.2625, 0.3156, 0.4406,
            0.4406, 0.4406, 0.4719, 0.4906, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.7094, 0.7094, 0.7094, 0.7094, 0.7094, 0.7094, 0.7094, 0.7094,
            0.9281, 0.9281, 0.9281, 0.9281, 0.9281, 0.9281, 0.9281, 0.9281,
            0.9906, 0.9906, 0.9906, 0.9906, 0.9906, 0.9906, 0.9906, 0.9906,
            1.0,
        ],
        "coverage_p90": [
            0.0938, 0.2188, 0.3312, 0.4156, 0.4781, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.8844, 0.8844,
            0.8844, 0.8844, 0.8844, 0.8844, 0.8844, 0.8844, 0.9781, 0.9781,
            0.9781, 0.9781, 0.9781, 0.9781, 0.9781, 0.9781, 1.0, 1.0, 1.0,
            1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
        ],
        "converged_frac": 1.0,
        "t_at_coverage": {
            "0.5": 0.26, "0.75": 1.44, "0.9": 1.6, "0.99": 1.76, "1.0": 1.92,
        },
    },
    "kernel_coverage_prediction(512, 64)": {
        "runtime": "tpu-sim", "n_nodes": 512, "heal_tick": 64, "heal_s": 1.28,
        "tick_seconds": 0.02,
        "times_s": [
            0.02, 0.04, 0.06, 0.08, 0.1, 0.12, 0.14, 0.16, 0.18, 0.2, 0.22,
            0.24, 0.26, 0.28, 0.3, 0.32, 0.34, 0.36, 0.38, 0.4, 0.42, 0.44,
            0.46, 0.48, 0.5, 0.52, 0.54, 0.56, 0.58, 0.6, 0.62, 0.64, 0.66,
            0.68, 0.7, 0.72, 0.74, 0.76, 0.78, 0.8, 0.82, 0.84, 0.86, 0.88,
            0.9, 0.92, 0.94, 0.96, 0.98, 1.0, 1.02, 1.04, 1.06, 1.08, 1.1,
            1.12, 1.14, 1.16, 1.18, 1.2, 1.22, 1.24, 1.26, 1.28, 1.3, 1.32,
            1.34, 1.36, 1.38, 1.4, 1.42, 1.44, 1.46, 1.48, 1.5, 1.52, 1.54,
            1.56, 1.58, 1.6, 1.62, 1.64, 1.66, 1.68, 1.7, 1.72, 1.74, 1.76,
            1.78, 1.8, 1.82, 1.84, 1.86, 1.88, 1.9, 1.92, 1.94, 1.96, 1.98,
            2.0, 2.02, 2.04, 2.06, 2.08, 2.1, 2.12, 2.14, 2.16, 2.18, 2.2,
            2.22, 2.24,
        ],
        "coverage": [
            0.0046, 0.0083, 0.0156, 0.03, 0.0554, 0.0981, 0.1577, 0.2795,
            0.333, 0.3743, 0.4119, 0.4377, 0.4573, 0.4719, 0.481, 0.4924,
            0.4941, 0.4958, 0.4963, 0.4963, 0.4966, 0.4968, 0.4973, 0.4988,
            0.499, 0.499, 0.4995, 0.4998, 0.4998, 0.4998, 0.4998, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.7434, 0.7434, 0.7434, 0.7434, 0.7434, 0.7434, 0.7434, 0.7434,
            0.9395, 0.9395, 0.9395, 0.9395, 0.9395, 0.9395, 0.9395, 0.9395,
            0.9951, 0.9951, 0.9951, 0.9951, 0.9951, 0.9951, 0.9951, 0.9951,
            0.9998, 0.9998, 0.9998, 0.9998, 0.9998, 0.9998, 0.9998, 0.9998,
            1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
        ],
        "coverage_p10": [
            0.002, 0.002, 0.0053, 0.0105, 0.0197, 0.0332, 0.0547, 0.1242,
            0.1715, 0.2332, 0.301, 0.367, 0.4129, 0.4465, 0.4678, 0.4871,
            0.4883, 0.4936, 0.4936, 0.4936, 0.4936, 0.4941, 0.4941, 0.4961,
            0.4975, 0.4975, 0.4988, 0.4994, 0.4994, 0.4994, 0.4994, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.7318, 0.7318, 0.7318, 0.7318, 0.7318, 0.7318, 0.7318, 0.7318,
            0.9287, 0.9287, 0.9287, 0.9287, 0.9287, 0.9287, 0.9287, 0.9287,
            0.9922, 0.9922, 0.9922, 0.9922, 0.9922, 0.9922, 0.9922, 0.9922,
            0.9994, 0.9994, 0.9994, 0.9994, 0.9994, 0.9994, 0.9994, 0.9994,
            1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
        ],
        "coverage_p90": [
            0.0064, 0.0143, 0.026, 0.0473, 0.0889, 0.1494, 0.2344, 0.3764,
            0.4227, 0.449, 0.4711, 0.4805, 0.4883, 0.4895, 0.4928, 0.4967,
            0.4986, 0.4986, 0.4986, 0.4986, 0.4986, 0.4986, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.76, 0.76, 0.76, 0.76, 0.76,
            0.76, 0.76, 0.76, 0.9531, 0.9531, 0.9531, 0.9531, 0.9531, 0.9531,
            0.9531, 0.9531, 0.998, 0.998, 0.998, 0.998, 0.998, 0.998, 0.998,
            0.998, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
            1.0, 1.0, 1.0, 1.0, 1.0,
        ],
        "converged_frac": 1.0,
        "t_at_coverage": {
            "0.5": 0.64, "0.75": 1.6, "0.9": 1.6, "0.99": 1.76, "1.0": 2.08,
        },
    },
    "resolve_wave(headline waves)": {
        "waves": 20, "pks": 9238, "alive": 8254,
        "sha256": (
            "cf1f3b93b85e02ed9bf9929c5bb1cfb4b4dd8312b0b8c67d73f051cf1ca8aaed"
        ),
        "numpy_equal": True,
    },
    "resolve_wave(131,072 changes)": {
        "waves": 1, "pks": 41447, "alive": 30172,
        "sha256": (
            "e9494006e9623e34bf716cd16adbf89e5b60da01e13dbee945576aef70f2ba0f"
        ),
        "numpy_equal": True,
    },
}
# CHURNDIFF_N64 / N256.json's "model" blocks equal the reference's
# results today, so the records are the gates
HARNESS_RECORDS = {"model_churn_trace(64, cycles=3)": "CHURNDIFF_N64.json",
                   "model_churn_trace(256, cycles=3)": "CHURNDIFF_N256.json"}


def subs_waves(seed: int, n_changes: int, pk_space: int,
               wave_size: int) -> list:
    """bench.py ``_subs_make_burst``'s waves from ``random.Random(seed)``
    as the port's ``Change`` rows: mostly upserts with a delete tail,
    several changes a pk, so waves carry duplicate and superseded
    work."""
    import random

    from corrosion_tpu_torch.agent.pack import pack_values
    from corrosion_tpu_torch.types.base import CrsqlDbVersion, CrsqlSeq
    from corrosion_tpu_torch.types.change import SENTINEL_CID, Change

    rng = random.Random(seed)
    actor = b"\xbb" * 16
    hi, waves = {}, []
    for v, base in enumerate(range(0, n_changes, wave_size), 1):
        changes = []
        for seq in range(min(wave_size, n_changes - base)):
            pk = rng.randrange(pk_space)
            if rng.random() < 0.1:
                cid, val, cv, cl = SENTINEL_CID, None, hi.get(pk, 1), 2
            else:
                cv = hi.get(pk, 0) + 1
                hi[pk] = cv
                cid, val, cl = "text", f"v{v}s{seq}", 1
            changes.append(Change(
                table="tests", pk=pack_values([pk]), cid=cid, val=val,
                col_version=cv, db_version=CrsqlDbVersion(v),
                seq=CrsqlSeq(seq), site_id=actor, cl=cl))
        waves.append(changes)
    return waves


def wave_summary(resolved: list, plain: list) -> dict:
    """Counts and a sha256 over resolved waves' (pks, alive), and
    whether they equal ``plain`` (the NumPy twin's) exactly."""
    import hashlib

    h = hashlib.sha256()
    for pks, alive in resolved:
        h.update(len(pks).to_bytes(4, "little"))
        for pk, a in zip(pks, alive):
            h.update(len(pk).to_bytes(2, "little") + pk + bytes([a]))
    return {"waves": len(resolved),
            "pks": sum(len(p) for p, _ in resolved),
            "alive": sum(sum(a) for _, a in resolved),
            "sha256": h.hexdigest(), "numpy_equal": resolved == plain}


def harness_diff(got, want, path: str = "") -> list:
    """Where ``got`` departs from the reference's ``want``: keys in the
    reference's order, tick and integer fields equal, floats to rel_tol
    1e-6, entries of the coverage lists within 1e-4."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            keys = list(got) if isinstance(got, dict) else got
            return [f"{path}: keys {keys}, the reference's {list(want)}"]
        return [d for k in want
                for d in harness_diff(got[k], want[k], f"{path}.{k}")]
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return [f"{path}: {got}, the reference gives {want}"]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in harness_diff(g, w, f"{path}[{i}]")]
    leaf = path.rsplit(".", 1)[-1].split("[")[0]
    if (isinstance(want, float) and isinstance(got, float)
            and "tick" not in leaf):
        ok = (abs(got - want) <= 1e-4 if leaf in COVERAGE_KEYS
              else math.isclose(got, want, rel_tol=1e-6))
    else:
        ok = got == want and (got is None) == (want is None)
    return [] if ok else [f"{path}: {got}, the reference gives {want}"]


def harness_want(label: str) -> dict:
    if label in HARNESS_RECORDS:
        with open(os.path.join(HERE, HARNESS_RECORDS[label])) as f:
            return json.load(f)["model"]
    return HARNESS_WANT[label]


def harness_jobs() -> list:
    """Phase 21's calls through the twins' entry points on the card:
    (label, call, kernels its path launches)."""
    from corrosion_tpu_torch.agent import submatch
    from corrosion_tpu_torch.sim import chaos, churndiff, obs, scenarios
    from corrosion_tpu_torch.sim import timeline

    jobs = [
        ("sim_obs_trace(32)", lambda: obs.sim_obs_trace(32, device="cuda"),
         TRACK_SENT_SYNC),
        ("sim_chaos_trace(32)",
         lambda: chaos.sim_chaos_trace(32, device="cuda"), TRACK_SENT_SYNC),
        ("sim_chaos_trace(512, oneway_blocks=((0, 1),))",
         lambda: chaos.sim_chaos_trace(512, oneway_blocks=((0, 1),),
                                       device="cuda"), PERM_PATH),
    ]
    for n in (32, 512):
        for fam in scenarios.FAMILIES:
            perm = fam in ("asym_partition", "compound") and n > 128
            jobs.append((
                f"sim_prediction({fam!r}, {n}, 0.64)",
                lambda fam=fam, n=n: scenarios.sim_prediction(
                    fam, n, 0.64, device="cuda"),
                PERM_PATH if perm else TRACK_SENT_SYNC))
    for n in (32, 512):
        jobs.append((f"kernel_coverage_prediction({n}, 64)",
                     lambda n=n: timeline.kernel_coverage_prediction(
                         n, 64, device="cuda"), PERM_PATH))
    for n in (64, 256):
        jobs.append((f"model_churn_trace({n}, cycles=3)",
                     lambda n=n: churndiff.model_churn_trace(
                         n, cycles=3, device="cuda"), SWIM_KERNELS))
    # the NumPy twin's answers, made before the counted runs
    for label, spec, backend in (("resolve_wave(headline waves)",
                                  SUBS_HEADLINE, "torch"),
                                 ("resolve_wave(131,072 changes)",
                                  SUBS_WIDE, "auto")):
        waves = subs_waves(**spec)
        plain = [submatch.resolve_wave(w, backend="numpy") for w in waves]
        jobs.append((label, lambda waves=waves, plain=plain,
                     backend=backend: wave_summary(
                         [submatch.resolve_wave(w, backend=backend,
                                                device="cuda")
                          for w in waves], plain), WINNERS_COUNTED))
    return jobs


def harness_phase(counted) -> dict:
    """Phase 21: the prediction halves of the six sim-vs-agent harnesses
    and the subscription matcher's wave resolver, each call through its
    entry point on the card with the launch counters zeroed just before
    it, held to the reference's result for the same call on the CPU
    (``harness_want``, ``wall_s`` left out) and required to launch every
    kernel its path runs."""
    runs = {}
    t0 = time.perf_counter()
    for label, run, kernels_ in harness_jobs():
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        t1 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        launches = {name: counted[name].launches for name in kernels_}
        res.pop("wall_s", None)
        runs[label] = dict(run_s=run_s, launches=launches, result=res)
        print(f"{label}: " + json.dumps(runs[label]), flush=True)
        diff = harness_diff(res, harness_want(label), label)
        if diff:
            fail("; ".join(diff[:8]))
        idle = [name for name, c in launches.items() if c == 0]
        if idle:
            fail(f"{label}: kernels never launched: {idle}")
    print(f"phase 21: {len(runs)} harness calls held to the reference in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return runs


# -- the twin of dryrun_multichip: the two-axis mesh (phase 22) ------------

MULTICHIP_SHAPE = (2, 4)  # (seeds_ax, nodes_ax)
MULTICHIP_SEEDS = 4
MULTICHIP_TICKS = 16  # the partition, its heal at 12, syncs at 7 and 15
MULTICHIP_CHECK = (7, 5)  # (tick, shard) of (d)'s delivery and sync
SWIM_MESH_SHARDS = 4
SWIM_MESH_TICKS = 32
SWIM_MESH_CHECK = (22, 2)  # the revive tick, shard 2
SWIM_MESH_LOSS = 0.05  # false suspicions, so live nodes refute
SYNC_SOURCE = "corrosion_tpu_torch/kernels/csrc/sync_pull.cu"
SWIM_SOURCE = "corrosion_tpu_torch/kernels/csrc/swim.cu"
EPIDEMIC_MESH_COUNTED = ("threefry_bits", "seg_argsort", "deliver_perm",
                         "sync_pull")
SWIM_MESH_COUNTED = SWIM_KERNELS


def multichip_cfg():
    """(b)'s config per seed: the headline's."""
    from corrosion_tpu_torch.sim.epidemic import HEADLINE

    return HEADLINE


def swim_mesh_churn():
    from corrosion_tpu_torch.sim.churn import ChurnConfig

    cfg = ChurnConfig(n_nodes=4096, kill_tick=2, revive_tick=22)
    return cfg, replace(cfg.params, loss=SWIM_MESH_LOSS)


def delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def multichip_epidemic(counted, dev) -> tuple:
    """Phase 22b: the headline's config per seed (100k nodes, R = 8,
    loss 0.05, two partition blocks healing at tick 12, sync every 8),
    4 seeds under ``split(PRNGKey(7), 4)`` over a (2, 4) mesh of 8
    ``LocalFabric`` shards on the card, ``MULTICHIP_TICKS`` ticks (tick
    key ``fold_in(seed key, tick)``), each seed's every leaf bitwise its
    single-device ``epidemic_tick`` after every tick.  Returns the run
    (walls, fabric bytes and calls a tick, launches of the sharded
    ticks alone) and (d)'s inputs: seed 0's state before
    ``MULTICHIP_CHECK``'s tick and its key."""
    from corrosion_tpu_torch import entry
    from corrosion_tpu_torch.mesh import MESH_AXES, LocalFabric, Mesh
    from corrosion_tpu_torch.models.sharded import sharded_epidemic_tick
    from corrosion_tpu_torch.random import PRNGKey, fold_in, split
    from corrosion_tpu_torch.sim.epidemic import (
        _sync_due,
        epidemic_init,
        epidemic_tick,
    )

    cfg = multichip_cfg()
    fabric = LocalFabric(MULTICHIP_SHAPE[0] * MULTICHIP_SHAPE[1], dev)
    mesh = Mesh(MESH_AXES, fabric, MULTICHIP_SHAPE)
    base = list(split(PRNGKey(7), MULTICHIP_SEEDS))
    single = [epidemic_init(cfg, device=dev) for _ in base]
    batched = entry.batch_state(single[0], MULTICHIP_SEEDS)
    specs = entry.epidemic_shardings(mesh, batched)
    state = entry.shard_state(batched, mesh, specs)
    step = sharded_epidemic_tick(mesh, cfg)
    launches = dict.fromkeys(EPIDEMIC_MESH_COUNTED, 0)
    ticks, check = [], None
    for t in range(MULTICHIP_TICKS):
        keys = [fold_in(k, t) for k in base]
        if t == MULTICHIP_CHECK[0]:
            check = (single[0], keys[0])
        torch.cuda.synchronize()
        b0, c0 = dict(fabric.bytes), dict(fabric.calls)
        l0 = {k: counted[k].launches for k in launches}
        t0 = time.perf_counter()
        state = step(state, keys)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k in launches:
            launches[k] += counted[k].launches - l0[k]
        t0 = time.perf_counter()
        single = [epidemic_tick(st, k, cfg) for st, k in zip(single, keys)]
        torch.cuda.synchronize()
        single_wall = time.perf_counter() - t0
        got = entry.unshard_state(state, specs)
        for s, st in enumerate(single):
            if not entry.leaves_equal(entry.seed_state(got, s), st):
                fail(f"sharded epidemic seed {s} differs from the "
                     f"single-device tick at tick {t}")
        ticks.append(dict(tick=t, sync=_sync_due(cfg, t),
                          partition=t < cfg.heal_tick, wall_s=wall,
                          single_wall_s=single_wall,
                          bytes=delta(fabric.bytes, b0),
                          calls=delta(fabric.calls, c0)))
    covered = float(sum((st.rows == st.rows[0]).all(dim=1).float().mean()
                        for st in single) / len(single))
    run = dict(n_nodes=cfg.n_nodes, seeds=MULTICHIP_SEEDS,
               mesh=dict(zip(MESH_AXES, MULTICHIP_SHAPE)),
               ticks=ticks, launches=launches, coverage=covered,
               bytes=dict(fabric.bytes), calls=dict(fabric.calls))
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        fail(f"sharded epidemic never launched {idle}")
    return run, check


def multichip_swim(counted, dev) -> tuple:
    """Phase 22c: the churn run's width (N = 4096, ``SwimParams.scaled``)
    with ``SWIM_MESH_LOSS`` over 4 node shards on the card, 32 ticks of
    ``sim/churn.py``'s schedule (victim 1 killed at tick 2, revived at
    22), every leaf and the churn flags bitwise the single-device
    ``swim_step`` after every tick; suspicion, DOWN, a refutation and
    the rejoin must each happen.  Returns the run and (d)'s inputs:
    the state before ``SWIM_MESH_CHECK``'s tick and its tick inputs."""
    from corrosion_tpu_torch import entry
    from corrosion_tpu_torch.mesh import LocalFabric, Mesh
    from corrosion_tpu_torch.models.sharded import sharded_swim_step
    from corrosion_tpu_torch.models.swim import (
        ALIVE,
        DOWN,
        SUSPECT,
        swim_init,
        swim_step,
    )
    from corrosion_tpu_torch.random import PRNGKey, fold_in
    from corrosion_tpu_torch.sim.churn import _schedule

    cfg, params = swim_mesh_churn()
    n = cfg.n_nodes
    fabric = LocalFabric(SWIM_MESH_SHARDS, dev)
    mesh = Mesh("nodes", fabric)
    single = swim_init(n, device=dev)
    specs = entry.swim_shardings(mesh, single)
    state = entry.shard_state(single, mesh, specs)
    step = sharded_swim_step(mesh, params)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)
    want_flags = torch.zeros(2, dtype=torch.int32, device=dev)
    launches = dict.fromkeys(SWIM_MESH_COUNTED, 0)
    ticks, check = [], None
    seen = dict(suspect=0, down=0, refuted=0, rejoined=0)
    for t in range(SWIM_MESH_TICKS):
        victim, dead, rev = _schedule(cfg, t)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        alive[victim] = not dead
        revived = torch.zeros(n, dtype=torch.bool, device=dev)
        revived[victim] = rev
        key = fold_in(PRNGKey(0), t)
        if t == SWIM_MESH_CHECK[0]:
            check = (single, key, t, params, alive, revived, victim)
        inc_before = single.incarnation.clone()
        torch.cuda.synchronize()
        b0, c0 = dict(fabric.bytes), dict(fabric.calls)
        l0 = {k: counted[k].launches for k in launches}
        t0 = time.perf_counter()
        state = step(state, key, t, alive, revived, victim=victim,
                     flags=flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k in launches:
            launches[k] += counted[k].launches - l0[k]
        t0 = time.perf_counter()
        single = swim_step(single, key, t, params, alive, revived=revived,
                           victim=victim, flags=want_flags)
        torch.cuda.synchronize()
        single_wall = time.perf_counter() - t0
        if not entry.leaves_equal(entry.unshard_state(state, specs),
                                  single):
            fail(f"sharded swim differs from the single-device step at "
                 f"tick {t}")
        if not torch.equal(flags, want_flags):
            fail(f"sharded swim's churn flags differ at tick {t}")
        col = single.view[:, victim] % 4
        bumped = single.incarnation > inc_before
        seen["suspect"] += int((single.view % 4 == SUSPECT).any())
        seen["down"] += int((col == DOWN).any())
        seen["refuted"] += int((bumped & ~revived).any())
        seen["rejoined"] += int(bool(bumped[victim]) and rev)
        ticks.append(dict(tick=t, wall_s=wall, single_wall_s=single_wall,
                          victim_down=int((col == DOWN).sum()),
                          victim_alive=int((col == ALIVE).sum()),
                          bytes=delta(fabric.bytes, b0),
                          calls=delta(fabric.calls, c0)))
    missing = [k for k, v in seen.items() if v == 0]
    if missing:
        fail(f"sharded swim run never saw {missing}: {seen}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        fail(f"sharded swim never launched {idle}")
    run = dict(n_nodes=n, shards=SWIM_MESH_SHARDS, loss=params.loss,
               ticks=ticks, launches=launches, seen=seen,
               flags=flags.tolist(), bytes=dict(fabric.bytes),
               calls=dict(fabric.calls))
    return run, check


def window_result(name, source, replaces, err, ms, plain_ms, bound,
                  shape) -> dict:
    r = dict(name=name, route="cuda", source=source, replaces=replaces,
             max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=bound,
             library_ms=None, shape=shape)
    set_bound(r)
    if err != 0.0:
        fail(f"{name} differs from its plain version: {err}")
    return r


def epidemic_window_checks(check, dev) -> list:
    """Phase 22d, the epidemic's two windows at (b)'s shape: shard
    ``MULTICHIP_CHECK[1]``'s receivers of seed 0 before tick
    ``MULTICHIP_CHECK[0]`` (partition in force, a sync tick):
    ``deliver_perm``'s window (the senders' hops gathered, hops,
    next_send, loss and partition) and ``sync_pull``'s (the [N] charges
    of the serving peers) against their plain versions, timed."""
    from corrosion_tpu_torch.kernels import deliver, sync_pull
    from corrosion_tpu_torch.models.sharded import _loss_u, _senders
    from corrosion_tpu_torch.random import randint, split
    from corrosion_tpu_torch.sim.epidemic import _partition_ids

    st, key = check
    cfg = multichip_cfg()
    params = cfg.broadcast_params
    n, r = st.rows.shape
    k = params.fanout
    nl = n // MULTICHIP_SHAPE[1]
    lo = (MULTICHIP_CHECK[1] % MULTICHIP_SHAPE[1]) * nl
    w = slice(lo, lo + nl)
    k_b, k_s = split(key)
    key_t, key_l = split(k_b)
    part = _partition_ids(cfg, dev)
    active = st.tick < cfg.heal_tick
    shops = deliver.sender_hops(st.tx_remaining, st.next_send, st.tick,
                                st.hops)
    senders = _senders(key_t, params, dev)
    loss_u = _loss_u(key_l, params, dev)
    args = dict(hops=st.hops[w], next_send=st.next_send[w], tick=st.tick,
                loss_u=loss_u, partition_id=part, partition_active=active,
                loss=params.loss, max_tx=params.max_transmissions,
                backoff=params.backoff_ticks, src_rows=st.rows, shops=shops,
                lo=lo)
    mine = (st.rows[w], st.tx_remaining[w], st.msgs[w], senders)
    err = max_abs_err(deliver.deliver_perm(*mine, **args),
                      deliver.deliver_perm_plain(*mine, **args))
    # the same window through a slot map of the active senders (hop
    # candidate 0): the source mode's hops, next_send and partition
    slots = {**args, "shops": None, "slot_of": torch.where(
        shops < deliver.HOP_UNSET, torch.arange(n, dtype=torch.int32,
                                                device=dev), -1).to(
        torch.int32)}
    err = max(err, max_abs_err(deliver.deliver_perm(*mine, **slots),
                               deliver.deliver_perm_plain(*mine, **slots)))
    s = senders[:, w].to(torch.int64)  # [K, nl]
    taken = ((shops[s] < deliver.HOP_UNSET) & ~(loss_u[w].T < params.loss)
             & ~((part[s] != part[w][None, :]) & active))
    # my rows, tx, msgs, hops and next_send read and written; K ids and
    # draws read; a sector of shops and of the partition for each column;
    # a sector a row taken
    dbytes = (nl * (2 * r * 4 + 8 * 4 + 4) + nl * k * (8 + 2 * SECTOR)
              + int(taken.sum()) * max(r * 4, SECTOR))
    out = [window_result(
        "deliver_perm (window)", DELIVER_SOURCE,
        "corrosion_tpu/models/broadcast.py:327", err,
        time_device_ms(lambda: deliver.deliver_perm(*mine, **args), 20),
        time_ms(lambda: deliver.deliver_perm_plain(*mine, **args), 3),
        (dbytes, 0), f"shard {MULTICHIP_CHECK[1]}'s {nl} receivers of {n} "
                     f"(seed 0, tick {st.tick}), R={r}, K={k}")]
    offs = randint(k_s, (n, cfg.sync_peers), 1, max(n, 2), device=dev)
    sargs = dict(src_rows=st.rows, lo=lo, partition_id=part,
                 partition_active=active,
                 cells_per_chunk=cfg.cells_per_chunk,
                 handshake_msgs=cfg.sync_params.handshake_msgs)
    smine = (st.rows[w], st.msgs[w], offs, n)
    err = max_abs_err(sync_pull.sync_pull(*smine, **sargs),
                      sync_pull.sync_pull_window_plain(*smine, **sargs))
    peers = (torch.arange(lo, lo + nl, device=dev)[:, None]
             + offs[w].to(torch.int64)) % n
    up = ~((part[peers] != part[w][:, None]) & active)
    # my rows read and written, msgs read and written, my offsets, a
    # sector of the partition a draw, for each session a peer row and a
    # charge's sector, the [N] delta zeroed and read back
    sbytes = (nl * (2 * r * 4 + 8) + offs[w].numel() * (4 + SECTOR)
              + int(up.sum()) * (max(r * 4, SECTOR) + SECTOR) + 8 * n)
    out.append(window_result(
        "sync_pull (window)", SYNC_SOURCE, "corrosion_tpu/models/sync.py:90",
        err, time_device_ms(lambda: sync_pull.sync_pull(*smine, **sargs), 20),
        time_ms(lambda: sync_pull.sync_pull_window_plain(*smine, **sargs), 3),
        (sbytes, 0), f"shard {MULTICHIP_CHECK[1]}'s {nl} clients of {n}, "
                     f"P={cfg.sync_peers}, R={r}"))
    return out


def swim_window_checks(check, dev) -> list:
    """Phase 22d, the SWIM tick's windows at (c)'s shape: shard
    ``SWIM_MESH_CHECK[1]`` of 4 before the revive tick, each phase of
    ``swim_window_launch`` (the selection; the gossip, ping and ack
    passes with their read-backs and the records at the targets; the
    settle) against its plain version on the inputs the whole tick's
    plain phases give it (the exchanges' results), every output
    bitwise, each timed with its inputs restored."""
    from corrosion_tpu_torch.kernels import swim as ksw

    st, key, tick, params, alive, revived, victim = check
    n = st.view.shape[0]
    nl = n // SWIM_MESH_SHARDS
    lo = SWIM_MESH_CHECK[1] * nl
    w = slice(lo, lo + nl)
    keys = ksw.tick_keys(key)
    gossip = params.gossip_targets > 0
    rows = torch.arange(n, device=dev)
    incd = torch.stack([st.incarnation, st.view[rows, rows]]).contiguous()
    # every row's plain phases: the exchanges' results
    sel = ksw.swim_select_window_plain(st.view, st.suspect_since,
                                       st.update_tx, incd, keys, tick,
                                       params, alive, revived, 0)
    ge, sendable, pay = sel["ge"], sel["sendable"], sel["pay"]
    target = sel["target"]
    probe = sel["probe"]
    v1, sent1 = ksw.swim_gossip_window_plain(sel["view"], ge, sendable, pay,
                                             keys, params, alive, 0, gossip)
    v2, sent2 = ksw.swim_ping_window_plain(v1, ge, sendable, target, probe,
                                           sent1, 0)
    v3, peer_rec = ksw.swim_ack_window_plain(v2, ge, sendable, target, probe,
                                             sent2, 0)
    m = ge.shape[1]
    call = ksw.WindowCall(st.view[w], st.suspect_since[w], st.update_tx[w],
                          keys, tick, params, alive, revived, lo, victim)
    out = []

    # the selection
    def select():
        return ksw._select_window(call, st.view[w], st.suspect_since[w],
                                  st.update_tx[w], incd)

    got = select()
    want = ksw.swim_select_window_plain(
        st.view[w], st.suspect_since[w], st.update_tx[w], incd, keys, tick,
        params, alive, revived, lo)
    names = ("view", "target", "inc1", "probe", "ge", "sendable", "pay",
             "counts")
    err = max_abs_err([got[k] for k in names], [want[k] for k in names])
    mat = 4 * nl * n
    hashed = int((st.update_tx[w] < params.update_tx_limit).sum())
    suspect = int((st.view[w] % 4 == ksw.SUSPECT).sum())
    out.append(window_result(
        "swim_probe_select (window)", SWIM_SOURCE,
        "corrosion_tpu/models/swim.py:108", err,
        time_device_ms(select, 10),
        time_ms(lambda: ksw.swim_select_window_plain(
            st.view[w], st.suspect_since[w], st.update_tx[w], incd, keys,
            tick, params, alive, revived, lo), 3),
        (3 * mat + suspect * SECTOR + nl * m * 9 + 8 * n,
         hashed * INT_OPS_PER_UNIFORM),
        f"shard {SWIM_MESH_CHECK[1]}'s {nl} rows of N = {n}, tick {tick}"))

    # the three passes: each kernel on a copy of the view the pass before
    # left, against its plain version
    ins = {ksw.W_GOSSIP if gossip else ksw.W_COLLECT: sel["view"][w],
           ksw.W_PING: v1[w], ksw.W_ACK: v2[w]}
    ptrs = {ksw.W_GOSSIP: dict(ge=ge, sendable=sendable, pay=pay),
            ksw.W_COLLECT: dict(ge=ge, sendable=sendable, pay=pay),
            ksw.W_PING: dict(ge=ge, sendable=sendable, target=target,
                             probe=probe, sent=sent1),
            ksw.W_ACK: dict(ge=ge, sendable=sendable, target=target,
                            probe=probe, sent=sent2)}
    plain = {ksw.W_GOSSIP: lambda v: ksw.swim_gossip_window_plain(
                 v, ge, sendable, pay, keys, params, alive, lo, gossip),
             ksw.W_PING: lambda v: ksw.swim_ping_window_plain(
                 v, ge, sendable, target, probe, sent1, lo),
             ksw.W_ACK: lambda v: ksw.swim_ack_window_plain(
                 v, ge, sendable, target, probe, sent2, lo)}
    plain[ksw.W_COLLECT] = plain[ksw.W_GOSSIP]
    work = {ph: v.clone() for ph, v in ins.items()}
    outs = {}

    def run_pass(ph):
        if ph == ksw.W_ACK:
            rec = torch.empty(n, dtype=torch.int32, device=dev)
            call(ph, "swim_disseminate", view=work[ph], peer_rec=rec,
                 **ptrs[ph])
            outs[ph] = (work[ph], rec)
        else:
            outs[ph] = ksw._pass_window(call, ph, work[ph], **ptrs[ph])

    err, ms, plain_ms = 0.0, 0.0, 0.0
    for ph, v in ins.items():
        work[ph].copy_(v)
        run_pass(ph)
        err = max(err, max_abs_err(outs[ph], plain[ph](v.clone())))
        ms += time_inplace_ms(lambda: work[ph].copy_(v),
                              lambda: run_pass(ph), 10)
        plain_ms += time_ms(lambda: plain[ph](v.clone()), 3)
    # the raises landing in my rows, a pass each
    gt = ksw.rand_peers(keys, "gt", (n, params.gossip_targets), n, dev)
    mine_gt = (gt >= lo) & (gt < lo + nl)
    gossip_raises = int((alive[:, None, None]
                         & ksw.surviving_legs(keys, "gloss",
                                              (n, gt.shape[1], m),
                                              params.loss, dev)
                         & (alive[gt] & mine_gt)[:, :, None]
                         & sendable.bool()[:, None, :]).sum())
    t64 = target.to(torch.int64)
    ping_raises = int((((probe & ksw.PING_OK) != 0)
                       & (t64 >= lo) & (t64 < lo + nl))[:, None]
                      .logical_and(sendable.bool()).sum())
    ack_raises = int((((probe[w] & ksw.ACK_OK) != 0)[:, None]
                      & sendable.bool()[t64[w]]).sum())
    raises = gossip_raises + ping_raises + ack_raises
    # the gathered selection, targets and flags read by the passes; a
    # sector a raise; my selected cells read back twice; each prober's
    # record at a target of mine; the targets' draws and the gossip legs'
    out.append(window_result(
        "swim_disseminate (window)", SWIM_SOURCE,
        "corrosion_tpu/models/swim.py:226", err, ms, plain_ms,
        (3 * n * m * 9 + n * 5 + raises * SECTOR + 2 * nl * m * (SECTOR + 4)
         + nl * SECTOR + n * 4,
         n * gt.shape[1] * 2 * INT_OPS_PER_HASH
         + (n * gt.shape[1] * m * INT_OPS_PER_UNIFORM
            if params.loss > 0 else 0)),
        f"shard {SWIM_MESH_CHECK[1]}'s {nl} rows of N = {n}, tick {tick}: "
        f"{gossip_raises} / {ping_raises} / {ack_raises} raises"))

    # the settle
    counts = sel["counts"]
    view3 = v3[w].clone()

    def settle():
        ss = torch.empty_like(st.suspect_since[w])
        inc = torch.empty(nl, dtype=torch.int32, device=dev)
        tx = torch.empty_like(st.update_tx[w])
        fl = torch.zeros(2, dtype=torch.int32, device=dev)
        call(ksw.W_SETTLE, "swim_settle", view_in=st.view[w],
             ss_in=st.suspect_since[w], tx_in=st.update_tx[w], view=view3,
             ss=ss, inc=inc, tx=tx, target=target, inc1=sel["inc1"][w],
             pinged=counts[1], ge=ge, sendable=sendable, peer_rec=peer_rec,
             flags=fl)
        return view3, ss, inc, tx, fl

    got = settle()
    want = ksw.swim_settle_window_plain(
        v3[w], st.view[w], st.suspect_since[w], st.update_tx[w], ge,
        sendable, target, sel["inc1"][w], counts, peer_rec, keys, tick,
        params, alive, lo, victim, True)
    err = max_abs_err(got, want)
    out.append(window_result(
        "swim_settle (window)", SWIM_SOURCE,
        "corrosion_tpu/models/swim.py:277", err,
        time_inplace_ms(lambda: view3.copy_(v3[w]), settle, 10),
        time_ms(lambda: ksw.swim_settle_window_plain(
            v3[w], st.view[w], st.suspect_since[w], st.update_tx[w], ge,
            sendable, target, sel["inc1"][w], counts, peer_rec, keys, tick,
            params, alive, lo, victim, True), 3),
        (6 * mat + nl * m * 5 + nl * 12, 0),
        f"shard {SWIM_MESH_CHECK[1]}'s {nl} rows of N = {n}, tick {tick}"))
    return out


def multichip_phase(record: dict, counted: dict, dev) -> list:
    """Phase 22, the twin of ``dryrun_multichip`` through
    ``corrosion_tpu_torch.entry``: (a) ``dryrun_multichip(8)`` as 8
    shards of a ``LocalFabric`` on the card with every assert of the
    reference's inline path; (b) the headline's width over the (2, 4)
    mesh; (c) SWIM at 4096 over 4 node shards through churn; (d) each
    window kernel against its plain version.  Returns (d)'s results
    with the launches of (b) and (c), and adds their ``threefry_bits``
    and ``seg_argsort`` launches to ``record["multichip_draws"]``."""
    from corrosion_tpu_torch import entry

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    before = {k: f.launches for k, f in counted.items()}
    dry = entry.dryrun_multichip(8, device="cuda")
    torch.cuda.synchronize()
    dry["launches"] = {k: f.launches - before[k]
                       for k, f in counted.items()
                       if f.launches != before[k]}
    dry["s"] = time.perf_counter() - t0
    record["dryrun_multichip"] = dry
    print(json.dumps({"dryrun_multichip": {
        "s": dry["s"], "launches": dry["launches"],
        "fabric": dry["fabric"]}}), flush=True)

    epidemic, e_check = multichip_epidemic(counted, dev)
    record["multichip_epidemic"] = epidemic
    print(json.dumps({"multichip_epidemic": epidemic}), flush=True)
    swim, s_check = multichip_swim(counted, dev)
    record["multichip_swim"] = swim
    print(json.dumps({"multichip_swim": swim}), flush=True)

    results = epidemic_window_checks(e_check, dev)
    results += swim_window_checks(s_check, dev)
    runs = {**epidemic["launches"], **swim["launches"]}
    for r in results:  # "<counter> (window)"
        r["launches"] = runs[r["name"].removesuffix(" (window)")]
    record["multichip_draws"] = {k: epidemic["launches"][k]
                                 for k in ("threefry_bits", "seg_argsort")}
    print(json.dumps({"window_kernels": {r["name"]: {f: r[f] for f in (
        "ms", "plain_ms", "bound_ms", "bound_by", "launches", "shape")}
        for r in results}}), flush=True)
    print(f"phase 22: the two-axis mesh held to the single-device steps in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return results


# -- the live agent on the card (phase 23) ---------------------------------

BITMATCH_RECORDS = ("BITMATCH_N256.json", "BITMATCH_N64.json")
# one local transaction whose version holds more changes than
# ops.merge.TORCH_AUTO_MIN (one change a row: tests has one data column),
# also without the changes that lose to the older version on B: C's sync
# may be served by B, which serves only the changes that won there
AGENT_ROWS = 70_000
AGENT_UPDATE_ROWS = 4096  # the rows B updates, twice
AGENT_WAIT_S = 180.0  # the bound on every wait of 23b and 23c
# an older version of another actor over one row in AGENT_OLD_STEP of A's
AGENT_OLD_SITE = bytes(range(200, 216))
AGENT_OLD_STEP = 16
AGENT_COUNTED = ("seg_argsort", "seg_cummax", "winners_a", "winners_b",
                 "store_set", "store_gather")
WINNER_KERNELS = AGENT_COUNTED[:4]
STORE_KERNELS = AGENT_COUNTED[4:]


def cache_arrays(agent) -> list:
    """The arrays of an agent's clock cache (its tables' row and cell
    clocks)."""
    dc = agent.storage.device_cache
    if dc is None:
        return []
    return [a for tc in dc._tables.values() for a in (tc.row_cl, tc.cell_ver)]


def cache_on(agent, dev) -> bool:
    """The agent's clock cache is a torch store on ``dev`` that holds
    arrays, every one of them there."""
    dc = agent.storage.device_cache
    arrays = cache_arrays(agent)
    return (dc is not None and dc.backend == "torch"
            and dc.store.device.type == dev.type and bool(arrays)
            and all(a.device.type == dev.type for a in arrays))


def zero(counted) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0


def read_launches(counted, names) -> dict:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {name: counted[name].launches for name in names}


def bitmatch_run(counted, record: str, dev) -> dict:
    """Phase 23a: ``run_bitmatch`` through the port's deterministic
    cluster of real agents run for ``dev``, with the record's own
    arguments, held to the record field for field.  A check of the
    protocol: the bit-match's versions are one change each, which the
    storage applies change by change, so its agents make no cache array
    and launch no kernel (the launches and the device memory above the
    baseline are printed, and are 0)."""
    from corrosion_tpu_torch.sim.bitmatch import run_bitmatch

    with open(os.path.join(HERE, record)) as fh:
        want = json.load(fh)
    zero(counted)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    got = run_bitmatch(
        want["n_nodes"], writes=want["writes"], seed=want["seed"],
        fanout=want["fanout"], max_transmissions=want["max_transmissions"],
        backoff_ticks=want["backoff_ticks"], loss=want["loss"],
        ring0_size=want["ring0_size"], sync_interval=want["sync_interval"],
        sync_peers=want["sync_peers"], device=str(dev))
    wall = time.perf_counter() - t0
    launches = read_launches(counted, STORE_KERNELS)
    out = dict(record=record, wall_s=wall, launches=launches,
               per_write=[{k: w[k] for k in (
                   "origin", "ticks_compared", "converged_tick_sim",
                   "converged_tick_agents", "msgs_total",
                   "sync_msgs_total")} for w in got["per_write"]])
    if cuda:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        out["agents_mem_bytes"] = out["peak_mem_bytes"] - base
    print(f"phase 23a {record}: " + json.dumps(out), flush=True)
    if json.loads(json.dumps(got)) != want:
        fail(f"{record}: run_bitmatch gave {got}, want {want}")
    return out


def det_placement(dev) -> None:
    """Phase 23a: a ``DetCluster`` run for ``dev`` gives every agent a
    clock cache whose torch store lies there."""
    from corrosion_tpu_torch.agent.det import DetCluster, DetParams

    cluster = DetCluster(DetParams(n_nodes=2), device=str(dev))
    try:
        for a in cluster.agents:
            dc = a.storage.device_cache
            if (dc is None or dc.backend != "torch"
                    or dc.store.device.type != dev.type
                    or a.storage.device.type != dev.type):
                fail(f"phase 23a: a DetCluster agent's cache is not a "
                     f"torch store on {dev}")
    finally:
        cluster.close()


def old_version():
    """Version 1 of another actor over one row in ``AGENT_OLD_STEP`` of
    A's: by thirds, col_version 2 (it beats A's insert), or 1 with a
    value above A's (the tie goes to the larger value) or below it.  B
    and C hold it before A's write, A takes it after."""
    from corrosion_tpu_torch.agent.pack import pack_values
    from corrosion_tpu_torch.types import (
        ActorId,
        Changeset,
        ChangeV1,
        Timestamp,
        Version,
    )
    from corrosion_tpu_torch.types.change import Change, CrsqlDbVersion
    from corrosion_tpu_torch.types.change import CrsqlSeq

    chs = []
    for seq, i in enumerate(range(0, AGENT_ROWS, AGENT_OLD_STEP)):
        ver, val = ((2, f"d-{i}"), (1, f"zz-{i}"), (1, f"aa-{i}"))[seq % 3]
        chs.append(Change(
            table="tests", pk=pack_values([i]), cid="text", val=val,
            col_version=ver, db_version=CrsqlDbVersion(1),
            seq=CrsqlSeq(seq), site_id=AGENT_OLD_SITE, cl=1))
    n = len(chs)
    cs = Changeset.full(Version(1), chs, (0, n - 1), n - 1,
                        Timestamp.pack(1_600_000_000_000_000_000, 0))
    return ChangeV1(actor_id=ActorId(AGENT_OLD_SITE), changeset=cs)


def final_rows() -> list:
    """The rows every node must end with: A's insert, the older version
    where it wins, B's second update on the first rows."""
    rows = []
    for i in range(AGENT_ROWS):
        text = f"row-{i}"
        if i % AGENT_OLD_STEP == 0:
            kind = (i // AGENT_OLD_STEP) % 3
            text = (f"d-{i}", f"zz-{i}", text)[kind]
        if i < AGENT_UPDATE_ROWS:
            text = "b-1"
        rows.append((i, text))
    return rows


def preseed(path: str, cv, dev) -> None:
    """Apply ``cv`` to the node whose database lies in ``path``, before
    the node starts."""
    from corrosion_tpu_torch.agent.runtime import ChangeSource
    from corrosion_tpu_torch.agent.testing import make_offline_agent

    ag = make_offline_agent(tmpdir=path, device=str(dev), device_cache=True)
    try:
        if not ag.handle_change(cv, ChangeSource.SYNC, rebroadcast=False):
            fail("phase 23b: the older version was not news to a new node")
        ag.storage.flush_pending()
    finally:
        ag.storage.close()


class ApplySpy:
    """Records, while installed, each winner selection the agents'
    applies run through the kernels (its plan and the decision they
    took) and each call of a clock cache's torch store (its inputs and
    what it gave), for ``check`` to hold against the plain versions."""

    def __init__(self):
        from corrosion_tpu_torch.ops import devcache, merge

        self.merge, self.store_cls = merge, devcache.TorchStore
        self.real = (merge._winners_torch, self.store_cls.set,
                     self.store_cls.gather)
        self.decisions, self.stores = [], []

    def install(self) -> None:
        real_winners, real_set, real_gather = self.real
        spy = self

        def winners(plan, device="cuda", plain=False):
            dec = real_winners(plan, device, plain)
            if not plain:
                spy.decisions.append((plan, dec))
            return dec

        def store_set(store, arr, idx, vals):
            before = arr.clone()
            idx, vals = np.array(idx), np.array(vals)
            out = real_set(store, arr, idx, vals)
            spy.stores.append(("set", before, idx, vals, arr.clone()))
            return out

        def store_gather(store, arr, idx):
            idx = np.array(idx)
            got = real_gather(store, arr, idx)
            spy.stores.append(("gather", arr.clone(), idx, None, got))
            return got

        self.merge._winners_torch = winners
        self.store_cls.set, self.store_cls.gather = store_set, store_gather

    def remove(self) -> None:
        (self.merge._winners_torch, self.store_cls.set,
         self.store_cls.gather) = self.real

    def check(self, dev) -> dict:
        """Each recorded decision bitwise the plain torch core's and the
        NumPy twin's on its plan, each store call's result the plain
        version's on its inputs; returns the sizes checked."""
        from corrosion_tpu_torch.convert import decision_diff
        from corrosion_tpu_torch.kernels import store as kstore

        merge = self.merge
        for plan, dec in self.decisions:
            for other, name in (
                    (merge._winners_torch(plan, dev, plain=True),
                     "the plain torch core"),
                    (merge._winners_np(plan), "the NumPy twin")):
                diff = decision_diff(dec, other)
                if diff:
                    fail(f"phase 23b: the agent's winners on {plan.n} "
                         f"changes differ from {name} in {diff}")
        sizes = {"set": [], "gather": []}
        for kind, arr, idx, vals, got in self.stores:
            i = torch.from_numpy(kstore.host_index(idx, arr.shape[0])).to(
                arr.device)
            if kind == "set":
                v = torch.from_numpy(np.ascontiguousarray(
                    vals, dtype=np.int64).reshape(-1)).to(arr.device)
                ok = torch.equal(kstore.store_set_plain(arr, i, v), got)
            else:
                ok = np.array_equal(
                    kstore.store_gather_plain(arr, i).cpu().numpy(), got)
            if not ok:
                fail(f"phase 23b: the agent's store_{kind} of {len(idx)} "
                     "differs from its plain version")
            sizes[kind].append(len(idx))
        return dict(winners=[plan.n for plan, _ in self.decisions],
                    **{f"store_{k}": v for k, v in sizes.items()})


def settled(agent, read):
    """``read(conn)`` on the node's connection with its storage lock
    held and the write-behind queue drained: an apply or a drain still
    running on the agent's threads finishes first (the storage's
    ``flush_pending`` returns at once while another thread drains)."""
    from corrosion_tpu_torch.agent.locks import PRIO_HIGH

    st = agent.storage
    with st._lock.prio(PRIO_HIGH, "smoke-read", kind="apply"):
        st._wb_drain_locked()
        return read(st.conn)


def served(agent, actor) -> int:
    """The changes of ``actor`` in the node's clock of ``tests``: what the
    node serves of that actor's versions (those that lost there are
    gone)."""
    return settled(agent, lambda c: c.execute(
        "SELECT COUNT(*) FROM tests__corro_clock k JOIN __corro_sites s "
        "ON s.ordinal = k.site_ordinal WHERE s.site_id = ?",
        (bytes(actor),)).fetchone()[0])


def clock_state(agent) -> dict:
    """The node's rows of ``tests`` and its clock state: each cell's
    (pk, cid, col_version, origin site) and each row's causal length,
    in a fixed order (ordinals are local, so sites by id)."""
    return settled(agent, lambda c: dict(
        rows=c.execute("SELECT id, text FROM tests ORDER BY id").fetchall(),
        clock=c.execute(
            "SELECT k.pk, k.cid, k.col_version, s.site_id "
            "FROM tests__corro_clock k JOIN __corro_sites s "
            "ON s.ordinal = k.site_ordinal ORDER BY k.pk, k.cid").fetchall(),
        cl=c.execute("SELECT pk, cl FROM tests__corro_cl ORDER BY pk"
                     ).fetchall()))



# the catch-up arms of 23b: the node C of each syncs from this one
AGENT_ARMS = ("a", "b")
AGENT_SUB_SQL = "SELECT id, text FROM tests"


class SubStream:
    """A subscription opened over an agent's HTTP API, its NDJSON events
    read on a thread into the rows they describe (a snapshot, then each
    change by row id).  The server drops the oldest events of a reader
    slower than its matcher; at a gap in the change ids the stream
    resumes from the last id it holds, as a client of the API does."""

    def __init__(self, agent, sql: str):
        import threading

        self.addr = agent.api_addr
        self.rows, self.events, self.last_change_id = {}, 0, None
        self.error, self.closed, self.resumes = None, False, 0
        try:
            resp = self._open("POST", "/v1/subscriptions",
                              json.dumps(sql).encode())
        except OSError as e:
            fail(f"phase 23b: a subscription over HTTP: {e!r}")
        self.id = resp.headers["x-corro-query-id"]
        self.thread = threading.Thread(target=self._run, args=(resp,),
                                       daemon=True)
        self.thread.start()

    def _open(self, method: str, path: str, body=None):
        import http.client

        self.conn = http.client.HTTPConnection(*self.addr)
        self.conn.request(method, path, body)
        resp = self.conn.getresponse()
        if resp.status != 200:
            raise OSError(f"{method} {path} gave {resp.status}")
        return resp

    def _run(self, resp) -> None:
        import http.client

        try:
            while resp is not None:
                resp = self._read(resp)
        except (OSError, ValueError, http.client.HTTPException) as e:
            if not self.closed:
                self.error = repr(e)

    def _read(self, resp):
        """Apply ``resp``'s events; returns the resumed stream at a gap,
        None at its end."""
        for line in resp:
            ev = json.loads(line)
            self.events += 1
            if "columns" in ev:
                self.rows = {}
            elif "row" in ev:
                rid, cells = ev["row"]
                self.rows[rid] = tuple(cells)
            elif "change" in ev:
                kind, rid, cells, cid = ev["change"]
                if cid != self.last_change_id + 1:
                    self.resumes += 1
                    self.conn.close()
                    return self._open("GET", f"/v1/subscriptions/{self.id}"
                                      f"?from={self.last_change_id}")
                if kind == "delete":
                    self.rows.pop(rid, None)
                else:
                    self.rows[rid] = tuple(cells)
                self.last_change_id = cid
            elif "eoq" in ev:
                self.last_change_id = ev["eoq"]["change_id"]
        return None

    def close(self) -> None:
        import socket

        self.closed = True
        if self.conn.sock is not None:
            self.conn.sock.shutdown(socket.SHUT_RDWR)
        self.thread.join(timeout=10)
        self.conn.close()


class WireCount:
    """Counts, while installed, the SWIM datagrams the port's agents
    receive on each wire (the receiver's sniff: JSON envelopes start
    with ``{``, foca datagrams do not)."""

    def __init__(self):
        from corrosion_tpu_torch.agent.runtime import _UdpProtocol

        self.cls, self.real = _UdpProtocol, _UdpProtocol.datagram_received
        self.counts = {"foca": 0, "json": 0}

    def install(self) -> None:
        real, counts = self.real, self.counts

        def received(proto, data, addr):
            counts["json" if data.startswith(b"{") else "foca"] += 1
            return real(proto, data, addr)

        self.cls.datagram_received = received

    def remove(self) -> None:
        self.cls.datagram_received = self.real


def waiter(phase: str):
    """An awaitable ``until(pred, what)`` bounded by ``AGENT_WAIT_S``
    that fails ``phase`` when ``pred`` does not come true."""
    from corrosion_tpu_torch.agent.testing import wait_for

    async def until(pred, what: str):
        try:
            await wait_for(pred, timeout=AGENT_WAIT_S)
        except TimeoutError:
            fail(f"phase {phase}: {what} not within {AGENT_WAIT_S} s")

    return until


def has(x, actor, v) -> bool:
    return x.bookie.for_actor(actor).contains_version(v)


def counter(x, name, **labels) -> float:
    if labels:
        return x.metrics.get_counter(name, **labels)
    return x.metrics.get_counter_sum(name)


class SyncPins:
    """While installed, an agent pinned to a peer syncs from that peer
    alone (from nobody while pinned to None), and a session cut short is
    not retried elsewhere (the next round asks its peer again); every
    other agent syncs as the reference's does."""

    def __init__(self):
        from corrosion_tpu_torch.agent.runtime import Agent

        self.cls = Agent
        self.real = (Agent._choose_sync_peers, Agent.parallel_sync)
        self.pinned = {}

    def pin(self, agent, actor) -> None:
        self.pinned[id(agent)] = actor

    def install(self) -> None:
        (real_choose, real_parallel), pinned = self.real, self.pinned

        def choose(agent, ours):
            if id(agent) not in pinned:
                return real_choose(agent, ours)
            want = pinned[id(agent)]
            return [m for m in agent.members.alive() if m.actor_id == want]

        async def parallel(agent, members, ours=None, _retry=True):
            return await real_parallel(
                agent, members, ours,
                _retry=_retry and id(agent) not in pinned)

        self.cls._choose_sync_peers, self.cls.parallel_sync = choose, parallel

    def remove(self) -> None:
        self.cls._choose_sync_peers, self.cls.parallel_sync = self.real


class ApplyWalls:
    """Records, while installed, the host-clock wall of each apply of
    more than ``TORCH_AUTO_MIN`` changes (a large version's), by the
    applying node's database path."""

    def __init__(self):
        from corrosion_tpu_torch.agent.storage import CrConn
        from corrosion_tpu_torch.ops.merge import TORCH_AUTO_MIN

        self.cls, self.real = CrConn, CrConn.apply_changes_in_tx
        self.min, self.walls = TORCH_AUTO_MIN, []

    def install(self) -> None:
        real, walls, least = self.real, self.walls, self.min

        def timed_apply(conn, changes):
            t0 = time.perf_counter()
            out = real(conn, changes)
            n = len(changes) if hasattr(changes, "__len__") else -1
            if n > least:
                walls.append((conn.path, n, time.perf_counter() - t0))
            return out

        self.cls.apply_changes_in_tx = timed_apply

    def remove(self) -> None:
        self.cls.apply_changes_in_tx = self.real

    def named(self, paths: dict) -> list:
        """The walls, each under its node's name in ``paths``."""
        return [dict(node=paths.get(p, p), changes=n, wall_s=w)
                for p, n, w in self.walls]


async def live_cluster(counted, dev, tmp: str, old) -> dict:
    """Phase 23b: four of the port's agents on loopback at the
    reference's defaults (HTTP API, subscriptions, foca SWIM, the
    multiplexed transport), on ``dev``; B and the two catch-up nodes
    (C of each arm, in ``c_a`` and ``c_b``) hold ``old`` (``preseed``)
    when they start."""
    import asyncio
    import types

    from corrosion_tpu_torch.agent.runtime import AgentConfig, ChangeSource
    from corrosion_tpu_torch.agent.testing import launch_test_agent
    from corrosion_tpu_torch.ops.merge import TORCH_AUTO_MIN
    from corrosion_tpu_torch.types.change import ChunkedChanges

    until = waiter("23b")
    out = {}
    agents, streams = {}, {}
    spy, wires, pins, walls = ApplySpy(), WireCount(), SyncPins(), ApplyWalls()
    # A and B pull nothing by sync (their clients wait a minute): A's
    # version reaches B by broadcast alone, and A takes the older
    # version only when it is handed it, after its write
    slow_sync = dict(sync_interval_min=60.0, sync_interval_max=60.0)
    # the catch-up nodes sync on the reference's default timers: on the
    # test helper's (0.15-0.4 s) a round asks again for the chunks the
    # round before delivered and the node has not applied yet
    default_sync = dict(sync_interval_min=AgentConfig.sync_interval_min,
                        sync_interval_max=AgentConfig.sync_interval_max)
    walls.install()
    pins.install()
    spy.install()
    wires.install()
    try:
        a = agents["a"] = await launch_test_agent(
            tmpdir=os.path.join(tmp, "a"), device=str(dev),
            device_cache=True, **slow_sync)
        boot = [f"{a.gossip_addr[0]}:{a.gossip_addr[1]}"]
        b = agents["b"] = await launch_test_agent(
            bootstrap=boot, tmpdir=os.path.join(tmp, "b"), device=str(dev),
            device_cache=True, **slow_sync)
        for arm in AGENT_ARMS:
            c = agents["c_" + arm] = await launch_test_agent(
                bootstrap=boot, tmpdir=os.path.join(tmp, "c_" + arm),
                device=str(dev), device_cache=True, **default_sync)
            pins.pin(c, None)
        await until(lambda: all(len(x.members.alive()) == len(agents) - 1
                                for x in agents.values()), "the nodes meet")
        # the catch-up nodes take A's version by sync alone: A and B
        # drop their broadcasts to them until both arms have run
        c_addrs = {tuple(agents["c_" + arm].gossip_addr)
                   for arm in AGENT_ARMS}
        drop = types.SimpleNamespace(drop=True, delay=0.0)
        for x in (a, b):
            x.transport.fault_filter = (
                lambda ch, addr: drop if ch == "uni"
                and tuple(addr) in c_addrs else None)
        for arm in AGENT_ARMS:
            streams[arm] = await asyncio.to_thread(
                SubStream, agents["c_" + arm], AGENT_SUB_SQL)
            await until(lambda: streams[arm].last_change_id is not None,
                        f"C_{arm}'s subscription snapshot")
        zero(counted)
        t0 = time.perf_counter()
        res = await asyncio.to_thread(a.execute_transaction, [
            ("INSERT INTO tests (id, text) VALUES (?, ?)", (i, f"row-{i}"))
            for i in range(AGENT_ROWS)])
        out["write_s"] = time.perf_counter() - t0
        v = res["version"]
        dbv = a.bookie.for_actor(a.actor_id).versions[v][0]
        changes = await asyncio.to_thread(a.storage.collect_changes,
                                          (dbv, dbv))
        out["version_changes"] = len(changes)
        out["version_digest"] = version_digest(changes)
        if len(changes) <= TORCH_AUTO_MIN:
            fail(f"phase 23b: the version holds {len(changes)} changes, "
                 f"not more than {TORCH_AUTO_MIN}")
        # the broadcast's chunks of MAX_CHANGES_BYTE_SIZE
        out["chunks"] = sum(1 for _ in ChunkedChanges(
            changes, 0, len(changes) - 1))
        await until(lambda: has(b, a.actor_id, v), "B applies the version")
        out["b_received_s"] = time.perf_counter() - t0
        out["b_serves"] = await asyncio.to_thread(served, b, a.actor_id)
        if out["b_serves"] <= TORCH_AUTO_MIN:
            fail(f"phase 23b: B holds {out['b_serves']} of A's changes, not "
                 f"more than {TORCH_AUTO_MIN}: C's sync from B would not "
                 "reach the winner kernels")
        out["b_launches"] = read_launches(counted, AGENT_COUNTED)
        out["arms"] = {}
        want_n = {"a": out["version_changes"], "b": out["b_serves"]}
        for arm in AGENT_ARMS:
            c, server = agents["c_" + arm], agents[arm]
            other = agents["b" if arm == "a" else "a"]
            if has(c, a.actor_id, v):
                fail(f"phase 23b: C_{arm} holds A's version before its sync")
            served_before = (counter(server, "corro_sync_needs_served_total"),
                             counter(other, "corro_sync_needs_served_total"))
            zero(counted)
            t0 = time.perf_counter()
            pins.pin(c, server.actor_id)
            await until(lambda: has(c, a.actor_id, v),
                        f"C_{arm} catches up by sync from {arm.upper()}")
            arm_out = dict(
                caught_up_s=time.perf_counter() - t0,
                launches=read_launches(counted, AGENT_COUNTED),
                sync_changes=counter(c, "corro_sync_changes_received_total"),
                partial_retries=counter(
                    c, "corro_sync_partial_retries_total"),
                partial_sessions=counter(
                    c, "corro_sync_partial_sessions_total"),
                server_aborts=counter(
                    server, "corro_sync_slow_peer_aborts_total"),
                served_by_arm=counter(
                    server, "corro_sync_needs_served_total")
                - served_before[0],
                served_by_other=counter(
                    other, "corro_sync_needs_served_total")
                - served_before[1])
            out["arms"][arm] = arm_out
            if (arm_out["sync_changes"] < want_n[arm]
                    or arm_out["served_by_arm"] <= 0
                    or arm_out["served_by_other"] != 0
                    or arm_out["partial_retries"] != 0):
                fail(f"phase 23b: C_{arm} was not served A's version by "
                     f"{arm.upper()} alone: {arm_out}, want "
                     f"{want_n[arm]} changes")
            # no more syncs of this C while the other arm runs
            pins.pin(c, None)
        for x in (a, b):
            x.transport.fault_filter = None
        for arm in AGENT_ARMS:
            pins.pin(agents["c_" + arm], agents[arm].actor_id)
        zero(counted)
        a.enqueue_change(old, ChangeSource.SYNC)
        await until(lambda: has(a, AGENT_OLD_SITE, 1),
                    "A applies the older version")
        # B updates a subset of the rows twice: A's and the Cs' caches
        # hold them for the second
        takers = [x for name, x in agents.items() if name != "b"]
        for k in range(2):
            r = await asyncio.to_thread(b.execute_transaction, [(
                "UPDATE tests SET text = ? WHERE id < ?",
                (f"b-{k}", AGENT_UPDATE_ROWS))])
            bv = r["version"]
            await until(lambda: all(has(x, b.actor_id, bv) for x in takers),
                        f"A and the Cs apply B's update {k}")
        out["update_launches"] = read_launches(counted, AGENT_COUNTED)
        # each subscription's stream reaches its node's last change
        for arm in AGENT_ARMS:
            c, st = agents["c_" + arm], streams[arm]
            handle = c.subs.get(st.id)
            if handle is None:
                fail(f"phase 23b: C_{arm} lost subscription {st.id}")
            await until(lambda: c.subs.idle()
                        and st.last_change_id == handle.last_change_id,
                        f"C_{arm}'s subscription stream")
        out["subscriptions"] = {arm: dict(
            events=st.events, rows=len(st.rows), resumes=st.resumes,
            dropped=counter(agents["c_" + arm],
                            "corro_subs_events_dropped_total"),
            last_change_id=st.last_change_id, error=st.error,
            equal=sorted(st.rows.values()) == final_rows())
            for arm, st in streams.items()}
        states = [await asyncio.to_thread(clock_state, x)
                  for x in agents.values()]
        out["cache_counters"] = {name: dict(x.storage.device_cache.counters)
                                 for name, x in agents.items()}
        out["hits"] = {name: c["hits"]
                       for name, c in out["cache_counters"].items()}
        out["caches_on_device"] = {name: cache_on(x, dev)
                                   for name, x in agents.items()}
        out["wire"] = dict(
            swim=dict(wires.counts),
            mux={name: x.transport.mux for name, x in agents.items()},
            uni_frames={name: counter(x, "corro_transport_frames_total",
                                      channel="uni")
                        for name, x in agents.items()},
            bi_channels={name: counter(x, "corro_transport_bi_channels_total")
                         for name, x in agents.items()},
            bi_bytes={name: counter(x, "corro_transport_bytes_total",
                                    channel="bi")
                      for name, x in agents.items()})
        paths = {x.storage.path: name for name, x in agents.items()}
        out["apply_walls"] = walls.named(paths)
        out["rows"] = len(states[0]["rows"])
    finally:
        wires.remove()
        spy.remove()
        pins.remove()
        walls.remove()
        for st in streams.values():
            st.close()
        for x in reversed(list(agents.values())):
            await x.stop()
    out["checked"] = spy.check(dev)
    print("phase 23b: " + json.dumps(out), flush=True)
    if any(st != states[0] for st in states):
        fail("phase 23b: the four nodes' rows or clock state differ")
    if states[0]["rows"] != final_rows():
        fail("phase 23b: the rows are not A's insert, the older version "
             "where it wins and B's update")
    for arm, sub in out["subscriptions"].items():
        if not sub["equal"] or sub["error"] is not None:
            fail(f"phase 23b: C_{arm}'s subscription over HTTP does not "
                 f"hold the final rows: {sub}")
    if not all(out["caches_on_device"].values()):
        fail(f"phase 23b: caches off {dev}: {out['caches_on_device']}")
    if sorted(w["node"] for w in out["apply_walls"]) != ["b", "c_a", "c_b"]:
        fail(f"phase 23b: the large version's applies: {out['apply_walls']}")
    if any(out["hits"][name] <= 0 for name in ("a", "c_a", "c_b")):
        fail(f"phase 23b: the caches took no hits: {out['hits']}")
    wire = out["wire"]
    if wire["swim"]["foca"] <= 0 or wire["swim"]["json"] != 0:
        fail(f"phase 23b: SWIM did not go over foca alone: {wire['swim']}")
    if (not all(wire["mux"].values())
            or min(wire["uni_frames"][n] for n in ("a", "b")) <= 0
            or min(wire["bi_channels"]["c_" + arm] for arm in AGENT_ARMS) <= 0
            or min(wire["bi_bytes"][arm] for arm in AGENT_ARMS) <= 0):
        fail(f"phase 23b: broadcast and sync did not go over the mux: {wire}")
    checked = out["checked"]
    if sum(n > TORCH_AUTO_MIN for n in checked["winners"]) != 3:
        fail(f"phase 23b: the large applies' winners: {checked['winners']}")
    for k in ("store_set", "store_gather"):
        if max(checked[k], default=0) < AGENT_UPDATE_ROWS:
            fail(f"phase 23b: no {k} of the updates' rows: {checked[k]}")
    if dev.type == "cuda":
        runs = {"b_launches": out["b_launches"],
                **{f"arm {arm}": out["arms"][arm]["launches"]
                   for arm in AGENT_ARMS}}
        for k, launches in runs.items():
            idle = [n for n in WINNER_KERNELS if launches[n] == 0]
            if idle:
                fail(f"phase 23b: {k}: kernels never launched: {idle}")
        idle = [n for n, c in agent_launches(out).items() if c == 0]
        if idle:
            fail(f"phase 23b: kernels never launched: {idle}")
    return out


def version_digest(changes) -> str:
    """A digest of a version's changes as a node serves them: each
    change's table, pk, column, value, col_version, seq and causal
    length, in order (not its db_version or site: local to the writer)."""
    import hashlib

    h = hashlib.sha256()
    for c in changes:
        h.update(repr((c.table, bytes(c.pk), c.cid, c.val, c.col_version,
                       int(c.seq), c.cl)).encode())
    return h.hexdigest()


# the one recursive statement that writes 23b's version over the PG wire
AGENT_PG_INSERT = (
    "WITH RECURSIVE r(i) AS (SELECT 0 UNION ALL SELECT i + 1 FROM r "
    "WHERE i < {last}) INSERT INTO tests (id, text) "
    "SELECT i, 'row-' || i FROM r")
AGENT_ADMIN = ("health", "cluster_members", "actor_version",
               "sync_sessions", "db_info")


def admin_answers(path: str, actor: bytes) -> dict:
    """The admin socket at ``path``: each of ``AGENT_ADMIN``'s replies
    (``actor_version`` for ``actor``)."""
    from corrosion_tpu_torch.agent.admin import AdminClient

    c = AdminClient(path, timeout=AGENT_WAIT_S)
    try:
        return {cmd: c.call(cmd, **({"actor": actor.hex()}
                                    if cmd == "actor_version" else {}))
                for cmd in AGENT_ADMIN}
    except RuntimeError as e:
        fail(f"phase 23c: the admin socket {path}: {e}")
    finally:
        c.close()


async def surfaces_cluster(counted, dev, tmp: str, old,
                           want_digest: str) -> dict:
    """Phase 23c: three of the port's agents on loopback on ``dev`` with
    every surface of the reference on: each an admin socket and a
    signing key, one shared directory of their public keys, A the
    PostgreSQL wire.  B and C hold ``old`` when they start.  A writes
    23b's version over the PG wire in one transaction; B takes it by
    broadcast, C by sync from A alone; A takes ``old`` and B updates
    ``AGENT_UPDATE_ROWS`` rows twice; A's PG session reads the table
    back; every admin socket answers; a small signed write from A is
    verified on B and C."""
    import asyncio
    import types

    from corrosion_tpu_torch.agent.runtime import AgentConfig, ChangeSource
    from corrosion_tpu_torch.agent.testing import launch_test_agent
    from corrosion_tpu_torch.ops.merge import TORCH_AUTO_MIN
    from corrosion_tpu_torch.types import crypto
    from tests.pgwire_client import PgClient

    until = waiter("23c")
    out, agents, directory, pg = {}, {}, {}, None
    keys = {name: crypto.seed_keypair(b"smoke-23c-" + name.encode())
            for name in "abc"}
    spy, pins, walls = ApplySpy(), SyncPins(), ApplyWalls()
    # A and B pull nothing by sync; C syncs on the reference's timers
    slow_sync = dict(sync_interval_min=60.0, sync_interval_max=60.0)
    default_sync = dict(sync_interval_min=AgentConfig.sync_interval_min,
                        sync_interval_max=AgentConfig.sync_interval_max)

    def boot(name, **kw):
        return launch_test_agent(
            tmpdir=os.path.join(tmp, name), device=str(dev),
            device_cache=True,
            # relative: a socket's path has room for 107 bytes
            admin_path=os.path.relpath(os.path.join(tmp, name + ".sock")),
            sig_secret=keys[name][0], sig_pubkeys=directory, **kw)

    walls.install()
    pins.install()
    spy.install()
    try:
        a = agents["a"] = await boot("a", pg_port=0, **slow_sync)
        seed = [f"{a.gossip_addr[0]}:{a.gossip_addr[1]}"]
        b = agents["b"] = await boot("b", bootstrap=seed, **slow_sync)
        c = agents["c"] = await boot("c", bootstrap=seed, **default_sync)
        pins.pin(c, None)
        for name, x in agents.items():
            directory[x.actor_id] = keys[name][1]
        await until(lambda: all(len(x.members.alive()) == 2
                                for x in agents.values()), "the nodes meet")
        # C takes A's version by sync alone
        drop = types.SimpleNamespace(drop=True, delay=0.0)
        for x in (a, b):
            x.transport.fault_filter = (
                lambda ch, addr: drop if ch == "uni"
                and tuple(addr) == tuple(c.gossip_addr) else None)
        pg = await asyncio.to_thread(PgClient, *a.pg_addr,
                                     timeout=AGENT_WAIT_S)
        zero(counted)
        t0 = time.perf_counter()
        for sql in ("BEGIN", AGENT_PG_INSERT.format(last=AGENT_ROWS - 1),
                    "COMMIT"):
            _, _, _, errors = await asyncio.to_thread(pg.query, sql)
            if errors:
                fail(f"phase 23c: {sql[:40]}... over PG: {errors}")
        out["pg_write_s"] = time.perf_counter() - t0
        v = a.bookie.for_actor(a.actor_id).last()
        dbv = a.bookie.for_actor(a.actor_id).versions[v][0]
        changes = await asyncio.to_thread(a.storage.collect_changes,
                                          (dbv, dbv))
        out["version_changes"] = len(changes)
        out["same_version_as_23b"] = version_digest(changes) == want_digest
        await until(lambda: has(b, a.actor_id, v), "B applies the version")
        out["b_received_s"] = time.perf_counter() - t0
        out["b_launches"] = read_launches(counted, AGENT_COUNTED)
        zero(counted)
        t0 = time.perf_counter()
        pins.pin(c, a.actor_id)
        await until(lambda: has(c, a.actor_id, v),
                    "C catches up by sync from A")
        out["c_sync_s"] = time.perf_counter() - t0
        out["c_launches"] = read_launches(counted, AGENT_COUNTED)
        out["c_sync_changes"] = counter(c, "corro_sync_changes_received_total")
        for x in (a, b):
            x.transport.fault_filter = None
        zero(counted)
        a.enqueue_change(old, ChangeSource.SYNC)
        await until(lambda: has(a, AGENT_OLD_SITE, 1),
                    "A applies the older version")
        for k in range(2):
            r = await asyncio.to_thread(b.execute_transaction, [(
                "UPDATE tests SET text = ? WHERE id < ?",
                (f"b-{k}", AGENT_UPDATE_ROWS))])
            bv = r["version"]
            await until(lambda: has(a, b.actor_id, bv)
                        and has(c, b.actor_id, bv),
                        f"A and C apply B's update {k}")
        out["update_launches"] = read_launches(counted, AGENT_COUNTED)
        t0 = time.perf_counter()
        _, rows, _, errors = await asyncio.to_thread(
            pg.query, "SELECT id, text FROM tests ORDER BY id")
        out["pg_read_s"] = time.perf_counter() - t0
        out["pg_rows"] = len(rows)
        out["pg_rows_equal"] = (not errors and [(int(i), t) for i, t in rows]
                                == final_rows())
        states = [await asyncio.to_thread(clock_state, x)
                  for x in agents.values()]
        out["admin"] = {name: await asyncio.to_thread(
            admin_answers, x.config.admin_path, a.actor_id)
            for name, x in agents.items()}
        # the signed write: B and C spot-check every signed version
        for x in (b, c):
            x.config.sig_spot_check_rate = 1.0
        pins.pin(c, None)
        ok_before = {n: counter(agents[n], "corro_sig_verifications_total",
                                result="ok") for n in ("b", "c")}
        _, _, _, errors = await asyncio.to_thread(
            pg.query, "INSERT INTO tests2 (id, text) VALUES (1, 'signed')")
        if errors:
            fail(f"phase 23c: the signed write over PG: {errors}")
        sv = a.bookie.for_actor(a.actor_id).last()
        await until(lambda: all(
            counter(agents[n], "corro_sig_verifications_total", result="ok")
            > ok_before[n] for n in ("b", "c")),
            "B and C verify A's signed write")
        out["signatures"] = {n: {r: counter(
            agents[n], "corro_sig_verifications_total", result=r)
            for r in ("ok", "fail", "skipped")} for n in ("b", "c")}
        out["signed_version_on"] = {n: has(agents[n], a.actor_id, sv)
                                    for n in ("b", "c")}
        paths = {x.storage.path: name for name, x in agents.items()}
        out["apply_walls"] = walls.named(paths)
        out["caches_on_device"] = {name: cache_on(x, dev)
                                   for name, x in agents.items()}
    finally:
        if pg is not None:
            pg.close()
        spy.remove()
        pins.remove()
        walls.remove()
        for x in reversed(list(agents.values())):
            await x.stop()
    out["checked"] = spy.check(dev)
    admin = out["admin"]
    members = {name: sum(m["state"] == "alive" for m in r["cluster_members"])
               + 1 for name, r in admin.items()}
    versions = [r["actor_version"] for r in admin.values()]
    print("phase 23c: " + json.dumps(dict(out, admin={
        name: dict(alive=members[name], actor_version=r["actor_version"],
                   db_info=r["db_info"], sync_sessions=len(r["sync_sessions"]),
                   health=sorted(r["health"]))
        for name, r in admin.items()})), flush=True)
    if out["version_changes"] <= TORCH_AUTO_MIN or not out[
            "same_version_as_23b"]:
        fail("phase 23c: the version written over PG is not 23b's "
             f"({out['version_changes']} changes)")
    if out["c_sync_changes"] < out["version_changes"]:
        fail(f"phase 23c: C was not served A's version by sync: "
             f"{out['c_sync_changes']} changes")
    if any(st != states[0] for st in states) or states[0]["rows"] != (
            final_rows()):
        fail("phase 23c: the three nodes' rows or clock state differ, or "
             "are not the rows the merge gives")
    if not out["pg_rows_equal"]:
        fail(f"phase 23c: A's PG session read {out['pg_rows']} rows, not "
             "the final rows")
    if set(members.values()) != {3} or any(v != versions[0]
                                           for v in versions):
        fail(f"phase 23c: the admin sockets: members {members}, "
             f"versions {versions}")
    for n, sig in out["signatures"].items():
        if sig["ok"] < 1 or sig["fail"] != 0 or not out["signed_version_on"][n]:
            fail(f"phase 23c: {n.upper()} verified no signature: {sig}")
    if not all(out["caches_on_device"].values()):
        fail(f"phase 23c: caches off {dev}: {out['caches_on_device']}")
    if sorted(w["node"] for w in out["apply_walls"]) != ["b", "c"]:
        fail(f"phase 23c: the large version's applies: {out['apply_walls']}")
    if sum(n > TORCH_AUTO_MIN for n in out["checked"]["winners"]) != 2:
        fail(f"phase 23c: the large applies' winners: "
             f"{out['checked']['winners']}")
    if dev.type == "cuda":
        for k in ("b_launches", "c_launches"):
            idle = [n for n in WINNER_KERNELS if out[k][n] == 0]
            if idle:
                fail(f"phase 23c: {k}: kernels never launched: {idle}")
    return out


def agent_launches(live: dict) -> dict:
    """Each counted kernel's launches over 23b's runs: B's broadcast
    apply, both catch-up arms and the updates."""
    return {n: live["b_launches"][n] + live["update_launches"][n]
            + sum(arm["launches"][n] for arm in live["arms"].values())
            for n in AGENT_COUNTED}


def surface_launches(surf: dict) -> dict:
    """Each counted kernel's launches over 23c's runs: B's broadcast
    apply, C's sync apply and the updates."""
    return {n: sum(surf[k][n] for k in ("b_launches", "c_launches",
                                         "update_launches"))
            for n in AGENT_COUNTED}


def native_check() -> dict:
    """Phase 23's first check: the port's native host module built from
    this checkout and loaded, the agent's codec (``agent/pack.py``) and
    speedy's change-array loops and deframer its functions, each equal to
    its Python twin on a sample."""
    from corrosion_tpu_torch import native
    from corrosion_tpu_torch.agent import pack
    from corrosion_tpu_torch.bridge import speedy

    t0 = time.perf_counter()
    mod = native.load()
    if mod is None:
        fail("phase 23: the port's native host module did not build or load")
    wired = {
        "pack_values": pack.pack_values is mod.pack_values,
        "unpack_values": pack.unpack_values is mod.unpack_values,
        "value_cmp": pack.value_cmp is mod.value_cmp,
        "speedy_changes": speedy._native is mod,
        "deframe": speedy._native_mod is mod
        and speedy.deframe is not speedy._py_deframe,
    }
    vals = [None, 7, -2**62, 0.5, "row-1", b"\x00\xff", True]
    blob = pack._py_pack_values(vals)
    frames = b"".join(speedy.frame(bytes([i]) * i) for i in range(9))
    agree = (pack.pack_values(vals) == blob
             and pack.unpack_values(blob) == pack._py_unpack_values(blob)
             and speedy.deframe(frames[:-3]) == speedy._py_deframe(
                 frames[:-3]))
    out = dict(module=os.path.relpath(mod.__file__, HERE), wired=wired,
               agree=agree, load_s=time.perf_counter() - t0)
    print("phase 23 native: " + json.dumps(out), flush=True)
    if not all(wired.values()) or not agree:
        fail(f"phase 23: the agent's host codec is not the native "
             f"module's: {out}")
    return out


def agent_phase(record: dict, counted: dict, dev) -> dict:
    """Phase 23: the port's live agent on ``dev``; returns the launches
    of its kernels over the phase's runs."""
    import asyncio

    from corrosion_tpu_torch import kernels

    t0 = time.perf_counter()
    record["agent_native"] = native_check()
    runs = [bitmatch_run(counted, r, dev) for r in BITMATCH_RECORDS]
    det_placement(dev)
    record["agent_bitmatch"] = runs
    old = old_version()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="agents-",
                                     dir=kernels.BUILD_DIR) as tmp:
        names = ["a", "b"] + ["c_" + arm for arm in AGENT_ARMS]
        for name in names:
            os.mkdir(os.path.join(tmp, name))
        for name in names[1:]:
            preseed(os.path.join(tmp, name), old, dev)
        live = asyncio.run(live_cluster(counted, dev, tmp, old))
    live["s"] = time.perf_counter() - t1
    record["agent_cluster"] = live
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="surfaces-",
                                     dir=kernels.BUILD_DIR) as tmp:
        for name in "abc":
            os.mkdir(os.path.join(tmp, name))
        for name in "bc":
            preseed(os.path.join(tmp, name), old, dev)
        surf = asyncio.run(surfaces_cluster(counted, dev, tmp, old,
                                            live["version_digest"]))
    surf["s"] = time.perf_counter() - t1
    record["agent_surfaces"] = surf
    cluster, surfaces = agent_launches(live), surface_launches(surf)
    launches = {n: sum(r["launches"].get(n, 0) for r in runs) + cluster[n]
                + surfaces[n] for n in AGENT_COUNTED}
    print(json.dumps({"agent": {
        "bitmatch": {r["record"]: {k: r.get(k) for k in (
            "wall_s", "launches", "peak_mem_bytes", "agents_mem_bytes")}
            for r in runs},
        "cluster": {k: live[k] for k in (
            "s", "write_s", "version_changes", "chunks", "b_received_s",
            "b_serves", "arms", "apply_walls", "subscriptions", "wire",
            "cache_counters", "b_launches", "update_launches", "checked")},
        "surfaces": {k: surf[k] for k in (
            "s", "pg_write_s", "version_changes", "b_received_s", "c_sync_s",
            "c_sync_changes", "pg_read_s", "apply_walls", "signatures",
            "b_launches", "c_launches", "update_launches")},
        "launches": launches,
        "s": time.perf_counter() - t0}}), flush=True)
    return launches


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit: "
                    "hold its threefry_bits, deliver_perm, "
                    "swim_probe_select, exact_send<Bitmap>, "
                    "exact_commit, sent_select, "
                    "sent_commit, bits_pack, bits_unpack, route_pack, "
                    "ring_receive, shard and winner kernels to this tree's "
                    "and time them beside them")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.kernels import deliver, exact_send, seq_sync
    from corrosion_tpu_torch.kernels import seg_sort, sent_sampler, swim
    from corrosion_tpu_torch.kernels import sync_pull, threefry, tick_stats
    from corrosion_tpu_torch.kernels import fabric, shard_exact, store, winners
    from corrosion_tpu_torch.kernels import sass
    from corrosion_tpu_torch.sim.epidemic import (
        HEADLINE,
        HEADLINE_SEEDS,
        run_epidemic_seeds,
    )

    mods = (threefry, deliver, sync_pull, tick_stats)
    counted = {fn.__name__: fn for fn in (
        threefry.threefry_bits, deliver.deliver_perm, sync_pull.sync_pull,
        tick_stats.tick_stats, exact_send.exact_send,
        exact_send.exact_commit, seq_sync.seq_sync, seq_sync.seq_stats,
        swim.swim_probe_select, swim.swim_disseminate, swim.swim_settle,
        sent_sampler.sent_select,
        sent_sampler.sent_commit, seg_sort.seg_argsort, winners.seg_cummax,
        winners.winners_a, winners.winners_b, store.store_set,
        store.store_gather, fabric.bits_pack, fabric.bits_pack_above,
        fabric.bits_pack_active, fabric.bits_unpack, fabric.bits_unpack_add,
        fabric.route_pack, fabric.ring_receive, shard_exact.shard_round,
        shard_exact.shard_commit)}
    headline_counted = ("threefry_bits", "seg_argsort", "deliver_perm",
                        "sync_pull", "tick_stats")
    record = {}
    cuda = torch.device("cuda")

    # phase 1: the card, then the build
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    logs = kernels.build()
    record["build_s"] = time.perf_counter() - t0
    record["ptxas"] = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for name, log in logs.items()
    }
    print(f"built {sorted(logs)} in {record['build_s']:.1f} s", flush=True)
    parent = ParentDesign(opts.parent) if opts.parent else None
    if parent is not None:
        record["parent_ptxas"] = parent.ptxas
    # what ptxas made of the hashing kernels: opcodes by pipe, and each
    # loop's (kernels/sass.py; the listings land beside the libraries)
    record["sass"] = {
        name: sass.mix(kernels.library_path(name), pattern)
        for name, pattern in (("threefry", ""),
                              ("sent_sampler", "sent_select"),
                              ("store", "store_(claim|write)"),
                              ("swim", "swim_probe_select"),
                              ("winners", "winners_[ab]_kernel|seg_cummax"))}
    record["threefry_pipes"] = threefry_pipes(record["sass"]["threefry"],
                                              threefry.WORDS_A_THREAD)
    sass_line = {"threefry_pipes": record["threefry_pipes"]}
    if parent is not None:
        # sent_select's opcodes beside the parent's (the hash it shares
        # with threefry now lives in common.cuh)
        theirs = sass.mix(parent.paths["sent_sampler"], "sent_select")
        record["parent_sass"] = {"sent_sampler": theirs}
        # keyed from "sent_select" on: the anonymous namespace's id
        # differs between the two builds
        ops = [{n[n.index("sent_select"):]: f["ops"] for n, f in m.items()}
               for m in (record["sass"]["sent_sampler"], theirs)]
        sass_line["sent_select_ops_equal_parent"] = {
            n: o == ops[1].get(n) for n, o in ops[0].items()}
        # and loop by loop (innermost first; the filter loop among them):
        # whatever changed in sent_select stays outside its loops
        loops = [{n[n.index("sent_select"):]: [lp["ops"] for lp in f["loops"]]
                  for n, f in m.items()}
                 for m in (record["sass"]["sent_sampler"], theirs)]
        sass_line["sent_select_loops_equal_parent"] = {
            n: [a == b for a, b in zip(mine, loops[1].get(n, []))]
            + [False] * abs(len(mine) - len(loops[1].get(n, [])))
            for n, mine in loops[0].items()}
        # the parent's seg_cummax kernels, beside this tree's
        theirs = sass.mix(parent.paths["winners"], "seg_cummax")
        record["parent_sass"]["winners"] = theirs
        sass_line["seg_cummax_sass_parent"] = cummax_sass(theirs)
    sass_line["seg_cummax_sass"] = cummax_sass(record["sass"]["winners"])
    sass_line["winners_pipes"] = {
        m.group(0): {"n": f["n"], "pipes": f["pipes"]}
        for n, f in record["sass"]["winners"].items()
        if (m := re.search("winners_[ab]_kernel", n))}
    print(json.dumps(sass_line), flush=True)

    headline, seeds = HEADLINE, HEADLINE_SEEDS

    # phase 2: the perm-fanout kernels against their plain versions
    results = kernel_checks(replace(headline, n_universes=seeds), mods,
                            cuda, parent)
    print("kernels match their plain versions: "
          + ", ".join(f"{r['name']} {r['max_abs_err']}" for r in results),
          flush=True)
    print(json.dumps({"deliver_perm": next(
        r["turns"] for r in results if r["name"] == "deliver_perm")}),
        flush=True)

    # phase 3: the headline on the card, counters from this run only
    run_epidemic_seeds(replace(headline, n_nodes=1000, max_ticks=16),
                       n_seeds=2, device="cuda")  # warm the allocator
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = run_epidemic_seeds(headline, n_seeds=seeds, seed=0,
                               device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: counted[name].launches for name in headline_counted}
    stats["device"] = torch.cuda.get_device_name(0)
    stats["card"] = card
    stats["run_s"] = wall
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for r in results:
        r["launches"] = launches[r["name"]]
    record.update(card=card, headline=stats)
    got = {k: round(stats[k], 2) for k in HEADLINE_WANT}
    if got != HEADLINE_WANT:
        fail(f"headline moved: {got}, want {HEADLINE_WANT}")
    idle = [name for name, c in launches.items() if c == 0]
    if idle:
        fail(f"kernels never launched on the main path: {idle}")

    # phase 4: kernels on the card == plain versions on the CPU
    record["small"] = run_equal(replace(headline, n_nodes=4096), 4, cuda,
                                "4096-node run")
    for name, kw in VARIANTS.items():
        record[f"variant_{name}"] = run_equal(
            replace(headline, **{"n_nodes": 1024, "max_ticks": 64, **kw}),
            3, cuda, f"variant {name}")
    ticks = record["small"]["ticks_compared"]
    print(f"card == CPU per tick: 4096 x 4 headline ({ticks} ticks) and "
          f"{len(VARIANTS)} variants", flush=True)

    # phase 5: the exact sampler's kernels against their plain versions
    exact_results, record["exact_checks"], record["exact_busiest"] = (
        exact_kernel_checks(cuda, parent))
    print("exact kernels match their plain versions: "
          + ", ".join(f"{r['name']} {r['max_abs_err']}"
                      for r in exact_results), flush=True)

    # phase 6: the exact column at full width, dense against sparse
    runs = exact_full_width(counted)
    record["exact_runs"] = runs
    dense, sparse = (runs[k]["launches"] for k in ("dense_100k",
                                                   "sparse_1m"))
    for r, n in zip(exact_results, (dense["exact_send"],
                                    sparse["exact_send"],
                                    dense["exact_commit"]
                                    + sparse["exact_commit"])):
        r["launches"] = n
    print("exact dense == sparse per seed at 100k x 16", flush=True)

    # phase 7: the exact kernels on the card == plain versions on the CPU
    from corrosion_tpu_torch.sim.calibrate import HeadlineExactConfig

    for name, kw in EXACT_VARIANTS.items():
        cfg = HeadlineExactConfig(**{
            "n_nodes": 1024, "fanout": 4, "ring0_size": 64,
            "max_transmissions": 8, "loss": 0.05, "partition_blocks": 2,
            "heal_tick": 3, "sync_interval": 2, "backoff_ticks": 0.5,
            "max_ticks": 48, "chunk_ticks": 8, **kw})
        for sp in (False, True):
            label = f"exact {name} {'sparse' if sp else 'dense'}"
            record[label] = exact_equal(cfg, 2, sp, cuda, label)
    print(f"exact card == CPU per tick: 1024 x 2, {len(EXACT_VARIANTS)} "
          "variants, both kernels", flush=True)

    # phase 8: the anti-entropy and SWIM kernels against their plain
    # versions
    ae_results = seq_sync_checks(cuda)
    swim_results, record["swim_checks"], record["swim_times"] = (
        swim_kernel_checks(cuda, parent))
    print("seq_sync / swim kernels match their plain versions: "
          + ", ".join(f"{r['name']} {r['max_abs_err']}"
                      for r in ae_results + swim_results)
          + f" ({len(record['swim_checks'])} SWIM cases)", flush=True)
    print(json.dumps({"swim": {
        "probe_select_turns": record["swim_times"]["probe_select_turns"],
        "costs": record["swim_times"]["costs"],
        **{r["name"]: {f: r[f] for f in ("ms", "bound_ms", "bound_by",
                                         "library_ms")}
           for r in swim_results}}}), flush=True)

    # phase 9: config #4, config #2 and the 4096-node churn cycle
    paths = full_width_paths(counted)
    record["paths"] = paths
    for r in ae_results:
        r["launches"] = paths["config4"]["launches"][r["name"]]
    for r in swim_results:
        r["launches"] = (paths["config2"]["launches"][r["name"]]
                         + paths["churn4096"]["launches"][r["name"]])

    # phase 10: card == CPU per tick for both paths
    from corrosion_tpu_torch.sim.antientropy import AntiEntropyConfig
    from corrosion_tpu_torch.sim.churn import ChurnConfig

    for label, kw in (("default", {}),
                      ("three_peers_budget_2", dict(peers_per_round=3,
                                                    chunk_budget=2))):
        record[f"ae_equal_{label}"] = ae_equal(
            AntiEntropyConfig(n_nodes=1000, **kw), 4, cuda,
            f"anti-entropy {label}")
    churn_cfg = ChurnConfig(n_nodes=256, cycles=2, cycle_period=128,
                            kill_tick=4, revive_tick=96)
    for label, cfg in (
        ("lossless", churn_cfg),
        ("loss_0.15", replace(churn_cfg, params=replace(churn_cfg.params,
                                                        loss=0.15))),
    ):
        record[f"churn_equal_{label}"] = churn_equal(cfg, cuda,
                                                     f"churn {label}")
    # gossip wider than one selection pass: tests/test_torch_swim.py's
    # wide-gossip case (12 entries, 5 targets, 15% loss, 48 nodes) and
    # 20 entries at 64 nodes
    for label, n, kw in (
            ("wide_gossip_12", 48, dict(gossip_targets=5, gossip_entries=12,
                                        loss=0.15)),
            ("gossip_20", 64, dict(gossip_entries=20, loss=0.15))):
        cfg = ChurnConfig(n_nodes=n, cycles=1, cycle_period=64,
                          kill_tick=4, revive_tick=20)
        cfg = replace(cfg, params=replace(cfg.params, **kw))
        record[f"churn_equal_{label}"] = churn_equal(cfg, cuda,
                                                     f"churn {label}")
    print("anti-entropy and churn card == CPU per tick (gossip 12 and 20 "
          "entries included)", flush=True)

    sent_results = sent_phases(record, counted, cuda, parent)
    winners_results = sort_winners_phases(record, counted, results, cuda,
                                          parent)
    with tempfile.TemporaryDirectory(prefix="apply-",
                                     dir=kernels.BUILD_DIR) as tmp:
        store_results = apply_phases(record, counted, tmp,
                                     results + winners_results)
    mesh_results = mesh_phases(record, counted, runs, cuda, parent)
    results += (exact_results + ae_results + swim_results + sent_results
                + winners_results + store_results + mesh_results)

    # phase 21: the harness twins' predictions through their entry points
    harness = harness_phase(counted)
    record["harness"] = harness
    for r in results:
        r["launches"] += sum(h["launches"].get(r["name"], 0)
                             for h in harness.values())

    # phase 22: the twin of dryrun_multichip on the two-axis mesh
    window_results = multichip_phase(record, counted, cuda)
    for r in results:
        r["launches"] += record["multichip_draws"].get(r["name"], 0)
    results += window_results

    # phase 23: the live agent on the card
    agent_launches = agent_phase(record, counted, cuda)
    for r in results:
        r["launches"] += agent_launches.get(r["name"], 0)
    record["kernels"] = results
    with open(kernels.BUILD_DIR / "chip_smoke.json", "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(json.dumps({"headline": stats}), flush=True)
    print(json.dumps({"exact": {k: {f: v[f] for f in (
        "converged_frac", "ticks_p50", "ticks_p99", "msgs_per_node_mean",
        "msgs_per_node_p99", "seed_batch", "wall_s", "peak_mem_gb")}
        for k, v in runs.items()}}), flush=True)
    print(json.dumps({"paths": {k: {f: v.get(f) for f in (
        "converged_frac", "ticks_p50", "ticks_p99", "msgs_per_node_mean",
        "detect_latency", "rejoin_latency", "msgs_per_node_per_tick",
        "ticks_run", "wall_s", "peak_mem_gb")}
        for k, v in paths.items()}}), flush=True)
    sent_runs = dict(record["sent_runs"])
    calib = sent_runs.pop("calibration")
    print(json.dumps({"sent": {
        "calibration": {f: calib[f] for f in ("points", "run_s",
                                              "launches")},
        **{k: {f: v[f] for f in (
            "converged_frac", "ticks_p50", "ticks_p99",
            "msgs_per_node_mean", "hops_p50", "hops_p99", "wall_s",
            "launches")} for k, v in sent_runs.items()}}}), flush=True)
    print(json.dumps({"winners": {k: {f: v[f] for f in (
        "impacted", "winners", "gen_rows", "call_s", "launches")}
        for k, v in record["winners_runs"].items()}}), flush=True)
    print(json.dumps({"apply": {
        k: v for k, v in record["apply"].items()}}), flush=True)
    print(json.dumps({"mesh": {k: {f: v[f] for f in (
        "kernel", "n_shards", "n_hosts", "converged_frac", "ticks_p50",
        "ticks_p99", "msgs_per_node_mean", "msgs_per_node_p99", "wall_s",
        "peak_mem_gb", "fabric")} for k, v in record["mesh_runs"].items()},
        "fabrics": record["fabric_runs"]}), flush=True)
    print(json.dumps({"harness": {
        label: {"run_s": h["run_s"], "launches": h["launches"]}
        for label, h in harness.items()}}), flush=True)
    line = {"kernels": [
        {key: r[key] for key in (
            "name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        for r in results
    ]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def sent_phases(record: dict, counted: dict, cuda, parent=None) -> list:
    """Phases 11-13, the exact ``sent_to`` sampler; returns the kernels'
    results with the main path's launches (phase 12's runs summed)."""
    # phase 11: sent_select / sent_commit / sent_tick against their plain
    # versions (and the parent's two calls)
    results, record["sent_checks"], record["sent_times"] = (
        sent_kernel_checks(cuda, parent))
    ties = sum(c.get("tied_rows", 0) for c in record["sent_checks"])
    print("sent kernels match their plain versions: "
          + ", ".join(f"{r['name']} {r['max_abs_err']}" for r in results)
          + f"; {ties} active rows with tied scores; sent_tick in "
          f"{len(record['sent_checks'])} cases"
          + (" (the parent's two calls too)" if parent else ""), flush=True)
    times = record["sent_times"]
    print(json.dumps({"sent_tick": {
        k: v for k, v in times.items()
        if k.startswith(("sent_tick/", "enqueue/"))}}), flush=True)

    # phase 12: run_msgs_calibration and the track_sent runs at full
    # width, each held to the reference's numbers
    runs = sent_full_width(counted)
    record["sent_runs"] = runs
    for r in results:
        r["launches"] = sum(v["launches"][r["name"]] for v in runs.values())

    # phase 13: card == CPU per tick, calibration and track_sent
    from corrosion_tpu_torch.sim.calibrate import ExactConfig

    record["calib_equal"] = calib_equal(
        ExactConfig(2000, sender_chunk=512, backoff_ticks=1.5), cuda,
        "exact_tick 2000")
    for label, cfg in sent_variants(256).items():
        record[f"track_sent_equal_{label}"] = track_sent_equal(
            cfg, 4, cuda, f"track_sent {label}")
    print("exact_tick and track_sent card == CPU per tick", flush=True)
    return results



def sort_winners_phases(record: dict, counted: dict, results: list,
                        cuda, parent=None) -> list:
    """Phases 14-15, the segmented sort and the winner selection;
    returns the three winner kernels' results and adds the winners
    runs' launches to ``seg_argsort``'s (in ``results``, phase 2)."""
    from corrosion_tpu_torch.sim.epidemic import HEADLINE, HEADLINE_SEEDS

    # phase 14: the sort at every shape, and a headline tick's sorts
    record["sort_checks"] = sort_checks(cuda)
    record["headline_sorts"] = sort_kernel_names(
        replace(HEADLINE, n_universes=HEADLINE_SEEDS))
    print(f"seg_argsort matches its plain version in "
          f"{len(record['sort_checks'])} cases; a headline tick sorts "
          f"with {record['headline_sorts']}", flush=True)

    # phase 15: the winner selection at full width
    runs, plans = winners_full_width(counted)
    record["winners_runs"] = runs
    checks = winners_kernel_checks(plans, cuda, parent)
    record["winners_sort"] = checks[0]
    replaces = {"seg_cummax": "corrosion_tpu/ops/merge.py:599",
                "winners_a": "corrosion_tpu/ops/merge.py:619",
                "winners_b": "corrosion_tpu/ops/merge.py:658"}
    for r in checks[1:]:
        r.update(route="cuda", source=WINNERS_SOURCE,
                 replaces=replaces[r["name"]],
                 launches=sum(v["launches"][r["name"]]
                              for v in runs.values()))
    sort = next(r for r in results if r["name"] == "seg_argsort")
    sort["launches"] += sum(v["launches"]["seg_argsort"]
                            for v in runs.values())
    print("winner kernels match their plain versions: "
          + ", ".join(f"{r['name']} {r['max_abs_err']}" for r in checks),
          flush=True)
    print(json.dumps({"winners_kernels": {
        "turns": checks[-1]["turns"],
        **{r["name"]: {f: r[f] for f in ("ms", "bound_ms", "plain_ms")}
           for r in checks[1:]}}}), flush=True)
    cummax = checks[1]
    print(json.dumps({"seg_cummax": {
        "device": torch.cuda.get_device_name(0), "turns": cummax["turns"],
        "events_b": cummax["events"], "bound_ms": cummax["bound_by_domain"],
        "edge_cases": len(cummax["edge_cases"])}}), flush=True)
    return checks[1:]


if __name__ == "__main__":
    sys.exit(main())
