"""The port's sequence-chunked anti-entropy (``models.sync`` part B,
``kernels.seq_sync``, ``sim.antientropy``) against
``corrosion_tpu.models.sync`` / ``corrosion_tpu.sim.antientropy``, bit
for bit per tick.

Stats: integers exact, float32 means to rtol 1e-6 — the port sums msgs
exactly and divides once, XLA's mean may round in another order."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import sync as js
from corrosion_tpu.sim import antientropy as ja
from corrosion_tpu_torch.convert import (
    anti_entropy_from_numpy,
    anti_entropy_to_numpy,
    key_from_numpy,
)
from corrosion_tpu_torch.kernels import seq_sync as ks
from corrosion_tpu_torch.models import sync as ts
from corrosion_tpu_torch.sim import antientropy as ta

ROOT = Path(__file__).resolve().parents[1]

# SeqSyncParams variants: loss 0 and 0.15, universes, several peers, a
# small budget, seq counts off the 32-seq word, the kernel's 128 seqs
CASES = {
    "config4-shape": dict(n_nodes=500, n_seqs=64, loss=0.02, universe=100),
    "lossless": dict(n_nodes=300, n_seqs=64),
    "loss-0.15": dict(n_nodes=300, n_seqs=64, loss=0.15),
    "three-peers-budget-2": dict(n_nodes=400, n_seqs=64, peers_per_round=3,
                                 chunk_budget=2, loss=0.15, universe=200),
    "seqs-40-chunk-4": dict(n_nodes=240, n_seqs=40, seqs_per_chunk=4,
                            chunk_budget=3, loss=0.3, universe=80),
    "seqs-128-budget-32": dict(n_nodes=200, n_seqs=128, seqs_per_chunk=3,
                               chunk_budget=32, loss=0.5),
    "handshake-3": dict(n_nodes=150, n_seqs=17, handshake_msgs=3,
                        peers_per_round=2, loss=0.15),
    "two-nodes": dict(n_nodes=2, n_seqs=40, seqs_per_chunk=4,
                      chunk_budget=2),
}


def _state(rng, n, s):
    return (rng.random((n, s)) < 0.4,
            rng.integers(0, 50, n).astype(np.int32))


def _port_step(bits, msgs, key, kw):
    return ts.seq_sync_step(torch.from_numpy(bits.copy()),
                            torch.from_numpy(msgs.copy()),
                            key_from_numpy(key), ts.SeqSyncParams(**kw))


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_seq_sync_step_matches_jax_bitwise_per_tick(case):
    kw = CASES[case]
    rng = np.random.default_rng(len(case))
    bits, msgs = _state(rng, kw["n_nodes"], kw["n_seqs"])
    for t in range(3):
        key = jax.random.PRNGKey(100 * len(case) + t)
        want = js.seq_sync_step(jnp.asarray(bits), jnp.asarray(msgs), key,
                                js.SeqSyncParams(**kw))
        got = _port_step(bits, msgs, key, kw)
        _assert_same(got, want)
        bits, msgs = (np.asarray(w) for w in want)


@pytest.mark.parametrize("leaf", ["bits", "msgs"])
def test_seq_sync_negative_control_one_flipped_bit(leaf):
    """One flipped bit in the port's input state must make the bitwise
    comparison fail."""
    kw = CASES["config4-shape"]
    rng = np.random.default_rng(5)
    bits, msgs = _state(rng, kw["n_nodes"], kw["n_seqs"])
    key = jax.random.PRNGKey(3)
    want = js.seq_sync_step(jnp.asarray(bits), jnp.asarray(msgs), key,
                            js.SeqSyncParams(**kw))
    if leaf == "bits":
        bits = bits.copy()
        bits[7, 3] = ~bits[7, 3]
    else:
        msgs = msgs.copy()
        msgs[7] ^= 1
    got = _port_step(bits, msgs, key, kw)
    with pytest.raises(AssertionError):
        _assert_same(got, want)


def test_bitmap_gaps_matches_jax():
    bits = np.random.default_rng(1).random((6, 48)) < 0.5
    np.testing.assert_array_equal(
        ts.bitmap_gaps(torch.from_numpy(bits)).numpy(),
        np.asarray(js.bitmap_gaps(jnp.asarray(bits))))


def test_seq_sync_serving_matches_rangeset_order_and_budget():
    """tests/test_sync_model.py's serving check on the port: exactly the
    first budget * seqs_per_chunk needed seqs, in ascending order."""
    from corrosion_tpu.utils.ranges import RangeSet

    s = 40
    p = ts.SeqSyncParams(n_nodes=2, n_seqs=s, seqs_per_chunk=4,
                         chunk_budget=2)
    rng = np.random.default_rng(3)
    server = rng.random(s) < 0.7
    client = server & (rng.random(s) < 0.3)
    bits = torch.from_numpy(np.stack([client, server]))
    new_bits, new_msgs = ts.seq_sync_step(
        bits, torch.zeros(2, dtype=torch.int32),
        key_from_numpy(jax.random.PRNGKey(0)), p)
    have = RangeSet()
    for i in np.nonzero(server & ~client)[0]:
        have.insert(int(i), int(i))
    wanted = [i for a, b in have.spans() for i in range(a, b + 1)]
    expect = set(wanted[: p.chunk_budget * p.seqs_per_chunk])
    got = set(np.nonzero(new_bits[0].numpy() & ~client)[0].tolist())
    assert got == expect
    assert int(new_msgs[1]) >= -(-len(expect) // p.seqs_per_chunk)


def test_seq_sync_out_of_order_hole_heals():
    """tests/test_sync_model.py's hole check on the port: a dropped chunk
    while later chunks land leaves a hole that later rounds heal."""
    s = 32
    p = ts.SeqSyncParams(n_nodes=2, n_seqs=s, seqs_per_chunk=4,
                         chunk_budget=8, loss=0.5)
    start = torch.stack([torch.zeros(s, dtype=torch.bool),
                         torch.ones(s, dtype=torch.bool)])
    msgs = torch.zeros(2, dtype=torch.int32)
    hole = None
    for seed in range(32):
        key = key_from_numpy(jax.random.PRNGKey(seed))
        bits1, _ = ts.seq_sync_step(start, msgs, key, p)
        got = bits1[0].numpy()
        first_missing = int((~got).argmax())
        if got.any() and not got.all() and got[first_missing:].any():
            hole = (seed, bits1)
            break
    assert hole is not None, "no out-of-order hole in 32 seeds"
    seed, prev = hole
    key = jax.random.PRNGKey(seed)
    for t in range(64):
        nxt, msgs = ts.seq_sync_step(
            prev, msgs, key_from_numpy(jax.random.fold_in(key, t)), p)
        assert bool((nxt >= prev).all())
        prev = nxt
        if bool(prev.all()):
            break
    assert bool(prev.all())


def test_scan_chunk_matches_jax():
    """One chunk from the initial carry: the carry bitwise, convergence
    flags exact, mean msgs to rtol 1e-6."""
    cfg = ja.AntiEntropyConfig(n_nodes=300, loss=0.15, chunk_ticks=8,
                               n_universes=3)
    key = jax.random.PRNGKey(4)
    (wbits, wmsgs), (wconv, wmean) = ja._scan_chunk(
        ja.anti_entropy_init(cfg), key, 0, cfg)
    tcfg = ta.AntiEntropyConfig(n_nodes=300, loss=0.15, chunk_ticks=8,
                                n_universes=3)
    (gbits, gmsgs), stats = ta._scan_chunk(
        ta.anti_entropy_init(tcfg, device="cpu"), key_from_numpy(key), 0,
        tcfg)
    np.testing.assert_array_equal(gbits.numpy(), np.asarray(wbits))
    np.testing.assert_array_equal(gmsgs.numpy(), np.asarray(wmsgs))
    np.testing.assert_array_equal(stats[:, :, ks.CONVERGED].numpy() == 1.0,
                                  np.asarray(wconv))
    np.testing.assert_allclose(stats[:, :, ks.MSGS_MEAN].numpy(),
                               np.asarray(wmean), rtol=1e-6)


def test_init_matches_jax():
    cfg = dict(n_nodes=50, n_seqs=12, n_universes=4)
    want = ja.anti_entropy_init(ja.AntiEntropyConfig(**cfg), writer=3)
    got = ta.anti_entropy_init(ta.AntiEntropyConfig(**cfg), writer=3,
                               device="cpu")
    _assert_same(got, want)


def test_seq_stats_plain_reads_every_universe():
    bits = torch.ones((4 * 10, 9), dtype=torch.bool)
    bits[25, 8] = False  # universe 2 misses one seq
    msgs = torch.arange(40, dtype=torch.int32)
    out = ks.seq_stats(bits, msgs, 4)
    assert out[:, ks.CONVERGED].tolist() == [1.0, 1.0, 0.0, 1.0]
    assert out[:, ks.MSGS_MEAN].tolist() == [4.5, 14.5, 24.5, 34.5]


@pytest.mark.parametrize("kw", [
    {},
    {"peers_per_round": 3, "chunk_budget": 2},
], ids=["default", "three-peers-budget-2"])
def test_run_anti_entropy_seeds_matches_jax(kw):
    """1000 nodes x 4 seeds, config #4's shape: stats ints exact, floats
    rtol 1e-6 (summation order)."""
    want = ja.run_anti_entropy_seeds(
        ja.AntiEntropyConfig(n_nodes=1000, **kw), n_seeds=4, seed=0)
    got = ta.run_anti_entropy_seeds(
        ta.AntiEntropyConfig(n_nodes=1000, **kw), n_seeds=4, seed=0,
        device="cpu")
    for k in ("n_nodes", "n_seeds", "converged_frac", "ticks_p50",
              "ticks_p99", "ticks_run"):
        assert got[k] == want[k], k
    assert got["msgs_per_node_mean"] == pytest.approx(
        want["msgs_per_node_mean"], rel=1e-6)


def test_anti_entropy_sim_converges():
    """tests/test_sync_model.py's convergence check on the port."""
    cfg = ta.AntiEntropyConfig(n_nodes=256, n_seqs=32, loss=0.1,
                               max_ticks=96, chunk_ticks=8)
    s = ta.run_anti_entropy_seeds(cfg, n_seeds=4, seed=0, device="cpu")
    assert s["converged_frac"] == 1.0
    assert s["ticks_p99"] < 96
    assert s["msgs_per_node_mean"] > 0


def test_config4_is_bench_anti_entropy():
    """``CONFIG4`` is the reference's default config (bench.py
    ``_anti_entropy`` runs ``AntiEntropyConfig()``) at 32 seeds."""
    ref = ja.AntiEntropyConfig()
    for f in ("n_nodes", "n_seqs", "peers_per_round", "seqs_per_chunk",
              "chunk_budget", "loss", "max_ticks", "chunk_ticks"):
        assert getattr(ta.CONFIG4, f) == getattr(ref, f), f
    assert ta.CONFIG4_SEEDS == 32


def test_convert_round_trip():
    rng = np.random.default_rng(2)
    carry = (rng.random((20, 9)) < 0.5, rng.integers(0, 9, 20).astype(
        np.int32))
    port = anti_entropy_from_numpy(carry, device="cpu")
    assert port[0].dtype == torch.bool and port[1].dtype == torch.int32
    back = anti_entropy_to_numpy(port)
    for a, b in zip(back, carry):
        np.testing.assert_array_equal(a, b)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ta.run_anti_entropy_seeds(ta.AntiEntropyConfig(n_nodes=10),
                                  n_seeds=1)


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import corrosion_tpu_torch.sim.antientropy\n"
        "import corrosion_tpu_torch.sim.churn, corrosion_tpu_torch.sim\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'corrosion_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)
