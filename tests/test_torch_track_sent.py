"""The port's ``track_sent`` path (the agents' exact ``sent_to`` sampler:
``broadcast_step(sent=...)``, ``epidemic_tick`` and the seed-batched
``run_epidemic_seeds``) against ``corrosion_tpu``.

``broadcast_step`` is held bitwise per call, ``sent`` included, over a
few chained calls for uniform sampling, loss, a one-way partition in
force, the WAN drop, RTT tiers with the backoff schedule, and hops on
and off; the seed-batched runner per tick against the reference's
vmapped ``epidemic_tick`` and in its stats dict (ints exact, floats to
rtol 1e-6), with and without sync; ``sim_trace``'s config reproduces
``SIMDIFF_N64.json``.  A flipped ``sent`` bit must break the equality.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import broadcast as jb
from corrosion_tpu.ops.keys import DEFAULT_CODEC
from corrosion_tpu.sim import epidemic as je
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.kernels import sent_sampler as ss
from corrosion_tpu_torch.kernels.deliver import HOP_UNSET
from corrosion_tpu_torch.models import broadcast as tb
from corrosion_tpu_torch.random import PRNGKey, fold_in, split
from corrosion_tpu_torch.sim import epidemic as te

ROOT = Path(__file__).resolve().parent.parent

# (params, hops, next_send, partition blocks, partition in force)
CASES = {
    "uniform": (dict(n_nodes=96), False, False, 1, False),
    "loss-hops": (dict(n_nodes=96, loss=0.2), True, False, 1, False),
    "oneway-in-force": (
        dict(n_nodes=120, loss=0.05, oneway_blocks=((0, 1),)), True, True,
        2, True),
    "symmetric-partition": (dict(n_nodes=120), True, True, 3, True),
    "wan-two-region": (
        dict(n_nodes=100, loss=0.05, topology="wan_two_region",
             wan_cross_loss=0.4), True, True, 1, False),
    "het-ring-backoff": (
        dict(n_nodes=128, topology="het_ring", rtt_tiers=3,
             backoff_ticks=1.5), True, True, 1, False),
    "measured-ring": (
        dict(n_nodes=90, topology="measured_ring",
             rtt_tier_weights=(3.0, 1.0, 2.0), backoff_ticks=2.5), False,
        True, 1, False),
}
FIELDS = ("rows", "tx_remaining", "msgs_sent", "hops", "next_send", "sent")

_jit_step = jax.jit(jb.broadcast_step, static_argnames=("params",))
_jit_tick = jax.jit(je.epidemic_tick, static_argnames=("cfg",))


def _random_state(seed, n, r, max_tx, tick):
    rng = np.random.default_rng(seed)
    rows = np.asarray(DEFAULT_CODEC.pack(
        np.ones((n, r), np.int32),
        rng.integers(1, 4, (n, r)).astype(np.int32),
        rng.integers(0, 3, (n, r)).astype(np.int32),
    ))
    tx = np.where(rng.random(n) < 0.3, 0, rng.integers(1, max_tx + 1, n))
    hops = rng.choice(
        np.array([HOP_UNSET, HOP_UNSET - 1, 0, 1, 2, 5, 9], np.int64), n)
    sent = rng.random((n, n)) < 0.2
    sent[:3] = rng.random((3, n)) < 0.97  # rows with few peers left
    return {
        "rows": rows.astype(np.int32),
        "tx": tx.astype(np.int32),
        "msgs": rng.integers(0, 50, n).astype(np.int32),
        "hops": hops.astype(np.int32),
        "next_send": rng.integers(tick - 2, tick + 3, n).astype(np.int32),
        "sent": sent,
    }


def _partition(n, blocks):
    if blocks <= 1:
        return None
    return (np.arange(n, dtype=np.int32) * blocks // n).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_broadcast_step_sent_matches_reference(case):
    kw, use_hops, use_ns, blocks, active = CASES[case]
    jp = jb.BroadcastParams(fanout_ring0=0, fanout_global=4,
                            max_transmissions=6, **kw)
    tp = tb.BroadcastParams(fanout_ring0=0, fanout_global=4,
                            max_transmissions=6, **kw)
    n, tick = jp.n_nodes, 9
    st = _random_state(sum(map(ord, case)), n, 4, 6, tick)
    part = _partition(n, blocks)
    want = [jnp.asarray(st[f]) for f in ("rows", "tx", "msgs")]
    want_hops = jnp.asarray(st["hops"]) if use_hops else None
    want_ns = jnp.asarray(st["next_send"]) if use_ns else None
    want_sent = jnp.asarray(st["sent"])
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    got = [t["rows"], t["tx"], t["msgs"]]
    got_hops = t["hops"] if use_hops else None
    got_ns = t["next_send"] if use_ns else None
    got_sent = t["sent"].clone()
    delivered = 0
    for step in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(3), tick + step)
        w = _jit_step(
            *want, key, jp,
            partition_id=None if part is None else jnp.asarray(part),
            partition_active=active, hops=want_hops, tick=tick + step,
            next_send=want_ns, sent=want_sent)
        g = tb.broadcast_step(
            *got, convert.key_from_numpy(key), tp,
            partition_id=None if part is None else torch.from_numpy(part),
            partition_active=active, hops=got_hops, tick=tick + step,
            next_send=got_ns, sent=got_sent)
        assert g.sent is got_sent  # marked in place
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(
                    a.numpy(), np.asarray(b), err_msg=f"{case} {step} {f}")
        delivered += int((g.rows.numpy() != got[0].numpy()).any(1).sum())
        want, want_hops, want_ns, want_sent = (
            [w.rows, w.tx_remaining, w.msgs_sent], w.hops, w.next_send,
            w.sent)
        got, got_hops, got_ns = ([g.rows, g.tx_remaining, g.msgs_sent],
                                 g.hops, g.next_send)
    assert delivered > 0  # or the case would prove nothing


def test_flipped_sent_bit_breaks_equality():
    kw, *_ = CASES["uniform"]
    jp = jb.BroadcastParams(fanout_ring0=0, fanout_global=4, **kw)
    tp = tb.BroadcastParams(fanout_ring0=0, fanout_global=4, **kw)
    st = _random_state(7, jp.n_nodes, 4, 8, 0)
    key = jax.random.PRNGKey(9)
    w = _jit_step(jnp.asarray(st["rows"]), jnp.asarray(st["tx"]),
                  jnp.asarray(st["msgs"]), key, jp,
                  sent=jnp.asarray(st["sent"]))
    # un-mark a peer an active row with all k targets skipped for a
    # higher-scored target: it now displaces that target
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    key_t, _ = split(convert.key_from_numpy(key))
    scores = ss.chunk_scores(torch.zeros_like(t["sent"]), key_t.tolist(),
                             0).numpy()
    for i in np.flatnonzero(st["tx"] > 0):
        picked = np.asarray(w.sent)[i] & ~st["sent"][i]
        if picked.sum() < jp.fanout:
            continue
        skipped = st["sent"][i] & (scores[i] < scores[i][picked].max())
        skipped[i] = False
        if skipped.any():
            j = int(np.flatnonzero(skipped)[0])
            break
    t["sent"][i, j] = False
    g = tb.broadcast_step(t["rows"], t["tx"], t["msgs"],
                          convert.key_from_numpy(key), tp, sent=t["sent"])
    assert not np.array_equal(g.sent.numpy(), np.asarray(w.sent))


def test_universe_with_sent_raises():
    p = tb.BroadcastParams(n_nodes=8, universe=4)
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="calibration-scale"):
        tb.broadcast_step(torch.zeros((8, 2), dtype=torch.int32), z, z,
                          PRNGKey(0), p,
                          sent=torch.zeros((8, 8), dtype=torch.bool))


def _cfgs(**kw):
    base = dict(n_nodes=64, n_rows=4, fanout_ring0=0, fanout_global=3,
                ring0_size=1, max_transmissions=5, loss=0.0,
                backoff_ticks=2.5, track_sent=True, sync_interval=0,
                sync_peers=1, max_ticks=256, chunk_ticks=8)
    base.update(kw)
    return je.EpidemicConfig(**base), te.EpidemicConfig(**base)


RUNNER_CASES = {
    "no_sync": {},
    "sync_every_4": dict(sync_interval=4, chunk_ticks=16),
    "faults_het_ring": dict(loss=0.1, partition_blocks=2, heal_tick=6,
                            oneway_blocks=((0, 1),), topology="het_ring",
                            sync_interval=4),
}


def _stats_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "wall_s":
            continue
        g = got[k]
        if w is None or isinstance(w, int) or k in ("converged_frac",
                                                   "ticks_p50", "ticks_p99"):
            assert g == w, (k, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_seed_batched_runner_matches_reference_per_tick(case):
    jcfg, tcfg = _cfgs(**RUNNER_CASES[case])
    seeds = 4
    jkeys = jax.random.split(jax.random.PRNGKey(0), seeds)
    refs = [je.epidemic_init(jcfg) for _ in range(seeds)]
    port = te.sent_seeds_init(tcfg, seeds, device="cpu")
    tkeys = list(split(PRNGKey(0), seeds))
    for t in range(20):
        refs = [_jit_tick(r, jax.random.fold_in(k, t), jcfg)
                for r, k in zip(refs, jkeys)]
        port = te.sent_seeds_tick(port, [fold_in(k, t) for k in tkeys],
                                  tcfg)
        got = convert.state_to_numpy(port)
        assert got["tick"] == t + 1
        for s, ref in enumerate(refs):
            for f in (*convert.TENSOR_FIELDS, "sent"):
                np.testing.assert_array_equal(
                    got[f][s], np.asarray(getattr(ref, f)),
                    err_msg=f"{case} tick {t} seed {s} {f}")
    want = je.run_epidemic_seeds(jcfg, n_seeds=seeds, seed=0)
    got = te.run_epidemic_seeds(tcfg, n_seeds=seeds, seed=0, device="cpu")
    _stats_close(got, want)


def test_single_universe_tick_matches_reference():
    jcfg, tcfg = _cfgs(sync_interval=2, loss=0.1)
    ref = je.epidemic_init(jcfg)
    port = te.epidemic_init(tcfg, device="cpu")
    key = jax.random.PRNGKey(4)
    for t in range(8):
        k = jax.random.fold_in(key, t)
        ref = _jit_tick(ref, k, jcfg)
        sent = port.sent
        port = te.epidemic_tick(port, convert.key_from_numpy(k), tcfg)
        assert port.sent is sent  # through the sync unchanged
        got = convert.state_to_numpy(port)
        for f in (*convert.TENSOR_FIELDS, "sent"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)),
                                          err_msg=f"tick {t} {f}")


def test_sim_trace_config_reproduces_simdiff_n64():
    want = json.loads((ROOT / "SIMDIFF_N64.json").read_text())["sim"]
    cfg = te.sent_trace_cfg(64)
    jcfg, _ = _cfgs()
    assert cfg == te.EpidemicConfig(**{
        f: getattr(jcfg, f) for f in te.EpidemicConfig.__dataclass_fields__})
    got = te.run_epidemic_seeds(cfg, n_seeds=8, seed=0, device="cpu")
    assert got["converged_frac"] == want["converged_frac"]
    assert got["ticks_p50"] == want["ticks_to_converge_p50"]
    assert got["ticks_p99"] == want["ticks_to_converge_p99"]
    for k, w in (("msgs_per_node_mean", "msgs_per_node"),
                 ("hops_p50", "hops_p50"), ("hops_p99", "hops_p99")):
        np.testing.assert_allclose(got[k], want[w], rtol=1e-6, err_msg=k)


def test_coverage_refuses_track_sent():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="seed-flattened"):
        te.run_epidemic_coverage(tcfg, n_seeds=2, device="cpu")


def test_epidemic_state_with_sent_round_trips():
    jcfg, tcfg = _cfgs()
    ref = je.epidemic_init(jcfg)
    for t in range(3):
        ref = _jit_tick(ref, jax.random.fold_in(jax.random.PRNGKey(1), t),
                        jcfg)
    port = convert.state_from_numpy(ref, device="cpu")
    assert port.sent.dtype == torch.bool and port.sent.any()
    back = convert.state_to_numpy(
        convert.state_from_numpy(convert.state_to_numpy(port), "cpu"))
    for f in (*convert.TENSOR_FIELDS, "sent"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(ref, f)))
    # a seed batch converts too, its ticks one
    batch = te.sent_seeds_init(tcfg, 3, device="cpu")
    again = convert.state_from_numpy(convert.state_to_numpy(batch), "cpu")
    assert again.sent.shape == (3, 64, 64) and again.tick == 0


def test_cpu_track_sent_launches_no_kernel():
    counted = (ss.sent_select, ss.sent_commit)
    before = [f.launches for f in counted]
    _, tcfg = _cfgs(max_ticks=8)
    te.run_epidemic_seeds(tcfg, n_seeds=2, device="cpu")
    assert [f.launches for f in counted] == before


def test_track_sent_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the call would run")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        te.run_epidemic_seeds(tcfg, n_seeds=2)
