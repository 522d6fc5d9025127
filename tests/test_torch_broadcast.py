"""The port's broadcast step against ``corrosion_tpu.models.broadcast``,
bit for bit, per topology, with hops and the backoff schedule on and
off, and with partitions in force and healed.

Inputs are random states made with numpy from a seed; both sides get
the same arrays and the same PRNG key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import broadcast as jb
from corrosion_tpu.ops.keys import DEFAULT_CODEC
from corrosion_tpu_torch.convert import key_from_numpy
from corrosion_tpu_torch.kernels.deliver import HOP_UNSET
from corrosion_tpu_torch.models import broadcast as tb


def _random_state(seed, n, r, max_tx, tick):
    rng = np.random.default_rng(seed)
    rows = np.asarray(DEFAULT_CODEC.pack(
        np.ones((n, r), np.int32),
        rng.integers(1, 4, (n, r)).astype(np.int32),
        rng.integers(0, 3, (n, r)).astype(np.int32),
    ))
    tx = np.where(rng.random(n) < 0.5, 0, rng.integers(1, max_tx + 1, n))
    hops = rng.choice(
        np.array([HOP_UNSET, HOP_UNSET - 1, 0, 1, 2, 5, 9], np.int64), n
    )
    return {
        "rows": rows.astype(np.int32),
        "tx": tx.astype(np.int32),
        "msgs": rng.integers(0, 50, n).astype(np.int32),
        "hops": hops.astype(np.int32),
        "next_send": rng.integers(tick - 2, tick + 3, n).astype(np.int32),
    }


# (params, hops, next_send, partition blocks, partition in force)
CASES = {
    "uniform-loss-partitioned": (
        dict(n_nodes=400, loss=0.1, universe=200, ring0_size=16), True, True,
        2, True),
    "uniform-bare": (dict(n_nodes=300, ring0_size=32), False, False, 1, False),
    "uniform-healed": (
        dict(n_nodes=400, loss=0.05, universe=200, ring0_size=16), True, True,
        2, False),
    "het-ring-backoff": (
        dict(n_nodes=512, topology="het_ring", rtt_tiers=3,
             backoff_ticks=1.5, universe=256, ring0_size=16), True, True, 2,
        True),
    "wan-two-region": (
        dict(n_nodes=400, loss=0.05, topology="wan_two_region",
             wan_cross_loss=0.4, universe=200, ring0_size=16), True, True, 1,
        False),
    "measured-ring": (
        dict(n_nodes=600, topology="measured_ring",
             rtt_tier_weights=(3.0, 1.0, 2.0), backoff_ticks=2.5,
             universe=300, ring0_size=20), False, True, 1, False),
    "oneway-0to1": (
        dict(n_nodes=400, oneway_blocks=((0, 1),), universe=200,
             ring0_size=16), True, True, 2, True),
    "oneway-three-blocks": (
        dict(n_nodes=600, loss=0.1, oneway_blocks=((1, 0), (2, 0)),
             universe=300, ring0_size=16), True, True, 3, True),
    "ring0-prime-universe": (
        dict(n_nodes=597, universe=199, ring0_size=16, fanout_ring0=3,
             fanout_global=1), True, True, 1, False),
}


def _partition(n, u, blocks):
    if blocks <= 1:
        return None
    local = np.arange(n, dtype=np.int32) % u
    return (local * blocks // u).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_broadcast_step_matches_jax_bitwise(case):
    kw, use_hops, use_ns, blocks, active = CASES[case]
    jp = jb.BroadcastParams(max_transmissions=6, **kw)
    tp = tb.BroadcastParams(max_transmissions=6, **kw)
    n, tick = jp.n_nodes, 9
    st = _random_state(sum(map(ord, case)), n, 8, 6, tick)
    part = _partition(n, kw.get("universe") or n, blocks)
    key = jax.random.fold_in(jax.random.PRNGKey(3), tick)

    want = jb.broadcast_step(
        jnp.asarray(st["rows"]), jnp.asarray(st["tx"]),
        jnp.asarray(st["msgs"]), key, jp,
        partition_id=None if part is None else jnp.asarray(part),
        partition_active=active,
        hops=jnp.asarray(st["hops"]) if use_hops else None,
        tick=tick, next_send=jnp.asarray(st["next_send"]) if use_ns else None,
    )
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    got = tb.broadcast_step(
        t["rows"], t["tx"], t["msgs"], key_from_numpy(key), tp,
        partition_id=None if part is None else torch.from_numpy(part),
        partition_active=active, hops=t["hops"] if use_hops else None,
        tick=tick, next_send=t["next_send"] if use_ns else None,
    )
    for field in ("rows", "tx_remaining", "msgs_sent", "hops", "next_send"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=field)
    # something was delivered, or the case would prove nothing
    assert not np.array_equal(got.rows.numpy(), st["rows"])


@pytest.mark.parametrize("kw", [
    dict(n_nodes=2000, universe=1000, fanout_ring0=1, fanout_global=3,
         ring0_size=256),  # the headline's columns over two universes
    dict(n_nodes=600, universe=200, fanout_ring0=2, fanout_global=2,
         ring0_size=16),
    dict(n_nodes=597, universe=199, fanout_ring0=1, fanout_global=1,
         ring0_size=16),  # the sliding-window fallback
    dict(n_nodes=512, fanout_ring0=0, fanout_global=3, ring0_size=1),
])
def test_sharded_senders_equal_single_device(kw):
    """The sharded fabric's replicated sender maps (``models.sharded``
    ``_senders``) equal the reference's single-device columns."""
    from corrosion_tpu_torch.models import sharded as ts

    params = tb.BroadcastParams(**kw)
    n, u = params.n_nodes, params.universe or params.n_nodes
    key = jax.random.PRNGKey(21)
    got = ts._senders(key_from_numpy(key), params, "cpu")
    want = np.stack([np.asarray(jb._perm_senders(
        key, j, n, u, j < params.fanout_ring0, params.ring0_size))
        for j in range(params.fanout)])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(n_nodes=600, topology="het_ring", rtt_tiers=4, universe=200),
    dict(n_nodes=500, topology="measured_ring",
         rtt_tier_weights=(0.5, 0.0, 2.0, 1.0), universe=250),
    dict(n_nodes=500, topology="wan_two_region", wan_blocks=3),
    dict(n_nodes=500, topology="wan_two_region", wan_cross_loss=0.0),
    dict(n_nodes=500),
])
def test_tier_and_region_maps_match_jax(kw):
    jp, tp = jb.BroadcastParams(**kw), tb.BroadcastParams(**kw)
    for jfn, tfn in ((jb._rtt_tier, tb._rtt_tier),
                     (jb._wan_region, tb._wan_region)):
        want, got = jfn(jp), tfn(tp, "cpu")
        assert (want is None) == (got is None)
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_measured_tier_map_matches_jax_and_rejects_bad_weights():
    for n, w in ((100, (1, 1)), (97, (3, 0, 2, 5)), (10, (1,))):
        np.testing.assert_array_equal(tb.measured_tier_map(n, w),
                                      np.asarray(jb.measured_tier_map(n, w)))
    with pytest.raises(ValueError):
        tb.measured_tier_map(10, (0, 0))
