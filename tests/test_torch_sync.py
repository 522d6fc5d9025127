"""The port's anti-entropy step and topology helpers against
``corrosion_tpu.models.sync`` / ``models.common``, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import common as jc
from corrosion_tpu.models import sync as js
from corrosion_tpu_torch.convert import key_from_numpy
from corrosion_tpu_torch.models import common as tc
from corrosion_tpu_torch.models import sync as ts

# (params, partition blocks, partition in force)
CASES = {
    "open": (dict(n_nodes=300), 1, False),
    "universes-three-peers": (
        dict(n_nodes=400, universe=100, peers_per_round=3,
             cells_per_chunk=2), 1, False),
    "symmetric-partition": (
        dict(n_nodes=400, universe=200, peers_per_round=2), 2, True),
    "partition-healed": (dict(n_nodes=400, universe=200), 2, False),
    "oneway-needs-both-directions": (
        dict(n_nodes=400, universe=200, peers_per_round=2,
             oneway_blocks=((0, 1),)), 2, True),
    "oneway-three-blocks": (
        dict(n_nodes=600, universe=300, peers_per_round=2, cells_per_chunk=3,
             oneway_blocks=((2, 0),)), 3, True),
}


def _rows(rng, n, r):
    return rng.integers(0, 6, (n, r)).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sync_step_matches_jax_bitwise(case):
    kw, blocks, active = CASES[case]
    rng = np.random.default_rng(len(case))
    n = kw["n_nodes"]
    u = kw.get("universe") or n
    rows = _rows(rng, n, 8)
    msgs = rng.integers(0, 40, n).astype(np.int32)
    part = None
    if blocks > 1:
        part = ((np.arange(n) % u) * blocks // u).astype(np.int32)
    key = jax.random.PRNGKey(len(case))
    want = js.sync_step(
        jnp.asarray(rows), jnp.asarray(msgs), key, js.SyncParams(**kw),
        partition_id=None if part is None else jnp.asarray(part),
        partition_active=active,
    )
    got = ts.sync_step(
        torch.from_numpy(rows), torch.from_numpy(msgs), key_from_numpy(key),
        ts.SyncParams(**kw),
        partition_id=None if part is None else torch.from_numpy(part),
        partition_active=active,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("reach", [False, True])
def test_session_msgs_matches_jax(reach):
    rng = np.random.default_rng(4)
    n, p = 50, 3
    msgs = rng.integers(0, 9, n).astype(np.int32)
    peers = rng.integers(0, n, (n, p)).astype(np.int32)
    chunks = rng.integers(0, 4, (n, p)).astype(np.int32)
    reachable = rng.random((n, p)) < 0.7 if reach else None
    want = js.session_msgs(jnp.asarray(msgs), jnp.asarray(peers),
                           jnp.asarray(chunks), 3,
                           None if reachable is None
                           else jnp.asarray(reachable))
    got = ts.session_msgs(torch.from_numpy(msgs), torch.from_numpy(peers),
                          torch.from_numpy(chunks), 3,
                          None if reachable is None
                          else torch.from_numpy(reachable))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("universe", [None, 60, 1])
def test_rand_peers_match_jax(universe):
    key = jax.random.PRNGKey(8)
    n = 240
    want = jc.rand_peers(key, n, (n, 2), universe=universe)
    got = tc.rand_peers(key_from_numpy(key), n, (n, 2), universe=universe,
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if universe != 1:  # never self, except in a one-node universe
        assert not (got == torch.arange(n)[:, None]).any()


def test_rand_peers_rejects_partial_universe():
    with pytest.raises(ValueError):
        tc.rand_peers(torch.zeros(2, dtype=torch.uint32), 10, (10, 1),
                      universe=3, device="cpu")


@pytest.mark.parametrize("oneway,bidirectional", [
    (None, False), (((0, 1),), False), (((0, 1),), True),
    (((1, 0), (2, 1)), True), (((3, 0),), False),
])
@pytest.mark.parametrize("active", [True, False])
def test_partition_ok_and_severance_match_jax(oneway, bidirectional, active):
    rng = np.random.default_rng(2)
    part = rng.integers(0, 5, 80).astype(np.int32)
    targets = rng.integers(0, 80, (80, 3)).astype(np.int32)
    want = jc.partition_ok(jnp.asarray(part), jnp.asarray(targets), active,
                           oneway=oneway, bidirectional=bidirectional)
    got = tc.partition_ok(torch.from_numpy(part), torch.from_numpy(targets),
                          active, oneway=oneway, bidirectional=bidirectional)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if oneway:
        np.testing.assert_array_equal(
            tc.severance_matrix(oneway, "cpu").numpy(),
            np.asarray(jc.severance_matrix(oneway)))
    assert tc.partition_ok(None, torch.from_numpy(targets), active) is True


def test_bitmap_needs_matches_jax():
    rng = np.random.default_rng(6)
    ours = rng.random((10, 32)) < 0.5
    theirs = rng.random((10, 32)) < 0.5
    np.testing.assert_array_equal(
        ts.bitmap_needs(torch.from_numpy(ours),
                        torch.from_numpy(theirs)).numpy(),
        np.asarray(js.bitmap_needs(jnp.asarray(ours), jnp.asarray(theirs))),
    )
