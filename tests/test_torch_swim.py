"""The port's SWIM membership (``models.swim``, ``kernels.swim``,
``sim.churn``, ``utils.swimscale``) against ``corrosion_tpu.models.swim``
/ ``corrosion_tpu.sim.churn``, bit for bit per tick.

Every leaf (view, suspect_since, incarnation, msgs, update_tx) must be
equal after every tick; the churn stats are integers and float64 means
of integer counters, so they are compared exactly."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import swim as js
from corrosion_tpu.sim import churn as jc
from corrosion_tpu.utils import swimscale as jscale
from corrosion_tpu_torch.convert import (
    key_from_numpy,
    swim_state_from_numpy,
    swim_state_to_numpy,
)
from corrosion_tpu_torch.kernels import swim as ksw
from corrosion_tpu_torch.models import swim as ts
from corrosion_tpu_torch.sim import churn as tch
from corrosion_tpu_torch.utils import swimscale as tscale

FIELDS = js.SwimState._fields

# (SwimParams overrides, nodes, ticks, churn schedule): loss 0 and 0.15,
# a revive, no revived argument, tiny clusters, other probe / gossip
# widths, and 1000 nodes, one of the sizes chip_smoke.py holds the
# kernels to this plain version at
CASES = {
    "n-1000-churn": (dict(scaled=True), 1000, 6, True),
    "scaled-64-churn": (dict(scaled=True), 64, 40, True),
    "loss-0.15-churn": (dict(loss=0.15, suspect_timeout=8), 32, 40, True),
    "loss-0.15-no-revived": (dict(loss=0.15), 24, 30, False),
    "backlog-limit-4": (dict(update_tx_limit=4), 16, 30, False),
    "entries-past-n": (dict(gossip_entries=9, loss=0.3), 5, 30, True),
    "no-helpers-one-target": (dict(num_indirect_probes=0, gossip_targets=1,
                                   loss=0.15), 20, 30, True),
    "wide-gossip": (dict(gossip_targets=5, gossip_entries=12, loss=0.15),
                    48, 25, True),
}
KILL, REVIVE, VICTIM = 4, 20, 1


def _params(mod, n, kw):
    kw = dict(kw)
    if kw.pop("scaled", False):
        return mod.SwimParams.scaled(n, **kw)
    return mod.SwimParams(n_nodes=n, **kw)


def _schedule(n, t, churn):
    alive = np.ones(n, bool)
    revived = np.zeros(n, bool)
    if churn:
        alive[VICTIM] = not KILL <= t < REVIVE
        revived[VICTIM] = t == REVIVE
    return alive, revived


def _leaves_equal(port_state, ref_state) -> list:
    got = swim_state_to_numpy(port_state)
    return [f for f in FIELDS
            if not np.array_equal(got[f], np.asarray(getattr(ref_state, f)))]


def _lockstep(n, ticks, kw, churn, seed=0, ref=None, port=None):
    jp, tp = _params(js, n, kw), _params(ts, n, kw)
    ref = ref if ref is not None else js.swim_init(n)
    port = port if port is not None else ts.swim_init(n, device="cpu")
    key = jax.random.PRNGKey(seed)
    for t in range(ticks):
        alive, revived = _schedule(n, t, churn)
        k = jax.random.fold_in(key, t)
        ref = js.swim_step(ref, k, jnp.int32(t), jp, jnp.asarray(alive),
                           revived=jnp.asarray(revived) if churn else None)
        port = ts.swim_step(port, key_from_numpy(k), t, tp,
                            torch.from_numpy(alive),
                            revived=torch.from_numpy(revived)
                            if churn else None)
        bad = _leaves_equal(port, ref)
        assert not bad, f"tick {t}: {bad} differ"
    return ref, port


@pytest.mark.parametrize("case", sorted(CASES))
def test_swim_step_matches_jax_bitwise_per_tick(case):
    kw, n, ticks, churn = CASES[case]
    _lockstep(n, ticks, kw, churn, seed=len(case))


def test_crafted_ties_take_the_lower_index_first():
    """update_tx at 2**24 makes update_tx + uniform round to the same
    float32 for most entries: the freshest-entry selection must break
    those ties by the lower index first, as lax.top_k does."""
    n = 24
    kw = dict(update_tx_limit=2**30, loss=0.15)
    rng = np.random.default_rng(11)
    base = 2**24
    st = {
        "view": rng.integers(0, 3, (n, n)).astype(np.int32),
        "suspect_since": np.full((n, n), 2**31 - 1, np.int32),
        "incarnation": np.zeros(n, np.int32),
        "msgs": np.zeros(n, np.int32),
        "update_tx": (base + 2 * rng.integers(0, 2, (n, n))).astype(
            np.int32),
    }
    tie = rng.random(1000).astype(np.float32)
    assert (np.float32(base) + tie == np.float32(base)).all()  # real ties
    _lockstep(n, 3, kw, churn=False, seed=2,
              ref=js.SwimState(**{k: jnp.asarray(v) for k, v in st.items()}),
              port=swim_state_from_numpy(st, device="cpu"))


def test_rows_at_the_limit_take_the_lowest_indices():
    """Whole rows with every update_tx at or past the retransmission
    limit score +inf throughout: top_k takes their lowest indices, none
    sendable, so those rows gossip nothing and charge nothing.  The
    port holds the reference bitwise per tick from such a state
    (every third row at the limit, every seventh from row 1 past it)."""
    _, lowest = jax.lax.top_k(jnp.full((1, 7), -jnp.inf), 3)
    assert np.asarray(lowest).tolist() == [[0, 1, 2]]
    n, kw = 48, dict(loss=0.15, suspect_timeout=8)
    ref, port = _lockstep(n, 6, kw, churn=True, seed=3)
    limit = js.SwimParams(n_nodes=n, **kw).update_tx_limit
    leaves = swim_state_to_numpy(port)
    tx = leaves["update_tx"].copy()
    tx[::3] = limit
    tx[1::7] = limit + 5
    leaves["update_tx"] = tx
    ref = ref._replace(update_tx=jnp.asarray(tx))
    port = swim_state_from_numpy(leaves, device="cpu")
    ref, port = _lockstep(n, 3, kw, churn=True, seed=4, ref=ref, port=port)
    assert not _leaves_equal(port, ref)


def test_selection_order_matches_top_k():
    """The plain selection (a stable ascending sort of the scores) gives
    lax.top_k(-scores)'s indices in its order, +inf (past the limit) and
    equal scores by lower index."""
    vals = np.array([[1, 3, 3, 2, 3, -np.inf, -np.inf, 3]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(vals), 5)
    got = torch.sort(torch.from_numpy(-vals), dim=1, stable=True).indices
    assert np.asarray(want).tolist() == [[1, 2, 4, 7, 3]]
    assert got[:, :5].tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("field", ["view", "update_tx", "incarnation"])
def test_negative_control_one_flipped_bit(field):
    """One flipped bit in the port's state must make the per-tick
    comparison fail."""
    n = 32
    ref, port = _lockstep(n, 6, dict(loss=0.15), churn=True)
    leaves = swim_state_to_numpy(port)
    leaves[field] = leaves[field].copy()
    leaves[field].reshape(-1)[5] ^= 1
    port = swim_state_from_numpy(leaves, device="cpu")
    with pytest.raises(AssertionError):
        _lockstep(n, 1, dict(loss=0.15), churn=True, seed=9, ref=ref,
                  port=port)


def test_swim_tick_flags_count_the_victims_records():
    n = 16
    st = ts.swim_init(n, device="cpu")
    view = st.view.clone()
    view[:, 3] = ts.member_key(2, ts.DOWN)
    view[5, 3] = ts.member_key(2, ts.ALIVE)
    view[3, 3] = ts.member_key(0, ts.SUSPECT)  # the victim's own record
    st = st._replace(view=view)
    flags = torch.zeros(2, dtype=torch.int32)
    alive = torch.ones(n, dtype=torch.bool)
    out = ts.swim_step(st, key_from_numpy(jax.random.PRNGKey(0)), 0,
                       ts.SwimParams(n_nodes=n), alive, victim=3,
                       flags=flags)
    col = out.view[:, 3] % 4
    others = torch.arange(n) != 3
    assert flags.tolist() == [int(((col == ts.DOWN) & others).sum()),
                              int(((col == ts.ALIVE) & others).sum())]
    assert sum(flags.tolist()) == n - 1


def _run(n, ticks, alive_fn, params=None, seed=0):
    p = params or ts.SwimParams(n_nodes=n)
    st = ts.swim_init(n, device="cpu")
    key = jax.random.PRNGKey(seed)
    for t in range(ticks):
        st = ts.swim_step(st, key_from_numpy(jax.random.fold_in(key, t)), t,
                          p, alive_fn(t))
    return st, p


# tests/test_swim_model.py's behaviours, on the port


def test_stable_cluster_stays_alive():
    n = 16
    st, _ = _run(n, 20, lambda t: torch.ones(n, dtype=torch.bool))
    assert bool((ts.key_state(st.view) == ts.ALIVE).all())


def test_dead_node_detected_down():
    n, victim = 16, 3
    alive = torch.ones(n, dtype=torch.bool)
    alive[victim] = False
    st, _ = _run(n, 40, lambda t: alive)
    col = ts.key_state(st.view[:, victim])
    assert bool((col[torch.arange(n) != victim] == ts.DOWN).all())


def test_false_suspicion_refuted_by_incarnation():
    n = 16
    p = ts.SwimParams(n_nodes=n, loss=0.15, suspect_timeout=8)
    st, _ = _run(n, 60, lambda t: torch.ones(n, dtype=torch.bool),
                 params=p, seed=1)
    frac_down = float((ts.key_state(st.view) == ts.DOWN).double().mean())
    assert frac_down < 0.02
    assert int(st.incarnation.max()) > 0


def test_rejoin_after_down():
    n, victim, kill, revive = 16, 2, 2, 30

    def alive_fn(t):
        a = torch.ones(n, dtype=torch.bool)
        a[victim] = not kill <= t < revive
        return a

    st, _ = _run(n, 80, alive_fn)
    col = ts.key_state(st.view[:, victim])
    assert bool((col[torch.arange(n) != victim] == ts.ALIVE).all())
    assert int(st.incarnation[victim]) > 0


def test_messages_bounded_per_tick():
    n = 32
    p = ts.SwimParams(n_nodes=n)
    st, _ = _run(n, 10, lambda t: torch.ones(n, dtype=torch.bool), params=p)
    per_tick = float(st.msgs.double().mean()) / 10
    assert per_tick <= 2 + p.num_indirect_probes * 3 + p.gossip_targets


def test_update_backlog_decays_then_freezes():
    n = 16
    p = ts.SwimParams(n_nodes=n, update_tx_limit=4)
    ones = lambda t: torch.ones(n, dtype=torch.bool)  # noqa: E731
    st, _ = _run(n, 12, ones, params=p)
    tx = st.update_tx.numpy()
    assert tx.max() <= p.update_tx_limit + 8
    assert (tx >= p.update_tx_limit).mean() > 0.5
    more, _ = _run(n, 24, ones, params=p)
    even, _ = _run(n, 30, ones, params=p)
    assert torch.equal(more.update_tx, even.update_tx)


@pytest.mark.parametrize("size", [1, 3, 9, 10, 64, 99, 512, 100_000])
def test_swimscale_matches_reference(size):
    assert tscale.swim_scale_factor(size) == jscale.swim_scale_factor(size)
    assert tscale.scaled_suspect_timeout(2.0, 0.4, size) == (
        jscale.scaled_suspect_timeout(2.0, 0.4, size))
    assert tscale.scaled_update_retransmissions(size) == (
        jscale.scaled_update_retransmissions(size))
    got = ts.SwimParams.scaled(max(size, 2), loss=0.1)
    want = js.SwimParams.scaled(max(size, 2), loss=0.1)
    assert got.__dict__ == want.__dict__


def test_scan_chunk_flags_match_jax():
    cfg = dict(n_nodes=32, kill_tick=2, revive_tick=20, chunk_ticks=30)
    jcfg, tcfg = jc.ChurnConfig(**cfg), tch.ChurnConfig(**cfg)
    key = jax.random.PRNGKey(5)
    ref, (det, rej) = jc._scan_chunk(js.swim_init(32), key, 0, jcfg)
    port, (pdet, prej) = tch._scan_chunk(ts.swim_init(32, device="cpu"),
                                         key_from_numpy(key), 0, tcfg)
    assert not _leaves_equal(port, ref)
    np.testing.assert_array_equal(pdet, np.asarray(det))
    np.testing.assert_array_equal(prej, np.asarray(rej))
    assert pdet.any() and prej.any()


def test_config2_churn_matches_jax():
    """BASELINE config #2 (bench.py ``_churn64``): detect 15, rejoin 4,
    4.982421875 msgs/node/tick on both sides, every stat equal."""
    want = jc.run_churn(jc.ChurnConfig(n_nodes=64))
    got = tch.run_churn(tch.ChurnConfig(n_nodes=64), device="cpu")
    want.pop("wall_s")
    got.pop("wall_s")
    assert got == want
    assert (got["detect_latency"], got["rejoin_latency"]) == (15, 4)
    assert got["msgs_per_node_per_tick"] == 4.982421875


def test_churn_detection_and_rejoin():
    """tests/test_epidemic_sim.py's churn check on the port."""
    cfg = tch.ChurnConfig(n_nodes=64, kill_tick=4, revive_tick=40,
                          max_ticks=160)
    stats = tch.run_churn(cfg, seed=0, device="cpu")
    assert stats["detect_latency"] is not None and stats["detect_latency"] > 0
    assert stats["rejoin_latency"] is not None and stats["rejoin_latency"] >= 0
    assert stats["msgs_per_node_mean"] > 0


def test_churn_cycles_match_jax():
    cfg = dict(n_nodes=48, cycles=2, cycle_period=48, kill_tick=4,
               revive_tick=30, chunk_ticks=24)
    want = jc.run_churn_cycles(jc.ChurnConfig(**cfg), seed=1)
    got = tch.run_churn_cycles(tch.ChurnConfig(**cfg), seed=1, device="cpu")
    want.pop("wall_s")
    got.pop("wall_s")
    assert got == want


def test_churn_rejects_a_victim_outside_the_cluster():
    with pytest.raises(ValueError, match="victim"):
        tch.run_churn(tch.ChurnConfig(n_nodes=8, victim=8, max_ticks=32),
                      device="cpu")


def test_convert_round_trip():
    st = js.swim_init(6)
    port = swim_state_from_numpy(st, device="cpu")
    assert all(getattr(port, f).dtype == torch.int32 for f in FIELDS)
    back = swim_state_to_numpy(port)
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(st, f)))


def test_kernel_key_table_follows_the_split_order():
    """The kernel's key table: each peer draw's two split keys, then the
    uniforms, all from split(key, 11) in the reference's order."""
    key = jax.random.PRNGKey(7)
    subs = np.asarray(jax.random.split(key, 11))
    keys = ksw.tick_keys(key_from_numpy(key))
    names = ksw.SPLIT_ORDER
    for name in ksw.UNIFORM_KEYS:
        assert keys[name] == tuple(subs[names.index(name)].tolist())
    for name in ksw.PEER_KEYS:
        pair = np.asarray(jax.random.split(subs[names.index(name)]))
        assert keys[name] == tuple(tuple(r.tolist()) for r in pair)
    assert len(list(ksw._key_table(keys))) == 30


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tch.run_churn(tch.ChurnConfig(n_nodes=8))


@pytest.mark.parametrize("targets", [0, 3])
def test_launch_order_runs_the_gossip_pass_only_with_targets(targets):
    """A tick launches probe/select, the gossip pass when there are
    gossip targets, gather + ping, gather + ack, then settle: every
    launch is one that starts a kernel."""
    order = [(fn.__name__, extra) for fn, extra in
             ksw.launch_order(targets)]
    gossip = [("swim_spread", (ksw.GOSSIP,))] if targets else []
    assert order == [("swim_probe_select", ()), *gossip,
                     ("swim_gather", ()), ("swim_spread", (ksw.PING,)),
                     ("swim_gather", ()), ("swim_spread", (ksw.ACK,)),
                     ("swim_settle", ())]


def test_kernel_entry_width_matches_the_source():
    """The wrapper's selection-pass width is the kernel's register
    list."""
    src = (Path(ksw.__file__).parent / "csrc" / "swim.cu").read_text()
    (width,) = re.findall(r"constexpr int MAX_M = (\d+);", src)
    assert int(width) == ksw.MAX_ENTRIES


@pytest.mark.parametrize("entries", [9, 12, 20])
def test_prepare_takes_gossip_wider_than_one_pass(entries):
    """The card takes any gossip width (``MAX_ENTRIES`` a selection
    pass): ``prepare`` refuses these CPU tensors for their device, not
    for the width, where it used to stop at ``MAX_ENTRIES``."""
    n = 32
    params = ts.SwimParams(n_nodes=n, gossip_entries=entries)
    i32 = torch.int32
    mat = torch.zeros((n, n), dtype=i32)
    vec = torch.zeros(n, dtype=i32)
    keys = ksw.tick_keys(np.array([0, 7], np.uint32))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ksw.prepare(mat, mat, vec, vec, mat, keys, 0, params,
                    torch.ones(n, dtype=torch.bool))
