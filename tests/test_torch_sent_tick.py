"""``sent_tick``, the sampler's one host call a tick
(``corrosion_tpu_torch.kernels.sent_sampler``), against its two calls
and against ``corrosion_tpu``.

On the CPU ``sent_tick`` must equal ``sent_select_plain`` followed by
``sent_commit_plain`` (every output, ``sent`` included), and per tick
the reference's ``exact_tick`` (a short last sender chunk, with and
without backoff, and N = 16 where rows run out of peers) and its
``broadcast_step`` with ``sent`` (10% loss with a one-way partition in
force, the WAN drop, RTT tiers with backoff; hops; int32 keys, and
int64 keys held through an order-keeping map of the reference's int32
ones), all bitwise.  The argument block's ctypes mirror is held to the
kernel source's ``SentArgs`` field for field.  The kernels run only on
the card; here no launch may be counted.
"""

import ctypes
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu.models import broadcast as jb
from corrosion_tpu.ops.keys import DEFAULT_CODEC
from corrosion_tpu.sim import calibrate as jc
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.kernels import sent_sampler as ss
from corrosion_tpu_torch.kernels.deliver import HOP_UNSET
from corrosion_tpu_torch.models import broadcast as tb
from corrosion_tpu_torch.random import split
from corrosion_tpu_torch.sim import calibrate as tc
from corrosion_tpu_torch.sim import epidemic as te

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "corrosion_tpu_torch" / "kernels" / "csrc" / "sent_sampler.cu"

# (config, ticks run), as tests/test_torch_calib.py: a short last chunk
# (1000 = 2 * 384 + 232), the backoff schedule, and N = 16 with a budget
# of 8 x 4 sends, where every row exhausts its 15 peers
EXACT_CASES = {
    "chunked": (dict(n_nodes=1000, sender_chunk=384), 9),
    "chunked_backoff": (dict(n_nodes=1000, sender_chunk=384,
                             backoff_ticks=1.5), 14),
    "exhausted_16": (dict(n_nodes=16, fanout=4, max_transmissions=8), 12),
}
# (params, partition blocks, partition in force)
BROADCAST_CASES = {
    "loss_oneway": (dict(n_nodes=120, loss=0.1, oneway_blocks=((0, 1),)),
                    2, True),
    "wan_drop": (dict(n_nodes=100, loss=0.05, topology="wan_two_region",
                      wan_cross_loss=0.4), 1, False),
    "rtt_tiers": (dict(n_nodes=128, topology="het_ring", rtt_tiers=3,
                       backoff_ticks=1.5), 1, False),
}
WIDE_SHIFT = 1 << 32  # int64 keys: the int32 ones in the high word, + 7

_jit_exact = jax.jit(jc.exact_tick, static_argnames=("cfg",))
_jit_step = jax.jit(jb.broadcast_step, static_argnames=("params",))


def _assert_same(got, want, where):
    assert len(got) == len(want), where
    for j, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), f"{where}: output {j}"
        if g is not None:
            assert g.dtype == w.dtype, f"{where}: output {j}"
            np.testing.assert_array_equal(g.numpy(), w.numpy(),
                                          err_msg=f"{where}: output {j}")


def _two_calls(select, commit):
    """sent_select_plain then sent_commit_plain on a copy of ``sent``:
    (their outputs in sent_tick's order, the marked copy)."""
    sent = select["sent"].clone()
    out = ss.sent_select_plain(**{**select, "sent": sent})
    if "infected" in select:
        extra = dict(new_infected=out[0])
    else:
        extra = dict(new_rows=out[0], cand=out[1])
    return (*out, *ss.sent_commit_plain(out[-1], **extra, **commit)), sent


@pytest.mark.parametrize("case", sorted(EXACT_CASES))
def test_sent_tick_matches_reference_exact_tick(case):
    kw, ticks = EXACT_CASES[case]
    jcfg, tcfg = jc.ExactConfig(**kw), tc.ExactConfig(**kw)
    ref = jc.exact_init(jcfg)
    port = tc.exact_init(tcfg, device="cpu")
    key = jax.random.PRNGKey(11)
    for t in range(ticks):
        k = jax.random.fold_in(key, t)
        msgs_before = np.asarray(ref.msgs)
        ref = _jit_exact(ref, k, jcfg)
        select, commit = tc.exact_inputs(port, convert.key_from_numpy(k),
                                         tcfg)
        want, want_sent = _two_calls(select, commit)
        got = ss.sent_tick(**{**select, **commit})
        _assert_same(got, want, f"{case} tick {t}: the two calls")
        np.testing.assert_array_equal(port.sent.numpy(), want_sent[0].numpy())
        new_infected, counts, tx, next_send, msgs = (x[0] for x in got)
        port = tc.ExactState(new_infected, tx, next_send, port.sent, msgs,
                             port.tick + 1)
        got_np = convert.exact_state_to_numpy(port)
        for f in ("infected", "tx", "next_send", "sent", "msgs"):
            np.testing.assert_array_equal(
                got_np[f], np.asarray(getattr(ref, f)),
                err_msg=f"{case} tick {t}: {f}")
        np.testing.assert_array_equal(counts.numpy(),
                                      np.asarray(ref.msgs) - msgs_before)
    assert bool(np.asarray(ref.infected).all())


def _random_state(seed, n, max_tx, tick):
    rng = np.random.default_rng(seed)
    rows = np.asarray(DEFAULT_CODEC.pack(
        np.ones((n, 4), np.int32),
        rng.integers(1, 4, (n, 4)).astype(np.int32),
        rng.integers(0, 3, (n, 4)).astype(np.int32),
    )).astype(np.int32)
    tx = np.where(rng.random(n) < 0.3, 0, rng.integers(1, max_tx + 1, n))
    hops = rng.choice(
        np.array([HOP_UNSET, HOP_UNSET - 1, 0, 1, 2, 5, 9], np.int64), n)
    sent = rng.random((n, n)) < 0.2
    sent[:3] = rng.random((3, n)) < 0.97  # rows with few peers left
    return (rows, tx.astype(np.int32),
            rng.integers(0, 50, n).astype(np.int32), hops.astype(np.int32),
            rng.integers(tick - 2, tick + 3, n).astype(np.int32), sent)


def _wide(rows):
    return rows.to(torch.int64) * WIDE_SHIFT + 7


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("case", sorted(BROADCAST_CASES))
def test_sent_tick_matches_reference_broadcast_step(case, wide):
    kw, blocks, in_force = BROADCAST_CASES[case]
    common = dict(fanout_ring0=0, fanout_global=4, max_transmissions=6)
    jp = jb.BroadcastParams(**common, **kw)
    tp = tb.BroadcastParams(**common, **kw)
    n, tick = jp.n_nodes, 9
    rows, tx, msgs, hops, next_send, sent = _random_state(
        sum(map(ord, case)), n, 6, tick)
    part = None
    if blocks > 1:
        part = (np.arange(n, dtype=np.int32) * blocks // n).astype(np.int32)
    want = [jax.numpy.asarray(x) for x in (rows, tx, msgs, hops, next_send,
                                           sent)]
    got = [torch.from_numpy(x) for x in (rows, tx, msgs, hops, next_send)]
    if wide:
        got[0] = _wide(got[0])
    got_sent = torch.from_numpy(sent)
    delivered = 0
    for step in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(3), tick + step)
        w = _jit_step(*want[:3], key, jp,
                      partition_id=None if part is None
                      else jax.numpy.asarray(part),
                      partition_active=in_force, hops=want[3],
                      tick=tick + step, next_send=want[4], sent=want[5])
        select, commit = tb.sent_inputs(
            *(x[None] for x in got[:4]), tick + step, got[4][None],
            got_sent[None], [tuple(split(convert.key_from_numpy(key)))], tp,
            None if part is None else torch.from_numpy(part), in_force)
        two, two_sent = _two_calls(select, commit)
        out = ss.sent_tick(**{**select, **commit})
        where = f"{case} step {step}"
        _assert_same(out, two, f"{where}: the two calls")
        np.testing.assert_array_equal(got_sent.numpy(), two_sent[0].numpy())
        new_rows, _, counts, tx2, msgs2, hops2, next2 = (x[0] for x in out)
        want_rows = torch.from_numpy(np.array(w.rows))
        np.testing.assert_array_equal(
            new_rows.numpy(),
            (_wide(want_rows) if wide else want_rows).numpy(),
            err_msg=f"{where}: rows")
        for f, g in (("tx_remaining", tx2), ("msgs_sent", msgs2),
                     ("hops", hops2), ("next_send", next2),
                     ("sent", got_sent)):
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(getattr(w, f)),
                err_msg=f"{where}: {f}")
        np.testing.assert_array_equal(
            counts.numpy(), np.asarray(w.msgs_sent) - np.asarray(want[2]))
        delivered += int((new_rows != got[0]).any(1).sum())
        want = [w.rows, w.tx_remaining, w.msgs_sent, w.hops, w.next_send,
                w.sent]
        got = [new_rows, tx2, msgs2, hops2, next2]
    assert delivered > 0  # or the case would prove nothing


def _sent_args_fields():
    """(name, ctypes type) of every field of csrc/sent_sampler.cu's
    ``SentArgs``, in order."""
    body = re.search(r"struct SentArgs \{(.*?)\n\};", SOURCE.read_text(),
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    scalars = {"int": ctypes.c_int, "float": ctypes.c_float,
               "uint32_t": ctypes.c_uint32}
    fields = []
    for decl in (" ".join(d.split()) for d in body.split(";")):
        if not decl:
            continue
        if "*" in decl:
            typ, names = decl.split("*", 1)
            fields += [(x.strip(), ctypes.c_void_p) for x in names.split(",")]
        else:
            typ, names = decl.split(" ", 1)
            fields += [(x.strip(), scalars[typ]) for x in names.split(",")]
    return fields


def test_args_mirror_the_kernel_struct():
    want = _sent_args_fields()
    assert len(want) >= 30  # the parse found the struct
    assert [(f, t) for f, t in ss._Args._fields_] == want
    # a block of any other layout would fail: a field moved breaks it
    moved = [want[1], want[0], *want[2:]]
    assert [(f, t) for f, t in ss._Args._fields_] != moved


def _calib_inputs(n=64, ticks=2):
    cfg = tc.ExactConfig(n_nodes=n, sender_chunk=24)
    state = tc.exact_init(cfg, device="cpu")
    key = convert.key_from_numpy(jax.random.PRNGKey(5))
    for _ in range(ticks):
        state = tc.exact_tick(state, key, cfg)
    return tc.exact_inputs(state, key, cfg)


def test_cpu_sent_tick_launches_no_kernel():
    counted = (ss.sent_select, ss.sent_commit)
    before = [f.launches for f in counted]
    select, commit = _calib_inputs()
    ss.sent_tick(**{**select, **commit})
    te.run_epidemic_seeds(te.sent_trace_cfg(48), n_seeds=2, device="cpu")
    assert [f.launches for f in counted] == before


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the call would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.run_exact(tc.ExactConfig(64), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        te.run_epidemic_seeds(te.sent_trace_cfg(48), n_seeds=2,
                              device="cuda")


def test_sent_tick_refuses_bad_arguments():
    select, commit = _calib_inputs()
    args = {**select, **commit}
    with pytest.raises(ValueError, match="next_send"):
        ss.sent_tick(**{**args, "next_send": None})
    with pytest.raises(ValueError, match="msgs"):
        ss.sent_tick(**{**args, "msgs": args["msgs"][:, :5]})
    with pytest.raises(ValueError, match="not both"):
        ss.sent_tick(**{**args, "rows": torch.zeros((1, 64, 2),
                                                    dtype=torch.int32)})
    with pytest.raises(ValueError, match="keys"):
        ss.sent_tick(**{**args, "keys": args["keys"][:, :1]})
