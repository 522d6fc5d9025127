"""The subscription matcher's core, ``corrosion_tpu_torch/agent/
submatch.py``, against ``corrosion_tpu/agent/submatch.py`` on the CPU:
shard assignment, the inverted predicate index, the wave resolver
(the port's winner selection, ``backend="torch", device="cpu"`` and
``"auto"``, against the reference's NumPy twin) and the fan-out."""

from __future__ import annotations

import random

import pytest
import torch

from corrosion_tpu.agent import submatch as ref
from corrosion_tpu_torch.agent import submatch as port
from corrosion_tpu_torch.agent.pack import pack_values
from corrosion_tpu_torch.ops import merge
from corrosion_tpu_torch.types.base import CrsqlDbVersion, CrsqlSeq
from corrosion_tpu_torch.types.change import SENTINEL_CID, Change

ACTOR = b"\xab" * 16


@pytest.mark.parametrize("n_shards", [1, 4, 7])
def test_shard_of_equals_reference(n_shards):
    rng = random.Random(n_shards)
    ids = [f"s{i}" for i in range(500)] + [
        "".join(rng.choice("abcdefxyz-_0123456789é") for _ in range(
            rng.randint(0, 24))) for _ in range(500)]
    got = [port.shard_of(s, n_shards) for s in ids]
    assert got == [ref.shard_of(s, n_shards) for s in ids]
    assert set(got) == set(range(n_shards))


def index_state(index) -> tuple:
    return (index.specs.keys(), index._broad,
            {t: dict(per) for t, per in index._by_pk.items()})


def test_shard_index_equals_reference():
    """The same seeded run of adds (new ids, re-adds that move a sub,
    whole-table and pk-filtered specs over three tables) and removes
    (present and absent ids) on both indexes."""
    rng = random.Random(3)
    tables = ("tests", "users", "other")
    ours, theirs = port.ShardIndex(), ref.ShardIndex()
    pks = [pack_values([i]) for i in range(40)]
    for step in range(600):
        sid = f"s{rng.randrange(60)}"
        if rng.random() < 0.3:
            ours.remove(sid)
            theirs.remove(sid)
        else:
            table = rng.choice(tables)
            proj = tuple(rng.sample(range(3), rng.randint(1, 3)))
            filt = (None if rng.random() < 0.2 else
                    frozenset(rng.sample(pks, rng.randint(1, 6))))
            ours.add(port.SubSpec(sid, table, proj, filt))
            theirs.add(ref.SubSpec(sid, table, proj, filt))
        assert index_state(ours) == index_state(theirs), step
        for t in tables + ("absent",):
            assert ours.has(t) == theirs.has(t)
            assert ours.subs_on(t) == theirs.subs_on(t)
    for sid in list(ours.specs):
        ours.remove(sid)
        theirs.remove(sid)
    assert index_state(ours) == index_state(theirs) == (
        {}.keys(), {}, {})


def wave(seed: int, n: int, pk_space: int, cids=("a", "b", "c")) -> list:
    """One table's seeded wave: upserts of several columns, duplicates,
    deletes (even causal length) superseded by later resurrections, and
    the clocks of a stream already applied in part."""
    rng = random.Random(seed)
    cl, ver, out = {}, {}, []
    for seq in range(n):
        pk = rng.randrange(pk_space)
        r = rng.random()
        if r < 0.15:
            c = cl.get(pk, 1)
            cl[pk] = c + 1 if c % 2 else c
            cid, val, v = SENTINEL_CID, None, ver.get((pk, None), 1)
        elif r < 0.2:
            # an exact duplicate of an earlier change
            if out:
                out.append(rng.choice(out))
                continue
            cid, val, v = "a", 0, 1
        else:
            c = cl.get(pk, 1)
            if c % 2 == 0 and rng.random() < 0.7:
                c += 1  # resurrect
            cl[pk] = c
            cid = rng.choice(cids)
            v = ver.get((pk, cid), 0) + rng.choice((0, 1, 1, 2))
            ver[(pk, cid)] = v
            val = rng.choice((None, rng.randrange(9), f"v{seq}", b"\x01"))
        out.append(Change(table="tests", pk=pack_values([pk]), cid=cid,
                          val=val, col_version=v,
                          db_version=CrsqlDbVersion(1 + seq // 64),
                          seq=CrsqlSeq(seq), site_id=ACTOR, cl=cl.get(pk, 1)))
    return out


WAVES = [(seed, n, space) for seed, n, space in (
    (0, 1, 1), (1, 2, 1), (2, 17, 3), (3, 512, 40), (4, 512, 3333),
    (5, 1000, 7), (6, 4097, 300), (7, 5000, 1))]


@pytest.mark.parametrize("seed,n,space", WAVES)
def test_resolve_wave_equals_reference(seed, n, space):
    changes = wave(seed, n, space)
    want = ref.resolve_wave(changes, backend="numpy")
    assert port.resolve_wave(changes, backend="torch", device="cpu") == want
    assert port.resolve_wave(changes, backend="numpy") == want
    # below the auto threshold: the NumPy twin on any host
    assert port.resolve_wave(changes) == want


def test_resolve_wave_auto_takes_the_kernels_from_the_threshold(monkeypatch):
    """A wave of ``TORCH_AUTO_MIN`` changes or more: ``"auto"`` with
    ``device="cpu"`` goes through the torch winner selection, equal to
    the reference's NumPy twin."""
    changes = wave(11, merge.TORCH_AUTO_MIN + 3, 20_000)
    calls = []
    real = merge._winners_torch

    def spy(plan, device="cuda", plain=False):
        calls.append(torch.device(device).type)
        return real(plan, device, plain)

    monkeypatch.setattr(merge, "_winners_torch", spy)
    got = port.resolve_wave(changes, backend="auto", device="cpu")
    assert calls == ["cpu"]
    assert got == ref.resolve_wave(changes, backend="numpy")


@pytest.mark.parametrize("field,value", [("cl", 3.0), ("col_version", 2.5),
                                         ("cl", True)])
def test_resolve_wave_non_integer_clock_equals_reference(field, value):
    """A wave the winner selection cannot encode takes the reference's
    max-cl dict pass (a bool is an int and is encoded)."""
    changes = wave(9, 300, 25)
    i = len(changes) // 2
    fields = dict(changes[i].__dict__, **{field: value})
    changes[i] = Change(**fields)
    want = ref.resolve_wave(changes, backend="numpy")
    for backend in ("torch", "auto", "numpy"):
        assert port.resolve_wave(changes, backend=backend,
                                 device="cpu") == want


def test_resolve_wave_torch_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.resolve_wave(wave(2, 17, 3), backend="torch")


def test_resolve_wave_auto_without_a_card_answers_by_the_twin():
    """``"auto"`` from the threshold up with no device (the reference's
    call) answers on a host with no card as the reference does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: auto takes the kernels")
    changes = wave(12, merge.TORCH_AUTO_MIN, 30_000)
    assert port.resolve_wave(changes) == ref.resolve_wave(
        changes, backend="numpy")


def population(rng, n_subs: int, pk_space: int, table: str) -> list:
    specs = []
    for i in range(n_subs):
        filt = (None if i % 17 == 0 else frozenset(
            pack_values([rng.randrange(pk_space)])
            for _ in range(rng.randint(1, 8))))
        specs.append((f"{table}{i}", table, (0, 1), filt))
    return specs


@pytest.mark.parametrize("broad", [True, False])
def test_match_wave_equals_reference(broad):
    rng = random.Random(5 + broad)
    specs = population(rng, 300, 200, "tests") + population(
        rng, 40, 200, "users")
    if not broad:
        specs = [s for s in specs if s[3] is not None]
    ours, theirs = port.ShardIndex(), ref.ShardIndex()
    for s in specs:
        ours.add(port.SubSpec(*s))
        theirs.add(ref.SubSpec(*s))
    changes = wave(21, 700, 260)
    pks, alive = port.resolve_wave(changes, backend="torch", device="cpu")
    rows = {pk: (pk, f"row{i}") for i, (pk, a) in enumerate(zip(pks, alive))
            if a}
    fetched = []

    def fetch(need):
        fetched.append(list(need))
        return {pk: rows[pk] for pk in need if pk in rows}

    for table in ("tests", "users", "absent"):
        fetched.clear()
        got = port.match_wave(ours, table, pks, fetch)
        want = ref.match_wave(theirs, table, pks, fetch)
        assert got == want
        # one fetch a wave, of the same pks, where a sub is reached
        assert len(fetched) == (2 if got[1] else 0)
        assert fetched[:1] == fetched[1:]
    assert port.match_wave(ours, "tests", [], fetch) == ({}, 0)


def change_fields(c) -> tuple:
    return (c.table, c.pk, c.cid, c.val, c.col_version, int(c.db_version),
            int(c.seq), c.site_id, c.cl)


def test_chip_smoke_waves_are_the_references():
    """``chip_smoke.py`` phase 21 resolves the subscription bench's
    headline burst (bench.py's own waves) and a 131,072-change wave on
    the card; its constants are the reference's answers here, and the
    port's torch path on the CPU gives them too."""
    import bench
    import chip_smoke

    ours = chip_smoke.subs_waves(**chip_smoke.SUBS_HEADLINE)
    theirs = bench._subs_make_burst(random.Random(7), 10_000, 3_333, 512)
    assert [list(map(change_fields, w)) for w in ours] == [
        list(map(change_fields, w)) for _, w in theirs]
    for label, spec in (("resolve_wave(headline waves)",
                         chip_smoke.SUBS_HEADLINE),
                        ("resolve_wave(131,072 changes)",
                         chip_smoke.SUBS_WIDE)):
        waves = chip_smoke.subs_waves(**spec)
        want = [ref.resolve_wave(w, backend="numpy") for w in waves]
        assert chip_smoke.wave_summary(want, want) == (
            chip_smoke.HARNESS_WANT[label])
        assert [port.resolve_wave(w, backend="torch", device="cpu")
                for w in waves] == want
