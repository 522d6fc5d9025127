"""Test harness: boot complete real agents on loopback.

Parity: ``crates/corro-tests/src/lib.rs:13-95`` — ``launch_test_agent``
boots a full agent (gossip on 127.0.0.1:0, tempdir DB, schema applied)
so integration tests exercise real gossip, not mocks.

A copy of ``corrosion_tpu/agent/testing.py`` re-rooted on this package.
Its agents switch off the surfaces this package does not port yet
(``runtime.PORTED_ONLY``) and run on ``device`` (pass ``device="cpu"``
without a card); explicit overrides still win.
"""

from __future__ import annotations

import asyncio
import tempfile
from typing import List, Optional

from corrosion_tpu_torch.agent.runtime import PORTED_ONLY, Agent, AgentConfig

TEST_SCHEMA = """
CREATE TABLE IF NOT EXISTS tests (
  id INTEGER NOT NULL PRIMARY KEY,
  text TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS tests2 (
  id INTEGER NOT NULL PRIMARY KEY,
  text TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS testsblob (
  id BLOB NOT NULL PRIMARY KEY,
  text TEXT NOT NULL DEFAULT ''
);
"""


async def launch_test_agent(
    bootstrap: Optional[List[str]] = None,
    schema: str = TEST_SCHEMA,
    tmpdir: Optional[str] = None,
    fault_filter=None,
    **overrides,
) -> Agent:
    d = tmpdir or tempfile.mkdtemp(prefix="corro-test-")
    kwargs = dict(
        # fast timers for tests (explicit overrides win)
        probe_interval=0.1,
        probe_timeout=0.15,
        suspect_timeout=0.6,
        rebroadcast_delay=0.05,
        sync_interval_min=0.15,
        sync_interval_max=0.4,
        bcast_flush_interval=0.02,
        **PORTED_ONLY,
    )
    kwargs.update(overrides)
    cfg = AgentConfig(
        db_path=f"{d}/corrosion.db",
        bootstrap=bootstrap or [],
        schema_sql=schema,
        **kwargs,
    )
    agent = Agent(cfg)
    # the fault-injection hook must be live BEFORE start(): the boot
    # window (bootstrap announces, first probes) is part of the fault
    # model — a node restarting INTO an active partition or lossy link
    # must not get a fault-free head start
    if fault_filter is not None:
        agent.fault_filter = fault_filter
    await agent.start()
    return agent


def seed_full_membership(agents) -> None:
    """Give every agent a complete ALIVE member view of the others.

    Harness shortcut for large static-membership experiments (e.g. the
    sim-vs-agent calibration at N=256): the epidemic under measurement is
    the broadcast, and full membership is its precondition — SWIM's own
    dissemination is measured separately (BASELINE config #2)."""
    for a in agents:
        for b in agents:
            if a is b:
                continue
            a.members.upsert(b.actor_id, tuple(b.gossip_addr))


class CaptureWriter:
    """StreamWriter stand-in that collects written bytes — serve-path
    harnesses point ``_serve_need``/``_serve_sync`` at one of these and
    decode ``buf`` with ``speedy.FrameReader``."""

    def __init__(self):
        self.buf = bytearray()

    def write(self, b: bytes) -> None:
        self.buf += b

    async def drain(self) -> None:
        pass

    def close(self) -> None:
        pass


def make_offline_agent(
    tmpdir: Optional[str] = None,
    schema: str = TEST_SCHEMA,
    **overrides,
) -> Agent:
    """Build a full Agent WITHOUT starting its network loops: storage,
    bookkeeping, and the sync serve path all work (handle_change /
    _serve_need are loop-independent), so serve-side parity and bench
    harnesses can drive thousands of versions without paying gossip
    timers or socket setup.  Callers must ``agent.storage.close()`` (or
    use it inside asyncio.run and close after)."""
    d = tmpdir or tempfile.mkdtemp(prefix="corro-offline-")
    kwargs = dict(PORTED_ONLY)
    kwargs.update(overrides)
    cfg = AgentConfig(
        db_path=f"{d}/corrosion.db",
        schema_sql=schema,
        **kwargs,
    )
    return Agent(cfg)


async def wait_for(predicate, timeout: float = 10.0, interval: float = 0.05):
    """Poll until predicate() is truthy or raise TimeoutError."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        v = predicate()
        if v:
            return v
        if loop.time() > deadline:
            raise TimeoutError("condition not met in time")
        await asyncio.sleep(interval)
