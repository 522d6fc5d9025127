"""Decorrelated-jitter backoff.

Parity: ``crates/backoff`` — the iterator the reference's SWIM announcer
and sync scheduler use: each delay is drawn uniformly from
``[base, prev * 3]``, clamped to ``[base, cap]`` (decorrelated jitter),
optionally with a retry limit.
"""

from __future__ import annotations

import asyncio
import random
from typing import Callable, Iterator, Optional, Tuple, Type


class Backoff:
    def __init__(self, base: float = 0.1, cap: float = 15.0,
                 max_retries: Optional[int] = None,
                 rng: Optional[random.Random] = None):
        self.base = base
        self.cap = cap
        self.max_retries = max_retries
        self.rng = rng or random.Random()

    def __iter__(self) -> Iterator[float]:
        prev = self.base
        n = 0
        while self.max_retries is None or n < self.max_retries:
            delay = min(self.cap, self.rng.uniform(self.base, prev * 3))
            prev = delay
            n += 1
            yield delay

    def reset(self) -> "Backoff":
        return Backoff(self.base, self.cap, self.max_retries, self.rng)


async def retry(
    fn: Callable,
    backoff: Backoff,
    exceptions: Tuple[Type[BaseException], ...] = (
        OSError, ConnectionError, asyncio.TimeoutError,
    ),
    sleep: Callable = asyncio.sleep,
):
    """Call ``await fn()`` until it succeeds, sleeping the backoff's
    next delay after each retryable failure; re-raises the last failure
    once the delays are exhausted (``max_retries`` bounds the RETRIES:
    the first attempt is free, so ``max_retries=2`` means ≤3 attempts).

    Deterministic path: give ``backoff`` a seeded ``random.Random`` —
    delays are drawn only from that rng, in attempt order, so a replay
    with the same seed and the same failure sequence sleeps the same
    schedule.  ``sleep`` is injectable so tests (and the det scheduler)
    can collect the delays instead of waiting them out.
    """
    delays = iter(backoff)
    while True:
        try:
            return await fn()
        except exceptions:
            # NOTE: StopIteration must not escape a coroutine (PEP 479
            # turns it into RuntimeError) — exhausted delays re-raise
            # the ORIGINAL failure instead
            delay = next(delays, None)
            if delay is None:
                raise
            await sleep(delay)
