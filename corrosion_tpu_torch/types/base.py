"""Version / sequence newtypes.

Parity: ``crates/corro-base-types/src/lib.rs:18,109,194`` defines ``Version``,
``CrsqlDbVersion`` and ``CrsqlSeq`` as u64 newtypes with successor/predecessor
("Step") support so they can key range maps.  Python ints are unbounded, so
the newtypes here are thin ``int`` subclasses that preserve type identity
through arithmetic used by the reference's range algebra
(``corrosion_tpu/utils/ranges.py``).
"""

from __future__ import annotations


class _U64(int):
    """An int constrained to the u64 domain (the wire format is u64)."""

    __slots__ = ()
    MAX = (1 << 64) - 1

    def __new__(cls, value: int = 0):
        if not 0 <= int(value) <= cls.MAX:
            raise ValueError(f"{cls.__name__} out of u64 range: {value!r}")
        return super().__new__(cls, value)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}({int(self)})"

    # Step/StepLite parity: successor & predecessor used by range maps.
    def succ(self):
        return type(self)(int(self) + 1)

    def pred(self):
        return type(self)(int(self) - 1)

    def __add__(self, other):
        return type(self)(int(self) + int(other))

    def __sub__(self, other):
        return type(self)(int(self) - int(other))


class Version(_U64):
    """A per-actor broadcast version (one committed local transaction)."""

    __slots__ = ()


class CrsqlDbVersion(_U64):
    """The storage engine's monotonically increasing db_version."""

    __slots__ = ()


class CrsqlSeq(_U64):
    """Sequence number of a single change row within one version."""

    __slots__ = ()
