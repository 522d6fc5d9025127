"""Interop bridge (port of ``corrosion_tpu.bridge``): golden cr-sqlite
reference engine + speedy wire codec.

``speedy`` speaks the reference agent's speedy-encoded wire types (its
change-array loops and deframer in the native host module where it
builds, the Python twins otherwise), ``foca`` the SWIM datagram codec
over ``bincode``, and ``crsqlite_ref`` loads the real cr-sqlite
extension, where one is found, to validate the CRDT merge against it
(tests only; the agent never depends on it).
"""

from corrosion_tpu_torch.bridge import foca, speedy  # noqa: F401
from corrosion_tpu_torch.bridge.crsqlite_ref import (
    CrsqliteRef,
    crsqlite_available,
    find_crsqlite_so,
)

__all__ = [
    "CrsqliteRef",
    "crsqlite_available",
    "find_crsqlite_so",
    "foca",
    "speedy",
]
