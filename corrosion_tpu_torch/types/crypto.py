"""Dependency-free Ed25519 (RFC 8032) for signed changeset attribution.

The equivocation defense (docs/faults.md) needs cryptographic actor
identity: a quarantine verdict is only safe to make PERMANENT when the
evidence could not have been forged by a hostile relay.  The container
deliberately carries no crypto wheels (``cryptography`` is absent — see
``agent/tls.py``), so this module implements Ed25519 from the RFC 8032
reference equations in pure Python:

* curve: twisted Edwards ``-x^2 + y^2 = 1 + d x^2 y^2`` over
  ``p = 2^255 - 19``, base point order
  ``L = 2^252 + 27742317777372353535851937790883648493``;
* points in extended homogeneous coordinates ``(X, Y, Z, T)`` with the
  RFC's unified add/double formulas;
* keys/signatures in the standard 32/64-byte encodings, hashes via
  ``hashlib.sha512`` — byte-compatible with every other Ed25519
  implementation (pinned by the RFC 8032 §7.1 test vectors in
  ``tests/test_crypto.py``).

Performance posture: signing uses a precomputed table of base-point
doubles (~0.5 ms/sign on this container); verification is a plain
double-and-add over the decompressed public key (~2 ms).  That is far
too slow for per-message use — which is exactly why the ingest path
verifies on EVIDENCE only (digest conflicts, span-screen trips, and a
rate+interval-bounded spot check; see ``agent/runtime.py``).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

__all__ = [
    "SECRET_LEN", "PUBKEY_LEN", "SIG_LEN",
    "public_key", "sign", "verify", "verify_cached", "seed_keypair",
]

SECRET_LEN = 32
PUBKEY_LEN = 32
SIG_LEN = 64

_P = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493
_D = (-121665 * pow(121666, _P - 2, _P)) % _P
# sqrt(-1) mod p, used by point decompression
_SQRT_M1 = pow(2, (_P - 1) // 4, _P)

Point = Tuple[int, int, int, int]  # extended coords (X, Y, Z, T)

_IDENT: Point = (0, 1, 1, 0)


def _pt_add(a: Point, b: Point) -> Point:
    """RFC 8032 §5.1.4 unified addition (complete on the twisted
    Edwards curve: no exceptional cases to screen)."""
    x1, y1, z1, t1 = a
    x2, y2, z2, t2 = b
    p = _P
    A = ((y1 - x1) * (y2 - x2)) % p
    B = ((y1 + x1) * (y2 + x2)) % p
    C = (2 * t1 * t2 * _D) % p
    D = (2 * z1 * z2) % p
    E = B - A
    F = D - C
    G = D + C
    H = B + A
    return ((E * F) % p, (G * H) % p, (F * G) % p, (E * H) % p)


def _pt_double(a: Point) -> Point:
    """Dedicated doubling (dbl-2008-hwcd, a = -1): 4M + 4S vs the
    unified add's ~9M — doubles dominate the arbitrary-point scalar
    mult that verification pays, so this roughly halves verify time."""
    x1, y1, z1, _t1 = a
    p = _P
    A = (x1 * x1) % p
    B = (y1 * y1) % p
    C = (2 * z1 * z1) % p
    H = A + B
    xy = x1 + y1
    E = H - (xy * xy) % p
    G = A - B
    F = C + G
    return ((E * F) % p, (G * H) % p, (F * G) % p, (E * H) % p)


def _pt_eq(a: Point, b: Point) -> bool:
    # cross-multiply out the projective Z
    return ((a[0] * b[2] - b[0] * a[2]) % _P == 0
            and (a[1] * b[2] - b[1] * a[2]) % _P == 0)


def _recover_x(y: int, sign: int) -> Optional[int]:
    if y >= _P:
        return None
    x2 = ((y * y - 1) * pow(_D * y * y + 1, _P - 2, _P)) % _P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (_P + 3) // 8, _P)
    if (x * x - x2) % _P != 0:
        x = (x * _SQRT_M1) % _P
    if (x * x - x2) % _P != 0:
        return None
    if x & 1 != sign:
        x = _P - x
    return x


# base point: y = 4/5, x recovered even
_G_Y = (4 * pow(5, _P - 2, _P)) % _P
_G_X = _recover_x(_G_Y, 0)
assert _G_X is not None
_G: Point = (_G_X, _G_Y, 1, (_G_X * _G_Y) % _P)

# precomputed doubles of the base point: scalar mult of G becomes a
# pure add-chain over this table (no doublings per sign)
_G_DOUBLES: List[Point] = []
_acc = _G
for _ in range(256):  # clamped secrets set bit 254; spare headroom
    _G_DOUBLES.append(_acc)
    _acc = _pt_double(_acc)
del _acc


def _scalar_mul_base(s: int) -> Point:
    q = _IDENT
    i = 0
    while s:
        if s & 1:
            q = _pt_add(q, _G_DOUBLES[i])
        s >>= 1
        i += 1
    return q


def _scalar_mul(s: int, a: Point) -> Point:
    q = _IDENT
    while s:
        if s & 1:
            q = _pt_add(q, a)
        a = _pt_double(a)
        s >>= 1
    return q


def _compress(a: Point) -> bytes:
    zinv = pow(a[2], _P - 2, _P)
    x = (a[0] * zinv) % _P
    y = (a[1] * zinv) % _P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _decompress(data: bytes) -> Optional[Point]:
    if len(data) != 32:
        return None
    n = int.from_bytes(data, "little")
    sign = n >> 255
    y = n & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, (x * y) % _P)


def _sha512_int(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little")


def _expand_secret(secret: bytes) -> Tuple[int, bytes]:
    if len(secret) != SECRET_LEN:
        raise ValueError(f"Ed25519 secret must be {SECRET_LEN} bytes")
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


# pubkey memo: deriving A = aB is a full scalar mult (~ms in pure
# Python) and both signing and agent construction re-ask it for the
# same secret constantly (a 512-node signed campaign re-derives its
# whole identity set per determinism run)
_PUB_CACHE: dict = {}


def public_key(secret: bytes) -> bytes:
    """32-byte public key for a 32-byte secret seed (memoized)."""
    secret = bytes(secret)
    pub = _PUB_CACHE.get(secret)
    if pub is None:
        a, _prefix = _expand_secret(secret)
        pub = _compress(_scalar_mul_base(a))
        if len(_PUB_CACHE) >= 4096:
            _PUB_CACHE.pop(next(iter(_PUB_CACHE)))
        _PUB_CACHE[secret] = pub
    return pub


def sign(secret: bytes, msg: bytes) -> bytes:
    """64-byte RFC 8032 signature of ``msg`` under ``secret``."""
    a, prefix = _expand_secret(secret)
    pub = public_key(secret)
    r = _sha512_int(prefix, msg) % _L
    big_r = _compress(_scalar_mul_base(r))
    k = _sha512_int(big_r, pub, msg) % _L
    s = (r + k * a) % _L
    return big_r + int.to_bytes(s, 32, "little")


# decompressed-pubkey memo: point decompression costs a field
# exponentiation, and verifiers re-see the same few directory keys
_PUB_POINT_CACHE: dict = {}


def _pub_point(pub: bytes) -> Optional[Point]:
    pt = _PUB_POINT_CACHE.get(pub)
    if pt is None and pub not in _PUB_POINT_CACHE:
        pt = _decompress(pub)
        if len(_PUB_POINT_CACHE) >= 4096:
            _PUB_POINT_CACHE.pop(next(iter(_PUB_POINT_CACHE)))
        _PUB_POINT_CACHE[bytes(pub)] = pt
    return pt


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """True iff ``sig`` is a valid signature of ``msg`` under ``pub``.
    Malformed keys/signatures return False, never raise."""
    try:
        if len(sig) != SIG_LEN or len(pub) != PUBKEY_LEN:
            return False
        a_pt = _pub_point(pub)
        r_pt = _decompress(sig[:32])
        if a_pt is None or r_pt is None:
            return False
        s = int.from_bytes(sig[32:], "little")
        if s >= _L:
            return False
        k = _sha512_int(sig[:32], pub, msg) % _L
        return _pt_eq(
            _scalar_mul_base(s), _pt_add(r_pt, _scalar_mul(k, a_pt))
        )
    except Exception:  # noqa: BLE001 - a verifier must never raise
        return False


# process-wide memo of verification outcomes: verify() is a pure
# function of (pub, msg, sig), and the places that call it at scale —
# a tampered wave fanning out to hundreds of in-process virtual
# agents, or broadcast duplicates re-presenting one signed statement —
# re-ask the same triple over and over.  Bounded FIFO; ~2 ms saved per
# hit on this container.
_VERIFY_CACHE: dict = {}
_VERIFY_CACHE_MAX = 4096


def verify_cached(pub: bytes, msg: bytes, sig: bytes) -> bool:
    key = hashlib.blake2b(
        len(pub).to_bytes(2, "big") + pub
        + len(sig).to_bytes(2, "big") + sig + msg,
        digest_size=16,
    ).digest()
    hit = _VERIFY_CACHE.get(key)
    if hit is not None:
        return hit
    ok = verify(pub, msg, sig)
    if len(_VERIFY_CACHE) >= _VERIFY_CACHE_MAX:
        _VERIFY_CACHE.pop(next(iter(_VERIFY_CACHE)))
    _VERIFY_CACHE[key] = ok
    return ok


_KEYPAIR_CACHE: dict = {}


def seed_keypair(material: bytes) -> Tuple[bytes, bytes]:
    """``(secret, public)`` deterministically derived from arbitrary
    seed material (the campaign path: a harness-private secret per
    node).  The secret is a blake2b KDF of the material — NOT derivable
    from the public actor id alone, or a relay could re-sign tampered
    contents and the attribution would prove nothing.  Memoized (pure
    function; a 512-node signed campaign derives its whole key
    directory in one pass and re-derives it per determinism run)."""
    pair = _KEYPAIR_CACHE.get(material)
    if pair is None:
        secret = hashlib.blake2b(
            material, digest_size=SECRET_LEN, person=b"corro-sig-kdf"
        ).digest()
        pair = (secret, public_key(secret))
        if len(_KEYPAIR_CACHE) >= 4096:
            _KEYPAIR_CACHE.pop(next(iter(_KEYPAIR_CACHE)))
        _KEYPAIR_CACHE[bytes(material)] = pair
    return pair
