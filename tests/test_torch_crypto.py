"""The port's Ed25519 (``corrosion_tpu_torch/types/crypto.py``) against
RFC 8032 §7.1 and against the reference's ``corrosion_tpu.types.crypto``:
keys and signatures byte-equal on seeded seeds and messages, tampered
messages, keys and signatures rejected by both."""

import hashlib

import numpy as np
import pytest

from corrosion_tpu.types import crypto as ref
from corrosion_tpu_torch.types import crypto

# (secret, public, message, signature) — RFC 8032 §7.1
RFC8032_VECTORS = [
    (  # TEST 1: empty message
        "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (  # TEST 2: one byte
        "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
    (  # TEST 3: two bytes
        "c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
        "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
        "af82",
        "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
        "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a",
    ),
    (  # TEST SHA(abc): ed25519 over a sha512 digest
        "833fe62409237b9d62ec77587520911e9a759cec1d19755b7da901b96dca3d42",
        "ec172b93ad5e563bf4932c70e1245034c35467ef2efd4d64ebf819683467e2bf",
        hashlib.sha512(b"abc").hexdigest(),
        "dc2a4459e7369633a52b1bf277839a00201009a3efbf3ecb69bea2186c26b589"
        "09351fc9ac90b3ecfdfbc7c66431e0303dca179c138ac17ad9bef1177331a704",
    ),
]


@pytest.mark.parametrize("sk,pk,msg,sig", RFC8032_VECTORS)
def test_rfc8032_vectors(sk, pk, msg, sig):
    sk, pk = bytes.fromhex(sk), bytes.fromhex(pk)
    msg, sig = bytes.fromhex(msg), bytes.fromhex(sig)
    assert crypto.public_key(sk) == pk
    assert crypto.sign(sk, msg) == sig
    assert crypto.verify(pk, msg, sig)
    assert crypto.verify_cached(pk, msg, sig)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keys_and_signatures_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        material = rng.integers(0, 256, int(rng.integers(1, 40))).astype(
            np.uint8).tobytes()
        sk, pk = crypto.seed_keypair(material)
        assert (sk, pk) == ref.seed_keypair(material)
        raw = rng.integers(0, 256, 32).astype(np.uint8).tobytes()
        assert crypto.public_key(raw) == ref.public_key(raw)
        msg = rng.integers(0, 256, int(rng.integers(0, 200))).astype(
            np.uint8).tobytes()
        sig = crypto.sign(sk, msg)
        assert sig == ref.sign(sk, msg)
        assert crypto.sign(raw, msg) == ref.sign(raw, msg)
        assert crypto.verify(pk, msg, sig) and ref.verify(pk, msg, sig)


@pytest.mark.parametrize("seed", [0, 1])
def test_tampering_rejected_as_by_reference(seed):
    rng = np.random.default_rng(seed)
    sk, pk = crypto.seed_keypair(b"tamper-%d" % seed)
    sk2, pk2 = crypto.seed_keypair(b"other-%d" % seed)
    msg = rng.integers(0, 256, 64).astype(np.uint8).tobytes()
    sig = crypto.sign(sk, msg)
    cases = []
    for i in rng.choice(len(msg), 4, replace=False):
        bad = bytearray(msg)
        bad[i] ^= 1 << int(rng.integers(8))
        cases.append((pk, bytes(bad), sig))
    for i in (0, 31, 32, 63, int(rng.integers(64))):
        bad = bytearray(sig)
        bad[i] ^= 0x01
        cases.append((pk, msg, bytes(bad)))
    out_of_range = bytearray(sig)
    out_of_range[32:] = crypto._L.to_bytes(32, "little")
    bad_r = bytearray(sig)
    bad_r[:32] = b"\x05" + b"\xff" * 31
    cases += [
        (pk2, msg, sig),  # wrong key
        (pk, msg, crypto.sign(sk2, msg)),  # the other key's signature
        (pk, msg, b""), (pk, msg, sig[:-1]), (pk, msg, sig + b"\x00"),
        (b"", msg, sig), (b"\xff" * 32, msg, sig),
        (pk, msg, bytes(out_of_range)), (pk, msg, bytes(bad_r)),
    ]
    for pub, m, s in cases:
        assert crypto.verify(pub, m, s) is False
        assert ref.verify(pub, m, s) is False
        assert crypto.verify_cached(pub, m, s) is False
    assert crypto.verify(pk, msg, sig) and crypto.verify_cached(pk, msg, sig)


def test_secret_length_enforced_as_by_reference():
    for fn in ("sign", "public_key"):
        for secret in (b"short", b"x" * 33):
            args = (secret, b"m") if fn == "sign" else (secret,)
            with pytest.raises(ValueError):
                getattr(crypto, fn)(*args)
            with pytest.raises(ValueError):
                getattr(ref, fn)(*args)
