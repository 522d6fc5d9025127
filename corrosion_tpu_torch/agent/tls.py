"""TLS for the gossip/sync streams + certificate tooling.

Parity: the reference runs all gossip over QUIC with rustls — server
certs, optional mTLS client-cert auth, and a ``corrosion tls`` CLI that
generates a CA and signs server/client certs
(``crates/corrosion/src/main.rs:707-760``, ``api/peer.rs:128-318``
gossip_server_endpoint/client config).

Ours wraps the existing TCP uni/bi streams in ``ssl.SSLContext``
(python's rustls): when ``tls_cert_file`` is set the agent's gossip TCP
listener serves TLS, outbound stream connects use TLS, and
``tls_client_required`` enforces mutual auth.  SWIM datagrams stay
plaintext UDP (no DTLS in the stdlib) — they carry membership liveness,
not data; the reference's equivalent protection comes from QUIC which we
deliberately do not reimplement.  Plaintext remains the default.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
from typing import List, Optional, Tuple


# -- certificate generation (corrosion tls ... generate parity) --------


def _write_pair(dir_path: str, stem: str, cert_pem: bytes,
                key_pem: bytes) -> Tuple[str, str]:
    os.makedirs(dir_path, exist_ok=True)
    cert_path = os.path.join(dir_path, f"{stem}.crt")
    key_path = os.path.join(dir_path, f"{stem}.key")
    with open(cert_path, "wb") as f:
        f.write(cert_pem)
    with open(key_path, "wb") as f:
        f.write(key_pem)
    os.chmod(key_path, 0o600)
    return cert_path, key_path


def _new_key():
    from cryptography.hazmat.primitives.asymmetric import ec

    return ec.generate_private_key(ec.SECP256R1())


def _key_pem(key) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )


def _name(common: str):
    from cryptography import x509
    from cryptography.x509.oid import NameOID

    return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common)])


def _build(subject, issuer, pub, signer, days: int, *, ca: bool,
           sans: Optional[List[str]] = None, client: bool = False):
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes

    now = datetime.datetime.now(datetime.timezone.utc)
    b = (
        x509.CertificateBuilder()
        .subject_name(subject)
        .issuer_name(issuer)
        .public_key(pub)
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=ca, path_length=None),
                       critical=True)
    )
    if sans:
        alt = []
        for s in sans:
            try:
                alt.append(x509.IPAddress(ipaddress.ip_address(s)))
            except ValueError:
                alt.append(x509.DNSName(s))
        b = b.add_extension(x509.SubjectAlternativeName(alt), critical=False)
    if not ca:
        from cryptography.x509.oid import ExtendedKeyUsageOID

        # server certs carry BOTH usages: in a gossip mesh every node is
        # simultaneously server and mTLS client on its peers' listeners
        usages = ([ExtendedKeyUsageOID.CLIENT_AUTH] if client else
                  [ExtendedKeyUsageOID.SERVER_AUTH,
                   ExtendedKeyUsageOID.CLIENT_AUTH])
        b = b.add_extension(x509.ExtendedKeyUsage(usages), critical=False)
    return b.sign(signer, hashes.SHA256())


def generate_ca(dir_path: str, days: int = 3650) -> Tuple[str, str]:
    """``corrosion tls ca generate``: self-signed CA key + cert."""
    from cryptography.hazmat.primitives import serialization

    key = _new_key()
    name = _name("corrosion-tpu CA")
    cert = _build(name, name, key.public_key(), key, days, ca=True)
    return _write_pair(
        dir_path, "ca",
        cert.public_bytes(serialization.Encoding.PEM), _key_pem(key),
    )


def _load_ca(ca_cert: str, ca_key: str):
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization

    with open(ca_cert, "rb") as f:
        cert = x509.load_pem_x509_certificate(f.read())
    with open(ca_key, "rb") as f:
        key = serialization.load_pem_private_key(f.read(), password=None)
    return cert, key


def generate_server_cert(dir_path: str, ca_cert: str, ca_key: str,
                         sans: List[str], days: int = 365) -> Tuple[str, str]:
    """``corrosion tls server generate``: CA-signed cert for the gossip
    addresses in ``sans`` (IPs or DNS names)."""
    from cryptography.hazmat.primitives import serialization

    ca, cakey = _load_ca(ca_cert, ca_key)
    key = _new_key()
    cert = _build(
        _name(sans[0] if sans else "corrosion-tpu server"),
        ca.subject, key.public_key(), cakey, days, ca=False, sans=sans,
    )
    return _write_pair(
        dir_path, "server",
        cert.public_bytes(serialization.Encoding.PEM), _key_pem(key),
    )


def generate_client_cert(dir_path: str, ca_cert: str, ca_key: str,
                         common_name: str = "corrosion-tpu client",
                         days: int = 365) -> Tuple[str, str]:
    """``corrosion tls client generate``: CA-signed client-auth cert."""
    from cryptography.hazmat.primitives import serialization

    ca, cakey = _load_ca(ca_cert, ca_key)
    key = _new_key()
    cert = _build(
        _name(common_name), ca.subject, key.public_key(), cakey, days,
        ca=False, client=True,
    )
    return _write_pair(
        dir_path, "client",
        cert.public_bytes(serialization.Encoding.PEM), _key_pem(key),
    )


# -- ssl contexts ------------------------------------------------------


def server_context(cert_file: str, key_file: str,
                   ca_file: Optional[str] = None,
                   require_client: bool = False) -> ssl.SSLContext:
    """Gossip-listener context; with ``require_client`` peers must
    present a cert signed by ``ca_file`` (mTLS)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_3
    ctx.load_cert_chain(cert_file, key_file)
    if require_client:
        if not ca_file:
            raise ValueError("tls_client_required needs tls_ca_file")
        ctx.load_verify_locations(ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(ca_file: Optional[str] = None,
                   cert_file: Optional[str] = None,
                   key_file: Optional[str] = None,
                   insecure: bool = False) -> ssl.SSLContext:
    """Outbound-stream context.  ``insecure`` skips server verification
    (the reference's ``insecure = true`` knob); gossip peers are
    addressed by IP, so hostname checking is off and trust comes from
    the CA signature alone, like the reference's SkipServerVerification/
    CA-only rustls verifier."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_3
    ctx.check_hostname = False
    if insecure:
        ctx.verify_mode = ssl.CERT_NONE
    else:
        if not ca_file:
            # never silently skip verification: an operator who wants
            # unauthenticated TLS must say insecure explicitly
            raise ValueError("TLS without tls_ca_file requires "
                             "tls_insecure = true")
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(ca_file)
    if cert_file:
        ctx.load_cert_chain(cert_file, key_file)
    return ctx


def contexts_from_config(cfg) -> Tuple[Optional[ssl.SSLContext],
                                       Optional[ssl.SSLContext]]:
    """(server_ctx, client_ctx) from AgentConfig tls_* fields; (None,
    None) when TLS is off."""
    if not cfg.tls_cert_file:
        return None, None
    srv = server_context(
        cfg.tls_cert_file, cfg.tls_key_file, cfg.tls_ca_file,
        require_client=cfg.tls_client_required,
    )
    # the client cert/key must be chosen as a PAIR: mixing a dedicated
    # client cert with the server's key fails load_cert_chain
    if cfg.tls_client_cert_file:
        cli_cert, cli_key = cfg.tls_client_cert_file, cfg.tls_client_key_file
    elif cfg.tls_client_required:
        cli_cert, cli_key = cfg.tls_cert_file, cfg.tls_key_file
    else:
        cli_cert = cli_key = None
    cli = client_context(
        cfg.tls_ca_file, cli_cert, cli_key, insecure=cfg.tls_insecure,
    )
    return srv, cli
