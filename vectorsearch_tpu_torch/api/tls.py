"""TLS: configured certs or self-signed generation + periodic reload.

Mirrors the reference's TLS subsystem behaviour (config/config_tls.go:
33-56,125-174 and config_tls_path.go): if no certificate paths are
configured, generate a self-signed cert (ECDSA P-384; SANs auto-discovered
from hostname + local IPs plus any configured DNS/IP entries) and reload
certificates hourly. Reload is implemented with an SNI callback that swaps
in the freshest SSLContext, so the listener never restarts.
"""
from __future__ import annotations

import datetime
import os
import socket
import ssl
import tempfile
import threading

from ..logger import sugar

RELOAD_INTERVAL_S = 3600.0

try:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    HAVE_CRYPTO = True
except ImportError:  # pragma: no cover
    HAVE_CRYPTO = False


def _local_sans(extra_dns: list[str], extra_ips: list[str]):
    dns = {"localhost", socket.gethostname(), *extra_dns}
    ips = {"127.0.0.1", "::1", *extra_ips}
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None):
            ips.add(info[4][0])
    except OSError:
        pass
    return sorted(dns), sorted(ips)


def generate_self_signed(
    dns_names: list[str] | None = None,
    ip_addrs: list[str] | None = None,
    key_type: str = "ecdsa",
) -> tuple[bytes, bytes]:
    """Returns (cert_pem, key_pem). `key_type`: "ecdsa" (P-384, matching
    generateCertificateECDSA) or "rsa" (2048, matching
    generateCertificateRSA) — the reference self-signs BOTH and lets the
    TLS stack pick by client support (config/config_tls.go:125-174)."""
    if not HAVE_CRYPTO:
        raise RuntimeError("cryptography not available for self-signed certs")
    import ipaddress

    dns, ips = _local_sans(dns_names or [], ip_addrs or [])
    if key_type == "rsa":
        from cryptography.hazmat.primitives.asymmetric import rsa

        key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    else:
        key = ec.generate_private_key(ec.SECP384R1())
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "vectorsearch-tpu")]
    )
    san_entries: list[x509.GeneralName] = [x509.DNSName(d) for d in dns]
    for ip in ips:
        try:
            san_entries.append(x509.IPAddress(ipaddress.ip_address(ip.split("%")[0])))
        except ValueError:
            continue
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(x509.SubjectAlternativeName(san_entries), critical=False)
        .sign(key, hashes.SHA384())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    return cert_pem, key_pem


class TLSManager:
    """Builds SSL contexts from configured cert paths or a generated
    self-signed pair, and refreshes them on an hourly timer."""

    def __init__(self, tls_cfg, reload_interval: float = RELOAD_INTERVAL_S):
        self.cfg = tls_cfg
        self._lock = threading.Lock()
        self._ctx: ssl.SSLContext | None = None
        self._dir = tempfile.mkdtemp(prefix="vstpu-tls-")
        self._interval = reload_interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.reload()

    def _build_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        certs = self.cfg.certificates if self.cfg else []
        if certs:
            for pair in certs:
                ctx.load_cert_chain(pair["certificate"], pair["key"])
        else:
            # self-sign BOTH an ECDSA and an RSA pair like the reference
            # (config/config_tls.go:125-174): OpenSSL holds one cert per
            # key type in a context and serves whichever the client's
            # cipher suites support (RSA covers ancient clients). An RSA
            # generation failure degrades to ECDSA-only with a warning.
            for key_type in ("ecdsa", "rsa"):
                try:
                    cert_pem, key_pem = generate_self_signed(
                        self.cfg.domain_name_server if self.cfg else [],
                        self.cfg.ip if self.cfg else [],
                        key_type=key_type,
                    )
                except Exception as e:
                    if key_type == "ecdsa":
                        raise  # primary pair: reload() keeps the old ctx
                    sugar().warning("RSA self-signed generation failed: %s", e)
                    continue
                cert_path = os.path.join(self._dir, f"cert-{key_type}.pem")
                key_path = os.path.join(self._dir, f"key-{key_type}.pem")
                with open(cert_path, "wb") as f:
                    f.write(cert_pem)
                with open(key_path, "wb") as f:
                    f.write(key_pem)
                ctx.load_cert_chain(cert_path, key_path)
        # advertise h2 ahead of http/1.1 (reference: main.go:111 NextProtos);
        # the TLS listener ALPN-muxes in api/h2.py
        try:
            from .h2 import hpack_available

            if hpack_available():
                ctx.set_alpn_protocols(["h2", "http/1.1"])
            else:  # pragma: no cover - libnghttp2 is present in this image
                ctx.set_alpn_protocols(["http/1.1"])
        except Exception:
            pass
        return ctx

    def reload(self):
        try:
            ctx = self._build_context()
        except Exception as e:  # keep serving with the old cert
            sugar().error("TLS reload failed: %s", e)
            return
        with self._lock:
            self._ctx = ctx

    def context(self) -> ssl.SSLContext:
        """Context handed to the listener: serves the boot-time cert to
        non-SNI clients and the freshest cert via SNI callback after hourly
        reloads (the listener itself never restarts)."""
        with self._lock:
            outer = self._ctx

        def pick(sock, server_name, _ctx):
            with self._lock:
                newest = self._ctx
            if newest is not None and newest is not sock.context:
                sock.context = newest
            return None

        outer.sni_callback = pick
        return outer

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def _run(self):
        while not self._stop.wait(self._interval):
            sugar().info("reloading TLS certificates")
            self.reload()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1)
            self._thread = None
