"""TLS: certificate generation + server wrapping.

The reference's `dgraph cert` (dgraph/cmd/cert/) creates a self-signed
CA and issues node/client certs into a tls dir; alpha serves HTTPS and
mTLS from it (x/tls_helper.go). Same layout here:

    tls/ca.crt  ca.key        root CA (key stays offline)
    tls/node.crt node.key     server pair, SANs for the node hosts
    tls/client.<name>.crt/.key client pairs (for mTLS)

Port of `dgraph_tpu/server/tls.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import datetime
import os
import ssl

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

_CA_CRT = "ca.crt"
_CA_KEY = "ca.key"


def _write_key(path: str, key):
    with open(path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
    os.chmod(path, 0o600)


def _write_cert(path: str, cert):
    with open(path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))


def _name(cn: str):
    return x509.Name([
        x509.NameAttribute(NameOID.ORGANIZATION_NAME, "dgraph-tpu"),
        x509.NameAttribute(NameOID.COMMON_NAME, cn)])


def create_ca(tls_dir: str, days: int = 365 * 5) -> None:
    """Self-signed root CA (ref cert/create.go createCAPair)."""
    os.makedirs(tls_dir, exist_ok=True)
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(_name("dgraph-tpu Root CA"))
            .issuer_name(_name("dgraph-tpu Root CA"))
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                           critical=True)
            .sign(key, hashes.SHA256()))
    _write_key(os.path.join(tls_dir, _CA_KEY), key)
    _write_cert(os.path.join(tls_dir, _CA_CRT), cert)


def _load_ca(tls_dir: str):
    with open(os.path.join(tls_dir, _CA_KEY), "rb") as f:
        key = serialization.load_pem_private_key(f.read(), None)
    with open(os.path.join(tls_dir, _CA_CRT), "rb") as f:
        cert = x509.load_pem_x509_certificate(f.read())
    return key, cert


def create_pair(tls_dir: str, kind: str, name: str = "",
                hosts: tuple[str, ...] = ("localhost", "127.0.0.1"),
                days: int = 365 * 2) -> tuple[str, str]:
    """Issue a node or client pair signed by the dir's CA
    (ref cert/create.go createNodePair/createClientPair).
    -> (cert_path, key_path)."""
    ca_key, ca_cert = _load_ca(tls_dir)
    key = ec.generate_private_key(ec.SECP256R1())
    cn = name or ("node" if kind == "node" else "client")
    now = datetime.datetime.now(datetime.timezone.utc)
    builder = (x509.CertificateBuilder()
               .subject_name(_name(cn))
               .issuer_name(ca_cert.subject)
               .public_key(key.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now)
               .not_valid_after(now + datetime.timedelta(days=days))
               .add_extension(
                   x509.BasicConstraints(ca=False, path_length=None),
                   critical=True))
    if kind == "node":
        import ipaddress
        sans = []
        for h in hosts:
            try:
                sans.append(x509.IPAddress(ipaddress.ip_address(h)))
            except ValueError:
                sans.append(x509.DNSName(h))
        builder = builder.add_extension(
            x509.SubjectAlternativeName(sans), critical=False)
        base = "node"
    else:
        base = f"client.{cn}"
    cert = builder.sign(ca_key, hashes.SHA256())
    crt = os.path.join(tls_dir, f"{base}.crt")
    keyp = os.path.join(tls_dir, f"{base}.key")
    _write_cert(crt, cert)
    _write_key(keyp, key)
    return crt, keyp


def describe(tls_dir: str) -> list[dict]:
    """`cert ls` — inventory of the tls dir (ref cert/info.go)."""
    out = []
    if not os.path.isdir(tls_dir):
        return out
    for fn in sorted(os.listdir(tls_dir)):
        if not fn.endswith(".crt"):
            continue
        with open(os.path.join(tls_dir, fn), "rb") as f:
            cert = x509.load_pem_x509_certificate(f.read())
        out.append({
            "file": fn,
            "subject": cert.subject.rfc4514_string(),
            "issuer": cert.issuer.rfc4514_string(),
            "not_after": cert.not_valid_after_utc.isoformat(),
            "serial": format(cert.serial_number, "x"),
        })
    return out


def server_context(tls_dir: str, require_client_cert: bool = False
                   ) -> ssl.SSLContext:
    """SSLContext for the alpha HTTP server (x/tls_helper.go
    GenerateServerTLSConfig; require_client_cert = mTLS REQUIREANDVERIFY)."""
    node_crt = os.path.join(tls_dir, "node.crt")
    if not os.path.exists(node_crt):
        raise FileNotFoundError(
            f"no node certificate in {tls_dir!r} — run "
            f"`dgraph-tpu cert create --dir {tls_dir}` first")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(node_crt, os.path.join(tls_dir, "node.key"))
    if require_client_cert:
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(os.path.join(tls_dir, _CA_CRT))
    return ctx


def client_context(tls_dir: str, client_name: str = ""
                   ) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(os.path.join(tls_dir, _CA_CRT))
    ctx.check_hostname = False  # SANs cover localhost/127.0.0.1
    if client_name:
        ctx.load_cert_chain(
            os.path.join(tls_dir, f"client.{client_name}.crt"),
            os.path.join(tls_dir, f"client.{client_name}.key"))
    return ctx
