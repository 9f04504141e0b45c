"""Backup URI handlers (ref ee/backup/handler.go:159 NewUriHandler).

The reference dispatches backup destinations on URI scheme: bare paths
and file:// go to fileHandler, s3:// and minio:// to s3Handler (a minio
client). This build speaks the S3 REST protocol directly over
http.client with AWS Signature V4 (no SDK dependency):

  s3://bucket/prefix            AWS endpoint (or $AWS_ENDPOINT)
  minio://host:port/bucket/pfx  explicit endpoint, http by default,
                                ?secure=true for TLS (ref s3_handler.go)

Credentials come from the environment like the reference:
AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY (unsigned anonymous requests
when unset, matching minio's public-bucket mode).

Port of `dgraph_tpu/storage/uri.py`: a copy, its imports pointed
at this package.
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import os
from datetime import datetime, timezone
from typing import Optional
from urllib.parse import quote, urlparse


class UriHandler:
    """get/put objects under one backup destination."""

    def get(self, name: str) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, name: str, data: bytes) -> None:
        raise NotImplementedError


class FileHandler(UriHandler):
    def __init__(self, dirpath: str):
        self.dir = dirpath

    def get(self, name: str) -> Optional[bytes]:
        path = os.path.join(self.dir, name)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def put(self, name: str, data: bytes) -> None:
        os.makedirs(self.dir, exist_ok=True)
        tmp = os.path.join(self.dir, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(self.dir, name))


def _sigv4(method: str, host: str, uri: str, payload: bytes,
           access: str, secret: str, region: str) -> dict:
    """Minimal AWS Signature Version 4 for S3 path-style requests."""
    now = datetime.now(timezone.utc)
    amzdate = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(payload).hexdigest()
    headers = {"host": host, "x-amz-content-sha256": payload_hash,
               "x-amz-date": amzdate}
    signed = ";".join(sorted(headers))
    canonical = "\n".join([
        method, uri, "",
        "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
        signed, payload_hash])
    scope = f"{datestamp}/{region}/s3/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amzdate, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])
    key = f"AWS4{secret}".encode()
    for part in (datestamp, region, "s3", "aws4_request"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    sig = hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}")
    del headers["host"]  # http.client sets it
    return headers


class S3Handler(UriHandler):
    """Path-style S3 REST client (ref ee/backup/s3_handler.go)."""

    def __init__(self, endpoint: str, secure: bool, bucket: str,
                 prefix: str):
        self.endpoint = endpoint
        self.secure = secure
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.access = os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self.region = os.environ.get("AWS_DEFAULT_REGION", "us-east-1")

    def _conn(self) -> http.client.HTTPConnection:
        cls = http.client.HTTPSConnection if self.secure \
            else http.client.HTTPConnection
        return cls(self.endpoint, timeout=30)

    def _request(self, method: str, name: str,
                 payload: bytes = b"") -> tuple[int, bytes]:
        key = f"{self.prefix}/{name}" if self.prefix else name
        uri = "/" + quote(f"{self.bucket}/{key}")
        headers = {}
        if self.access and self.secret:
            headers = _sigv4(method, self.endpoint, uri, payload,
                             self.access, self.secret, self.region)
        conn = self._conn()
        try:
            conn.request(method, uri, body=payload or None,
                         headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def get(self, name: str) -> Optional[bytes]:
        status, body = self._request("GET", name)
        if status == 404:
            return None
        if status != 200:
            raise IOError(
                f"s3 GET {name!r} failed: {status} {body[:200]!r}")
        return body

    def put(self, name: str, data: bytes) -> None:
        status, body = self._request("PUT", name, data)
        if status not in (200, 201, 204):
            raise IOError(
                f"s3 PUT {name!r} failed: {status} {body[:200]!r}")


def new_uri_handler(dest: str) -> UriHandler:
    """Scheme dispatch (ref handler.go:159 NewUriHandler)."""
    u = urlparse(dest)
    if u.scheme in ("", "file"):
        return FileHandler(u.path or dest)
    if u.scheme in ("s3", "minio"):
        secure = "secure=true" in (u.query or "") or u.scheme == "s3"
        if u.scheme == "minio":
            endpoint = u.netloc
            parts = (u.path or "/").strip("/").split("/", 1)
            bucket = parts[0]
            prefix = parts[1] if len(parts) > 1 else ""
            if "secure=true" not in (u.query or ""):
                secure = False
        else:
            endpoint = os.environ.get("AWS_ENDPOINT",
                                      "s3.amazonaws.com")
            bucket = u.netloc
            prefix = (u.path or "").strip("/")
        if not bucket:
            raise ValueError(f"backup URI {dest!r} has no bucket")
        return S3Handler(endpoint, secure, bucket, prefix)
    raise ValueError(f"unknown backup URI scheme {u.scheme!r}")
