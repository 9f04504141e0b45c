"""Encryption at rest (the ee/enc role).

The reference loads an AES key file and hands it to Badger for
block-level encryption (ee/enc/util_ee.go:24). Here the unit of
encryption is the durable blob: WAL record payloads, snapshot files,
and backup files are AES-128/192/256-GCM sealed per blob with a random
nonce. Key files are raw 16/24/32-byte keys, exactly like the
reference's --encryption_key_file.

Port of `dgraph_tpu/storage/enc.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

from typing import Optional

_MAGIC = b"DGTENC1\x00"


def load_key(path: str) -> bytes:
    with open(path, "rb") as f:
        key = f.read()
    if len(key) not in (16, 24, 32):
        raise ValueError(
            f"encryption key must be 16/24/32 bytes, got {len(key)} "
            "(ref ee/enc/util_ee.go ReadEncryptionKeyFile)")
    return key


def _aesgcm(key: bytes):
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    return AESGCM(key)


def encrypt_blob(blob: bytes, key: Optional[bytes]) -> bytes:
    if key is None:
        return blob
    import os
    nonce = os.urandom(12)
    return _MAGIC + nonce + _aesgcm(key).encrypt(nonce, blob, b"")


def decrypt_blob(blob: bytes, key: Optional[bytes]) -> bytes:
    if not blob.startswith(_MAGIC):
        if key is not None:
            raise ValueError("store is not encrypted but a key was given")
        return blob
    if key is None:
        raise ValueError("store is encrypted; --encryption_key_file needed")
    nonce = blob[len(_MAGIC): len(_MAGIC) + 12]
    return _aesgcm(key).decrypt(nonce, blob[len(_MAGIC) + 12:], b"")


def is_encrypted(blob: bytes) -> bool:
    return blob.startswith(_MAGIC)
