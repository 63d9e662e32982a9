"""Chain hash function: SHA3-256 (reference: src/core/hash.rs:25-33).

A copy of `bazuka_tpu/core/hash.py`."""

from __future__ import annotations

import hashlib


class Sha3Hasher:
    """Hash trait instance: 32-byte SHA3-256 output."""

    OUTPUT_LEN = 32

    @staticmethod
    def hash(data: bytes) -> bytes:
        return hashlib.sha3_256(data).digest()


def sha3_256(data: bytes) -> bytes:
    return hashlib.sha3_256(data).digest()
