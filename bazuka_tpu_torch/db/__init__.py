"""String-keyed blob store with copy-on-write mirrors: the in-memory part
of `bazuka_tpu/db/__init__.py` (the JAX package's sqlite3 `DiskKvStore`
is not ported yet).

The persistence model (reference: src/db/mod.rs):
  * `KvStore`: get / update(batch of WriteOps) / pairs(prefix) / mirror
  * `RamKvStore`: in-memory sorted map
  * `RamMirrorKvStore`: overlay fork used pervasively for speculative
    execution + rollback (reference: src/db/mod.rs:326-385)

Values are raw `bytes`; the schema lives in `keys.py` and the typed
codecs in the layers above.  `checksum` digests the sorted pairs for
state audit (reference: src/db/mod.rs:307-312).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple


class KvStoreError(Exception):
    pass


@dataclass(frozen=True)
class Put:
    key: str
    value: bytes


@dataclass(frozen=True)
class Remove:
    key: str


WriteOp = object  # Put | Remove


class KvStore:
    """Abstract string-keyed blob store."""

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def update(self, ops: Iterable[WriteOp]) -> None:
        raise NotImplementedError

    def pairs(self, prefix: str = "") -> List[Tuple[str, bytes]]:
        """All (key, value) with key.startswith(prefix), sorted by key."""
        raise NotImplementedError

    def mirror(self) -> "RamMirrorKvStore":
        return RamMirrorKvStore(self)

    def checksum(self) -> bytes:
        """SHA3-256 over the sorted pairs (deterministic state audit)."""
        h = hashlib.sha3_256()
        for k, v in self.pairs(""):
            kb = k.encode()
            h.update(len(kb).to_bytes(8, "little"))
            h.update(kb)
            h.update(len(v).to_bytes(8, "little"))
            h.update(v)
        return h.digest()

    # convenience
    def contains(self, key: str) -> bool:
        return self.get(key) is not None


class RamKvStore(KvStore):
    def __init__(self):
        self._map: Dict[str, bytes] = {}

    def get(self, key: str) -> Optional[bytes]:
        return self._map.get(key)

    def update(self, ops: Iterable[WriteOp]) -> None:
        for op in ops:
            if isinstance(op, Put):
                self._map[op.key] = op.value
            elif isinstance(op, Remove):
                self._map.pop(op.key, None)
            else:
                raise KvStoreError(f"bad write op {op!r}")

    def pairs(self, prefix: str = "") -> List[Tuple[str, bytes]]:
        return sorted(
            (k, v) for k, v in self._map.items() if k.startswith(prefix)
        )


class RamMirrorKvStore(KvStore):
    """Copy-on-write overlay fork over any base store.

    Reads fall through to the base unless overwritten; `to_ops` yields the
    delta to commit; `rollback_ops` yields the inverse ops that restore
    the base (persisted per-block for chain rollback, reference:
    src/blockchain/ops/apply_block.rs:181-186).
    """

    def __init__(self, base: KvStore):
        self._base = base
        self._overwrite: Dict[str, Optional[bytes]] = {}

    def get(self, key: str) -> Optional[bytes]:
        if key in self._overwrite:
            return self._overwrite[key]
        return self._base.get(key)

    def update(self, ops: Iterable[WriteOp]) -> None:
        for op in ops:
            if isinstance(op, Put):
                self._overwrite[op.key] = op.value
            elif isinstance(op, Remove):
                self._overwrite[op.key] = None
            else:
                raise KvStoreError(f"bad write op {op!r}")

    def pairs(self, prefix: str = "") -> List[Tuple[str, bytes]]:
        merged = {k: v for k, v in self._base.pairs(prefix)}
        for k, v in self._overwrite.items():
            if not k.startswith(prefix):
                continue
            if v is None:
                merged.pop(k, None)
            else:
                merged[k] = v
        return sorted(merged.items())

    def to_ops(self) -> List[WriteOp]:
        """The overlay as committable write ops."""
        return [
            Put(k, v) if v is not None else Remove(k)
            for k, v in sorted(self._overwrite.items())
        ]

    def rollback_ops(self) -> List[WriteOp]:
        """Inverse ops restoring the base store's view of touched keys."""
        out: List[WriteOp] = []
        for k in sorted(self._overwrite):
            old = self._base.get(k)
            out.append(Put(k, old) if old is not None else Remove(k))
        return out
