"""Binary SHA3 Merkle tree for block bodies (reference: src/crypto/merkle.rs).

Semantics mirrored exactly (the reference ships golden-vector tests for
these roots, src/crypto/merkle.rs:111-162): nodes merge as
H(min(a,b) ‖ max(a,b)); odd layouts use the reference's leaf mapping into
a flat heap array of size 2·len−1; empty tree root is 32 zero bytes.
A copy of `bazuka_tpu/crypto/merkle.py`.
"""

from __future__ import annotations

from typing import List

from ..core.hash import Sha3Hasher


def merge_hash(a: bytes, b: bytes, hasher=Sha3Hasher) -> bytes:
    return hasher.hash(a + b if a < b else b + a)


class MerkleTree:
    def __init__(self, leaves: List[bytes], hasher=Sha3Hasher):
        self.h = hasher
        if not leaves:
            self.data = [bytes(hasher.OUTPUT_LEN)]
            return
        self.data = [bytes(hasher.OUTPUT_LEN)] * (len(leaves) * 2 - 1)
        self._num_leaves = len(leaves)
        for i, val in enumerate(leaves):
            self.data[self._leaf_map(i)] = val
        self._make_parents()

    def depth(self) -> int:
        n = len(self.data)
        if n == 1:
            return 0
        # next_power_of_two(n).trailing_zeros() - 1
        p = 1
        while p < n:
            p <<= 1
        return p.bit_length() - 2

    def num_leaves(self) -> int:
        return (len(self.data) + 1) >> 1

    def _parent(self, i: int) -> int:
        return (i - 1) >> 1

    def _sibling(self, i: int) -> int:
        return i - 1 if i % 2 == 0 else i + 1

    def _leaf_map(self, i: int) -> int:
        n = len(self.data)
        dep = self.depth()
        lower_start = (1 << dep) - 1
        lower_leaves = n - lower_start
        if lower_start + i < n:
            return lower_start + i
        upper_start = (1 << (dep - 1)) - 1
        upper_offset = lower_leaves >> 1
        return upper_start - upper_offset + i

    def _make_parents(self):
        total = len(self.data)
        for d in range(self.depth(), 0, -1):
            start = (1 << d) - 1
            length = 1 << d
            for k in range(0, length, 2):
                i = start + k
                if i >= total:
                    break
                merged = merge_hash(self.data[i], self.data[i + 1], self.h)
                self.data[self._parent(i)] = merged

    def root(self) -> bytes:
        return self.data[0]

    def prove(self, leaf: int) -> List[bytes]:
        proof = []
        ind = self._leaf_map(leaf)
        while ind != 0:
            proof.append(self.data[self._sibling(ind)])
            ind = self._parent(ind)
        return proof

    @staticmethod
    def verify(root: bytes, leaf_hash: bytes, proof: List[bytes], hasher=Sha3Hasher) -> bool:
        acc = leaf_hash
        for sib in proof:
            acc = merge_hash(acc, sib, hasher)
        return acc == root
