"""Blocks (reference: src/core/blocks.rs).
A copy of `bazuka_tpu/core/blocks.py`."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..crypto.merkle import MerkleTree
from ..utils import ser
from .header import Header
from .transaction import Transaction


@dataclass
class Block:
    header: Header
    body: List[Transaction]

    def merkle_tree(self) -> MerkleTree:
        return MerkleTree([tx.hash() for tx in self.body])

    def write_to(self, w: ser.Writer):
        self.header.write_to(w)
        w.seq(self.body, lambda w, tx: tx.write_to(w))

    @staticmethod
    def read_from(r: ser.Reader) -> "Block":
        return Block(Header.read_from(r), r.seq(Transaction.read_from))
