"""Token descriptor (reference: src/core/transaction.rs:255-283).

A copy of `bazuka_tpu/core/token.py`."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from ..utils import ser

MIN_NAME_LEN = 3
MAX_NAME_LEN = 32
MIN_SYMBOL_LEN = 3
MAX_SYMBOL_LEN = 6

_NAME_RE = re.compile(r"^(?:[a-zA-Z0-9]+ )*[a-zA-Z0-9]+$")
_SYMBOL_RE = re.compile(r"^[A-Z][A-Z0-9]*$")


@dataclass
class Token:
    name: str
    symbol: str
    supply: int  # Amount; 1 for NFTs
    decimals: int
    minter: Optional[str] = None  # signer public key (address string)

    def validate(self) -> bool:
        return (
            MIN_NAME_LEN <= len(self.name) <= MAX_NAME_LEN
            and MIN_SYMBOL_LEN <= len(self.symbol) <= MAX_SYMBOL_LEN
            and _NAME_RE.fullmatch(self.name) is not None
            and _SYMBOL_RE.fullmatch(self.symbol) is not None
        )

    def write_to(self, w: ser.Writer):
        w.string(self.name).string(self.symbol).u64(self.supply).u8(self.decimals)
        w.option(self.minter, lambda w, m: w.string(m))

    @staticmethod
    def read_from(r: ser.Reader) -> "Token":
        return Token(
            r.string(), r.string(), r.u64(), r.u8(), r.option(lambda r: r.string())
        )
