"""MPN address (reference: src/core/address.rs): the part of
`bazuka_tpu/core/address.py` the MPN path needs.

`Address` is the ed25519 L1 public key (`ed<hex>`); `MpnAddress` wraps
the JubJub compressed key (`jub2/jub3<hex>`).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import jubjub as jj
from ..crypto.ed25519 import PublicKey as Address  # noqa: F401 (re-export)
from ..utils import ser


@dataclass(frozen=True)
class MpnAddress:
    pub_key: jj.PublicKey

    def __str__(self) -> str:
        return str(self.pub_key)

    @staticmethod
    def parse(s: str) -> "MpnAddress":
        return MpnAddress(jj.PublicKey.parse(s))

    def write_to(self, w: ser.Writer):
        w.big(self.pub_key.x, 32).boolean(self.pub_key.sign)

    @staticmethod
    def read_from(r: ser.Reader) -> "MpnAddress":
        return MpnAddress(jj.PublicKey(r.big(32), r.boolean()))
