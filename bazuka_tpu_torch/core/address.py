"""Address & staking datatypes (reference: src/core/address.rs).

`Address` is the ed25519 L1 public key (`ed<hex>`); `MpnAddress` wraps
the JubJub compressed key (`jub2/jub3<hex>`).
A copy of `bazuka_tpu/core/address.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..crypto import jubjub as jj
from ..crypto.ed25519 import PublicKey as Address  # noqa: F401 (re-export)
from ..utils import ser
from .money import Ratio


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


@dataclass(frozen=True)
class Signature:
    """Unsigned | Signed(sig bytes) (reference: src/core/address.rs)."""

    sig: Optional[bytes] = None  # None = Unsigned

    @property
    def is_signed(self) -> bool:
        return self.sig is not None

    def write_to(self, w: ser.Writer):
        w.option(self.sig, lambda w, s: w.bytes(s))

    @staticmethod
    def read_from(r: ser.Reader) -> "Signature":
        return Signature(r.option(lambda r: r.bytes()))


UNSIGNED = Signature(None)


@dataclass(frozen=True)
class Staker:
    vrf_pub_key: str  # vrf address string
    commission: Ratio

    def write_to(self, w: ser.Writer):
        w.string(self.vrf_pub_key).u8(self.commission.value)

    @staticmethod
    def read_from(r: ser.Reader) -> "Staker":
        return Staker(r.string(), Ratio(r.u8()))


@dataclass(frozen=True)
class Delegate:
    amount: int

    def write_to(self, w: ser.Writer):
        w.u64(self.amount)

    @staticmethod
    def read_from(r: ser.Reader) -> "Delegate":
        return Delegate(r.u64())


@dataclass(frozen=True)
class Undelegation:
    amount: int
    unlocks_on: int  # header number

    def write_to(self, w: ser.Writer):
        w.u64(self.amount).u64(self.unlocks_on)

    @staticmethod
    def read_from(r: ser.Reader) -> "Undelegation":
        return Undelegation(r.u64(), r.u64())
