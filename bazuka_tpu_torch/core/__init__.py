"""Core chain datatypes: the concrete scheme bindings
(reference: src/core/mod.rs:20-57 — Hasher=SHA3, Signer=Ed25519,
ZkHasher=Poseidon, ZkSigner=JubJub) plus the unified mempool types
GeneralAddress / GeneralTransaction / NonceGroup
(reference: src/core/mod.rs:103-207).
A copy of `bazuka_tpu/core/__init__.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

from ..crypto import jubjub as jj
from ..crypto.ed25519 import Ed25519 as Signer, PublicKey as Address
from ..crypto.vrf import VRF as Vrf
from ..zk.poseidon_host import PoseidonHasher as ZkHasher
from .address import Delegate, MpnAddress, Signature, Staker, Undelegation
from .blocks import Block
from .hash import Sha3Hasher as Hasher
from .header import Header, ProofOfStake, ValidatorProof
from .money import Decimal, Ratio, display_amount
from .token import Token
from .transaction import (
    ContractAccount,
    ContractDeposit,
    ContractId,
    ContractUpdate,
    ContractUpdateData,
    ContractWithdraw,
    Money,
    MpnDeposit,
    MpnTransaction,
    MpnWithdraw,
    RegularSendEntry,
    Transaction,
    TransactionAndDelta,
    TransactionData,
)

ZkSigner = jj.JubJub

GeneralAddress = Union[Address, MpnAddress]  # chain vs MPN address


def parse_general_address(s: str) -> GeneralAddress:
    try:
        return Address.parse(s)
    except ValueError:
        return MpnAddress.parse(s)


TX_KINDS = ("tx_delta", "mpn_deposit", "mpn_transaction", "mpn_withdraw")


@dataclass(frozen=True, eq=True)
class NonceGroup:
    """Mempool queue key: (kind, sender address)
    (reference: src/core/mod.rs:124-155)."""

    kind: str  # one of TX_KINDS
    address: str  # display string of the sender address

    def __post_init__(self):
        assert self.kind in TX_KINDS, self.kind

    def __hash__(self):
        # explicit because the dataclass-generated __hash__ would resolve
        # `hash` from this module's globals, where the .hash submodule
        # shadows the builtin
        import builtins

        return builtins.hash((self.kind, self.address))


class GeneralTransaction:
    """Unified wrapper over the 4 mempool transaction kinds
    (reference: src/core/mod.rs:157-207)."""

    def __init__(self, inner):
        if isinstance(inner, TransactionAndDelta):
            self.kind = "tx_delta"
        elif isinstance(inner, MpnDeposit):
            self.kind = "mpn_deposit"
        elif isinstance(inner, MpnTransaction):
            self.kind = "mpn_transaction"
        elif isinstance(inner, MpnWithdraw):
            self.kind = "mpn_withdraw"
        else:
            raise TypeError(f"not a mempool tx: {inner!r}")
        self.inner = inner

    def nonce(self) -> int:
        t = self.inner
        if self.kind == "tx_delta":
            return t.tx.nonce
        if self.kind == "mpn_deposit":
            return t.payment.nonce
        if self.kind == "mpn_transaction":
            return t.nonce
        return t.mpn_withdraw_nonce

    def fee(self) -> Money:
        t = self.inner
        if self.kind == "tx_delta":
            return t.tx.fee
        if self.kind == "mpn_deposit":
            return t.payment.fee
        if self.kind == "mpn_transaction":
            return t.fee
        return t.payment.fee

    def sender_str(self) -> str:
        t = self.inner
        if self.kind == "tx_delta":
            return str(t.tx.src) if t.tx.src else ""
        if self.kind == "mpn_deposit":
            return str(t.payment.src)
        if self.kind == "mpn_transaction":
            return str(MpnAddress(t.src_pub_key))
        return str(MpnAddress(t.mpn_address))

    def nonce_group(self) -> NonceGroup:
        return NonceGroup(self.kind, self.sender_str())

    def verify_signature(self) -> bool:
        t = self.inner
        if self.kind == "tx_delta":
            return t.tx.verify_signature()
        if self.kind == "mpn_deposit":
            return t.payment.verify_signature()
        if self.kind == "mpn_transaction":
            return t.verify_signature()
        return t.verify_signature()

    _TAGS = {"tx_delta": 0, "mpn_deposit": 1, "mpn_transaction": 2, "mpn_withdraw": 3}
    _CLASSES = None  # filled below

    def write_to(self, w):
        w.variant(self._TAGS[self.kind])
        self.inner.write_to(w)

    @staticmethod
    def read_from(r):
        tag = r.variant()
        cls = GeneralTransaction._CLASSES[tag]
        return GeneralTransaction(cls.read_from(r))

    def __eq__(self, other):
        return (
            isinstance(other, GeneralTransaction)
            and self.kind == other.kind
            and self.inner == other.inner
        )

    def __hash__(self):
        # NB: `hash` the builtin is shadowed by the .hash submodule here
        import builtins

        return builtins.hash((self.kind, repr(self.inner)))


GeneralTransaction._CLASSES = {
    0: TransactionAndDelta,
    1: MpnDeposit,
    2: MpnTransaction,
    3: MpnWithdraw,
}
