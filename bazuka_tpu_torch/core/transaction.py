"""MPN transaction datatypes (reference: src/core/transaction.rs, plus
MpnTransaction from src/zk/mod.rs:584-650): the part of
`bazuka_tpu/core/transaction.py` the MPN path uses.  Blocks, headers, VRF
and the L1 transaction family are left out.

All types carry deterministic `write_to`/`read_from` codecs; L1 signing
covers the serialization with the signature field blanked (reference
semantics: ContractDeposit verify_signature).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from ..crypto import jubjub as jj
from ..crypto.ed25519 import Ed25519, PublicKey as Address
from ..fields.host import FR_MODULUS, fr_from_hex, fr_from_le_bytes_mod, fr_to_hex
from ..utils import ser
from ..zk.poseidon_host import PoseidonHasher
from .hash import Sha3Hasher

P = FR_MODULUS


# ---------------------------------------------------------------- ids


@dataclass(frozen=True)
class ContractId:
    """Null | Ziesha | Custom(scalar) (reference: transaction.rs:135-162)."""

    scalar: int  # 0 = Null, 1 = Ziesha, else custom

    NULL: "ContractId" = None  # filled below
    ZIESHA: "ContractId" = None

    @property
    def is_null(self) -> bool:
        return self.scalar == 0

    @property
    def is_ziesha(self) -> bool:
        return self.scalar == 1

    def __str__(self) -> str:
        if self.is_null:
            return "Null"
        if self.is_ziesha:
            return "Ziesha"
        return fr_to_hex(self.scalar)

    @staticmethod
    def parse(s: str) -> "ContractId":
        if s == "Ziesha":
            return ContractId.ZIESHA
        if s == "Null":
            return ContractId.NULL
        return ContractId(fr_from_hex(s))

    def write_to(self, w: ser.Writer):
        w.big(self.scalar, 32)

    @staticmethod
    def read_from(r: ser.Reader) -> "ContractId":
        return ContractId(r.big(32))


ContractId.NULL = ContractId(0)
ContractId.ZIESHA = ContractId(1)


@dataclass(frozen=True)
class Money:
    token_id: ContractId
    amount: int

    @staticmethod
    def ziesha(amount: int) -> "Money":
        return Money(ContractId.ZIESHA, amount)

    def write_to(self, w: ser.Writer):
        self.token_id.write_to(w)
        w.u64(self.amount)

    @staticmethod
    def read_from(r: ser.Reader) -> "Money":
        return Money(ContractId.read_from(r), r.u64())


# ---------------------------------------------------------------- addresses in ser


def write_address(w: ser.Writer, a: Address):
    w.raw(a.raw)


def read_address(r: ser.Reader) -> Address:
    return Address(r.raw(32))


def write_jub_pub(w: ser.Writer, pk: jj.PublicKey):
    w.big(pk.x, 32).boolean(pk.sign)


def read_jub_pub(r: ser.Reader) -> jj.PublicKey:
    return jj.PublicKey(r.big(32), r.boolean())


def write_jub_sig(w: ser.Writer, s: jj.Signature):
    w.big(s.r[0], 32).big(s.r[1], 32).big(s.s, 32)


def read_jub_sig(r: ser.Reader) -> jj.Signature:
    return jj.Signature((r.big(32), r.big(32)), r.big(32))


# ---------------------------------------------------------------- bridges


@dataclass
class ContractDeposit:
    """L1 -> contract deposit (reference: transaction.rs:139-152)."""

    memo: str
    contract_id: ContractId
    deposit_circuit_id: int
    calldata: int
    src: Address
    amount: Money
    fee: Money
    nonce: int
    sig: Optional[bytes] = None

    def write_to(self, w: ser.Writer):
        w.string(self.memo)
        self.contract_id.write_to(w)
        w.u32(self.deposit_circuit_id)
        w.big(self.calldata % P, 32)
        write_address(w, self.src)
        self.amount.write_to(w)
        self.fee.write_to(w)
        w.u32(self.nonce)
        w.option(self.sig, lambda w, s: w.bytes(s))

    @staticmethod
    def read_from(r: ser.Reader) -> "ContractDeposit":
        return ContractDeposit(
            r.string(), ContractId.read_from(r), r.u32(), r.big(32),
            read_address(r), Money.read_from(r), Money.read_from(r), r.u32(),
            r.option(lambda r: r.bytes()),
        )

    def unsigned_bytes(self) -> bytes:
        return ser.dumps(replace(self, sig=None))

    def sign(self, sk) -> None:
        self.sig = Ed25519.sign(sk, self.unsigned_bytes())

    def verify_signature(self) -> bool:
        if self.sig is None:
            return False
        return Ed25519.verify(self.src, self.unsigned_bytes(), self.sig)


@dataclass
class ContractWithdraw:
    """Contract -> L1 withdraw (reference: transaction.rs:153-162)."""

    memo: str
    contract_id: ContractId
    withdraw_circuit_id: int
    calldata: int
    dst: Address
    amount: Money
    fee: Money

    def write_to(self, w: ser.Writer):
        w.string(self.memo)
        self.contract_id.write_to(w)
        w.u32(self.withdraw_circuit_id)
        w.big(self.calldata % P, 32)
        write_address(w, self.dst)
        self.amount.write_to(w)
        self.fee.write_to(w)

    @staticmethod
    def read_from(r: ser.Reader) -> "ContractWithdraw":
        return ContractWithdraw(
            r.string(), ContractId.read_from(r), r.u32(), r.big(32),
            read_address(r), Money.read_from(r), Money.read_from(r),
        )

    def fingerprint(self) -> int:
        """SHA3 of the calldata-zeroed serialization, as Fr
        (reference: transaction.rs:205-211)."""
        unsigned = replace(self, calldata=0)
        return fr_from_le_bytes_mod(Sha3Hasher.hash(ser.dumps(unsigned)))


@dataclass
class MpnDeposit:
    mpn_address: jj.PublicKey
    payment: ContractDeposit

    def write_to(self, w: ser.Writer):
        write_jub_pub(w, self.mpn_address)
        self.payment.write_to(w)

    @staticmethod
    def read_from(r: ser.Reader) -> "MpnDeposit":
        return MpnDeposit(read_jub_pub(r), ContractDeposit.read_from(r))


@dataclass
class MpnWithdraw:
    mpn_address: jj.PublicKey
    mpn_withdraw_nonce: int
    mpn_sig: jj.Signature
    payment: ContractWithdraw

    def write_to(self, w: ser.Writer):
        write_jub_pub(w, self.mpn_address)
        w.u32(self.mpn_withdraw_nonce)
        write_jub_sig(w, self.mpn_sig)
        self.payment.write_to(w)

    @staticmethod
    def read_from(r: ser.Reader) -> "MpnWithdraw":
        return MpnWithdraw(
            read_jub_pub(r), r.u32(), read_jub_sig(r), ContractWithdraw.read_from(r)
        )

    def calldata(self) -> int:
        """H(pk.x, pk.y, nonce, sig.r.x, sig.r.y, sig.s)
        (reference: transaction.rs:176-182)."""
        pk = self.mpn_address.decompress()
        return PoseidonHasher.hash(
            [pk[0], pk[1], self.mpn_withdraw_nonce,
             self.mpn_sig.r[0], self.mpn_sig.r[1], self.mpn_sig.s]
        )

    def verify_calldata(self) -> bool:
        return self.payment.calldata == self.calldata()

    def sign_message(self) -> int:
        return PoseidonHasher.hash(
            [self.payment.fingerprint(), self.mpn_withdraw_nonce]
        )

    def verify_signature(self) -> bool:
        return jj.JubJub.verify(self.mpn_address, self.sign_message(), self.mpn_sig)


# ---------------------------------------------------------------- L2 tx


@dataclass
class MpnTransaction:
    """Pure L2 transfer (reference: src/zk/mod.rs:584-650)."""

    nonce: int
    src_pub_key: jj.PublicKey
    dst_pub_key: jj.PublicKey
    amount: Money
    fee: Money
    sig: Optional[jj.Signature] = None

    def write_to(self, w: ser.Writer):
        w.u32(self.nonce)
        write_jub_pub(w, self.src_pub_key)
        write_jub_pub(w, self.dst_pub_key)
        self.amount.write_to(w)
        self.fee.write_to(w)
        w.option(self.sig, write_jub_sig)

    @staticmethod
    def read_from(r: ser.Reader) -> "MpnTransaction":
        return MpnTransaction(
            r.u32(), read_jub_pub(r), read_jub_pub(r),
            Money.read_from(r), Money.read_from(r), r.option(read_jub_sig),
        )

    def hash(self) -> int:
        """Poseidon7(nonce, dst.x, dst.y, token, amount, fee_token, fee)
        (reference: src/zk/mod.rs:616-627)."""
        dst = self.dst_pub_key.decompress()
        return PoseidonHasher.hash(
            [self.nonce, dst[0], dst[1],
             self.amount.token_id.scalar, self.amount.amount,
             self.fee.token_id.scalar, self.fee.amount]
        )

    def sign(self, sk: jj.PrivateKey):
        self.sig = jj.JubJub.sign(sk, self.hash())

    def verify_signature(self) -> bool:
        if self.sig is None:
            return False
        return jj.JubJub.verify(self.src_pub_key, self.hash(), self.sig)
