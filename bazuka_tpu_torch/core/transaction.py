"""Transaction datatypes (reference: src/core/transaction.rs, plus
MpnTransaction from src/zk/mod.rs:584-650).

All types carry deterministic `write_to`/`read_from` codecs; tx hashes are
SHA3-256 over the serialized form, and L1 signing covers the serialization
with the signature field blanked (reference semantics: ContractDeposit
verify_signature, Transaction::hash).
A copy of `bazuka_tpu/core/transaction.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from ..crypto import jubjub as jj
from ..crypto.ed25519 import Ed25519, PublicKey as Address
from ..fields.host import FR_MODULUS, fr_from_hex, fr_to_hex
from ..utils import ser
from ..zk.poseidon_host import PoseidonHasher
from ..zk.proof import ZkProof
from ..zk.state import ZkCompressedState, loc_parse, loc_str
from .hash import Sha3Hasher
from .money import Ratio
from .token import Token

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

    @staticmethod
    def from_tx(tx: "Transaction") -> "ContractId":
        """hash_to_scalar of the serialized tx (reference: :71-75)."""
        return ContractId(jj.hash_to_scalar(ser.dumps(tx)))


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


# ---------------------------------------------------------------- zk pairs


def write_data_pairs(w: ser.Writer, pairs: Dict[Tuple[int, ...], int]):
    items = sorted(pairs.items(), key=lambda kv: loc_str(kv[0]))
    w.u64(len(items))
    for loc, val in items:
        w.string(loc_str(loc))
        w.big(val % P, 32)


def read_data_pairs(r: ser.Reader) -> Dict[Tuple[int, ...], int]:
    return {loc_parse(r.string()): r.big(32) for _ in range(r.u64())}


def write_delta_pairs(w: ser.Writer, pairs: Dict[Tuple[int, ...], Optional[int]]):
    items = sorted(pairs.items(), key=lambda kv: loc_str(kv[0]))
    w.u64(len(items))
    for loc, val in items:
        w.string(loc_str(loc))
        w.option(val, lambda w, v: w.big(v % P, 32))


def read_delta_pairs(r: ser.Reader) -> Dict[Tuple[int, ...], Optional[int]]:
    return {
        loc_parse(r.string()): r.option(lambda r: r.big(32))
        for _ in range(r.u64())
    }


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
        from ..fields.host import fr_from_le_bytes_mod

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


# ---------------------------------------------------------------- contract updates


@dataclass
class ContractAccount:
    height: int
    compressed_state: ZkCompressedState

    def write_to(self, w: ser.Writer):
        w.u64(self.height)
        self.compressed_state.write_to(w)

    @staticmethod
    def read_from(r: ser.Reader) -> "ContractAccount":
        return ContractAccount(r.u64(), ZkCompressedState.read_from(r))


@dataclass
class ContractUpdateData:
    """Deposit{deposits} | Withdraw{withdraws} | FunctionCall{fee} | Mint{amount}."""

    kind: str
    deposits: List[ContractDeposit] = field(default_factory=list)
    withdraws: List[ContractWithdraw] = field(default_factory=list)
    fee: Optional[Money] = None
    amount: Optional[int] = None

    _TAGS = {"deposit": 0, "withdraw": 1, "function_call": 2, "mint": 3}

    def write_to(self, w: ser.Writer):
        w.variant(self._TAGS[self.kind])
        if self.kind == "deposit":
            w.seq(self.deposits, lambda w, d: d.write_to(w))
        elif self.kind == "withdraw":
            w.seq(self.withdraws, lambda w, d: d.write_to(w))
        elif self.kind == "function_call":
            self.fee.write_to(w)
        else:
            w.u64(self.amount)

    @staticmethod
    def read_from(r: ser.Reader) -> "ContractUpdateData":
        tag = r.variant()
        if tag == 0:
            return ContractUpdateData("deposit", deposits=r.seq(ContractDeposit.read_from))
        if tag == 1:
            return ContractUpdateData("withdraw", withdraws=r.seq(ContractWithdraw.read_from))
        if tag == 2:
            return ContractUpdateData("function_call", fee=Money.read_from(r))
        if tag == 3:
            return ContractUpdateData("mint", amount=r.u64())
        raise ValueError(f"bad contract update tag {tag}")


@dataclass
class ContractUpdate:
    """One proven batch (reference: transaction.rs:239-246)."""

    circuit_id: int
    data: ContractUpdateData
    next_state: ZkCompressedState
    prover: Address
    reward: int
    proof: ZkProof

    def write_to(self, w: ser.Writer):
        w.u32(self.circuit_id)
        self.data.write_to(w)
        self.next_state.write_to(w)
        write_address(w, self.prover)
        w.u64(self.reward)
        self.proof.write_to(w)

    @staticmethod
    def read_from(r: ser.Reader) -> "ContractUpdate":
        return ContractUpdate(
            r.u32(), ContractUpdateData.read_from(r), ZkCompressedState.read_from(r),
            read_address(r), r.u64(), ZkProof.read_from(r),
        )


@dataclass
class RegularSendEntry:
    dst: Address
    amount: Money

    def write_to(self, w: ser.Writer):
        write_address(w, self.dst)
        self.amount.write_to(w)

    @staticmethod
    def read_from(r: ser.Reader) -> "RegularSendEntry":
        return RegularSendEntry(read_address(r), Money.read_from(r))


# ---------------------------------------------------------------- tx data


@dataclass
class TransactionData:
    """Tagged union of the 7 L1 transaction kinds
    (reference: transaction.rs:314-347)."""

    kind: str
    # update_staker
    vrf_pub_key: Optional[str] = None
    commission: Optional[Ratio] = None
    # delegate / undelegate
    amount: Optional[int] = None
    to: Optional[Address] = None
    frm: Optional[Address] = None
    ratio: Optional[Ratio] = None
    # regular_send
    entries: List[RegularSendEntry] = field(default_factory=list)
    # create_contract
    contract: Optional[object] = None  # zk.state.ZkContract
    money: Optional[Money] = None
    state: Optional[Dict[Tuple[int, ...], int]] = None
    # update_contract
    contract_id: Optional[ContractId] = None
    updates: List[ContractUpdate] = field(default_factory=list)
    delta: Optional[Dict[Tuple[int, ...], Optional[int]]] = None

    _TAGS = {
        "update_staker": 0, "delegate": 1, "undelegate": 2, "auto_delegate": 3,
        "regular_send": 4, "create_contract": 5, "update_contract": 6,
    }

    def write_to(self, w: ser.Writer, for_signing: bool = False):
        w.variant(self._TAGS[self.kind])
        if self.kind == "update_staker":
            w.string(self.vrf_pub_key)
            w.u8(self.commission.value)
        elif self.kind == "delegate":
            w.u64(self.amount)
            write_address(w, self.to)
        elif self.kind == "undelegate":
            w.u64(self.amount)
            write_address(w, self.frm)
        elif self.kind == "auto_delegate":
            write_address(w, self.to)
            w.u8(self.ratio.value)
        elif self.kind == "regular_send":
            w.seq(self.entries, lambda w, e: e.write_to(w))
        elif self.kind == "create_contract":
            self.contract.write_to(w)
            self.money.write_to(w)
            # state is NOT part of the signature (reference: :338 comment)
            if for_signing:
                w.u8(0)
            else:
                w.option(self.state, write_data_pairs)
        elif self.kind == "update_contract":
            self.contract_id.write_to(w)
            w.seq(self.updates, lambda w, u: u.write_to(w))
            if for_signing:
                w.u8(0)
            else:
                w.option(self.delta, write_delta_pairs)
        else:
            raise ValueError(f"bad tx kind {self.kind}")

    @staticmethod
    def read_from(r: ser.Reader) -> "TransactionData":
        from ..zk.state import ZkContract

        tag = r.variant()
        if tag == 0:
            return TransactionData("update_staker", vrf_pub_key=r.string(),
                                   commission=Ratio(r.u8()))
        if tag == 1:
            return TransactionData("delegate", amount=r.u64(), to=read_address(r))
        if tag == 2:
            return TransactionData("undelegate", amount=r.u64(), frm=read_address(r))
        if tag == 3:
            return TransactionData("auto_delegate", to=read_address(r), ratio=Ratio(r.u8()))
        if tag == 4:
            return TransactionData("regular_send", entries=r.seq(RegularSendEntry.read_from))
        if tag == 5:
            return TransactionData(
                "create_contract", contract=ZkContract.read_from(r),
                money=Money.read_from(r), state=r.option(read_data_pairs),
            )
        if tag == 6:
            return TransactionData(
                "update_contract", contract_id=ContractId.read_from(r),
                updates=r.seq(ContractUpdate.read_from),
                delta=r.option(read_delta_pairs),
            )
        raise ValueError(f"bad tx data tag {tag}")


@dataclass
class Transaction:
    src: Optional[Address]  # None = reward treasury
    nonce: int
    data: TransactionData
    fee: Money
    memo: str
    sig: Optional[bytes] = None  # None = Unsigned

    def write_to(self, w: ser.Writer, for_signing: bool = False):
        w.option(self.src, lambda w, a: write_address(w, a))
        w.u32(self.nonce)
        self.data.write_to(w, for_signing)
        self.fee.write_to(w)
        w.string(self.memo)
        if not for_signing:
            w.option(self.sig, lambda w, s: w.bytes(s))

    @staticmethod
    def read_from(r: ser.Reader) -> "Transaction":
        return Transaction(
            r.option(read_address), r.u32(), TransactionData.read_from(r),
            Money.read_from(r), r.string(), r.option(lambda r: r.bytes()),
        )

    def signing_bytes(self) -> bytes:
        w = ser.Writer()
        self.write_to(w, for_signing=True)
        return w.getvalue()

    def hash(self) -> bytes:
        return Sha3Hasher.hash(ser.dumps(self))

    def sign(self, sk):
        self.sig = Ed25519.sign(sk, self.signing_bytes())

    def verify_signature(self) -> bool:
        if self.src is None:
            # treasury txs are unsigned by definition
            return self.sig is None
        if self.sig is None:
            return False
        return Ed25519.verify(self.src, self.signing_bytes(), self.sig)


@dataclass
class TransactionAndDelta:
    tx: Transaction
    state_delta: Optional[Dict[Tuple[int, ...], Optional[int]]] = None

    def write_to(self, w: ser.Writer):
        self.tx.write_to(w)
        w.option(self.state_delta, write_delta_pairs)

    @staticmethod
    def read_from(r: ser.Reader) -> "TransactionAndDelta":
        return TransactionAndDelta(
            Transaction.read_from(r), r.option(read_delta_pairs)
        )
