"""TxBuilder: key management + construction/signing of every tx type
(reference: src/wallet/tx_builder.rs).
A copy of `bazuka_tpu/wallet/tx_builder.py`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..core.address import MpnAddress
from ..core.hash import Sha3Hasher
from ..core.money import Ratio
from ..core.transaction import (
    ContractDeposit,
    ContractId,
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
from ..core.token import Token
from ..crypto import jubjub as jj
from ..crypto.ed25519 import Ed25519
from ..crypto.vrf import VRF
from ..zk.poseidon_host import PoseidonHasher
from ..zk.proof import ZkTokenContract
from ..zk.state import SCALAR, Struct, ZkCompressedState, ZkContract


class TxBuilder:
    """Derives ed25519 + jubjub + VRF keys from one seed and builds/signs
    every transaction kind (reference: tx_builder.rs:28-42)."""

    def __init__(self, seed: bytes):
        self.address, self._sk = Ed25519.generate_keys(seed)
        self.zk_address, self._zk_sk = jj.JubJub.generate_keys(seed)
        self.vrf_public_key, self._vrf_sk = VRF.generate_keys(Sha3Hasher.hash(seed))

    # -- accessors

    def get_address(self):
        return self.address

    def get_zk_address(self) -> jj.PublicKey:
        return self.zk_address

    def get_mpn_address(self) -> MpnAddress:
        return MpnAddress(self.zk_address)

    def get_vrf_public_key(self):
        return self.vrf_public_key

    # -- signing

    def sign(self, data: bytes) -> bytes:
        return Ed25519.sign(self._sk, data)

    def sign_tx(self, tx: Transaction):
        tx.sign(self._sk)

    # -- VRF (PoS leader election)

    def generate_random(self, randomness: bytes, epoch: int, slot: int, attempt: int):
        """(reference: tx_builder.rs:146-160) — preimage
        `hex(randomness)-epoch-slot-attempt`."""
        msg = f"{randomness.hex()}-{epoch}-{slot}-{attempt}".encode()
        return VRF.sign(self._vrf_sk, msg)

    # -- L1 transactions

    def _tx(self, memo, data, fee, nonce) -> Transaction:
        tx = Transaction(
            src=self.address, nonce=nonce, data=data, fee=fee, memo=memo
        )
        self.sign_tx(tx)
        return tx

    def create_transaction(
        self, memo: str, dst, amount: Money, fee: Money, nonce: int
    ) -> TransactionAndDelta:
        return self.create_multi_transaction(
            memo, [RegularSendEntry(dst, amount)], fee, nonce
        )

    def create_multi_transaction(
        self, memo: str, entries: List[RegularSendEntry], fee: Money, nonce: int
    ) -> TransactionAndDelta:
        return TransactionAndDelta(
            self._tx(memo, TransactionData("regular_send", entries=entries), fee, nonce)
        )

    def delegate(
        self, memo: str, to, amount: int, fee: Money, nonce: int
    ) -> TransactionAndDelta:
        return TransactionAndDelta(
            self._tx(memo, TransactionData("delegate", amount=amount, to=to), fee, nonce)
        )

    def undelegate(
        self, memo: str, frm, amount: int, fee: Money, nonce: int
    ) -> TransactionAndDelta:
        return TransactionAndDelta(
            self._tx(memo, TransactionData("undelegate", amount=amount, frm=frm), fee, nonce)
        )

    def auto_delegate(
        self, memo: str, to, ratio: Ratio, fee: Money, nonce: int
    ) -> TransactionAndDelta:
        return TransactionAndDelta(
            self._tx(memo, TransactionData("auto_delegate", to=to, ratio=ratio), fee, nonce)
        )

    def register_validator(
        self, memo: str, commission: Ratio, fee: Money, nonce: int
    ) -> TransactionAndDelta:
        return TransactionAndDelta(
            self._tx(
                memo,
                TransactionData(
                    "update_staker",
                    vrf_pub_key=str(self.vrf_public_key),
                    commission=commission,
                ),
                fee,
                nonce,
            )
        )

    def claim_validator(self, timestamp: int, proof, node):
        """Signed claim to the current slot (reference: tx_builder.rs:187-203)."""
        from ..node.context import ValidatorClaim

        claim = ValidatorClaim(
            timestamp=timestamp, address=self.address, proof=proof, node=node
        )
        claim.sig = Ed25519.sign(self._sk, claim.signing_bytes())
        return claim

    def create_contract(
        self, memo: str, contract: ZkContract, initial_state: dict,
        money: Money, fee: Money, nonce: int,
    ) -> TransactionAndDelta:
        tx = self._tx(
            memo,
            TransactionData(
                "create_contract", contract=contract, money=money,
                state=dict(initial_state),
            ),
            fee,
            nonce,
        )
        return TransactionAndDelta(
            tx, state_delta={k: v for k, v in initial_state.items()}
        )

    def create_token(
        self, memo: str, name: str, symbol: str, supply: int, decimals: int,
        minter, fee: Money, nonce: int,
    ) -> Tuple[TransactionAndDelta, ContractId]:
        contract = ZkContract(
            initial_state=ZkCompressedState.empty(SCALAR),
            state_model=SCALAR,
            token=ZkTokenContract(
                token=Token(name, symbol, supply, decimals,
                            str(minter) if minter else None)
            ),
        )
        tx = self._tx(
            memo,
            TransactionData("create_contract", contract=contract,
                            money=Money.ziesha(0), state={}),
            fee,
            nonce,
        )
        return TransactionAndDelta(tx), ContractId.from_tx(tx)

    # -- L2 / MPN

    def create_mpn_transaction(
        self, to: MpnAddress, amount: Money, fee: Money, nonce: int
    ) -> MpnTransaction:
        tx = MpnTransaction(
            nonce=nonce, src_pub_key=self.zk_address, dst_pub_key=to.pub_key,
            amount=amount, fee=fee,
        )
        tx.sign(self._zk_sk)
        return tx

    def deposit_mpn(
        self, memo: str, contract_id: ContractId, to: MpnAddress, nonce: int,
        amount: Money, fee: Money,
    ) -> MpnDeposit:
        """calldata = compress(Struct[pub_x, pub_y]) = Poseidon2(x, y)
        (reference: tx_builder.rs:336-374, zk::MPN_DEPOSIT_STATE_MODEL)."""
        pk = to.pub_key.decompress()
        calldata = PoseidonHasher.hash([pk[0], pk[1]])
        payment = ContractDeposit(
            memo=memo, src=self.address, contract_id=contract_id,
            deposit_circuit_id=0, calldata=calldata, nonce=nonce,
            amount=amount, fee=fee,
        )
        payment.sign(self._sk)
        return MpnDeposit(mpn_address=to.pub_key, payment=payment)

    def withdraw_mpn(
        self, memo: str, contract_id: ContractId, nonce: int,
        amount: Money, fee: Money, to,
    ) -> MpnWithdraw:
        """sig over Poseidon2(fingerprint, nonce); calldata =
        Poseidon6(pub, nonce, sig) (reference: tx_builder.rs:376-425)."""
        payment = ContractWithdraw(
            memo=memo, dst=to, contract_id=contract_id,
            withdraw_circuit_id=0, calldata=0, amount=amount, fee=fee,
        )
        msg = PoseidonHasher.hash([payment.fingerprint(), nonce])
        sig = jj.JubJub.sign(self._zk_sk, msg)
        pk = self.zk_address.decompress()
        payment.calldata = PoseidonHasher.hash(
            [pk[0], pk[1], nonce, sig.r[0], sig.r[1], sig.s]
        )
        return MpnWithdraw(
            mpn_address=self.zk_address, mpn_withdraw_nonce=nonce,
            mpn_sig=sig, payment=payment,
        )
