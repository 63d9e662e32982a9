"""TxBuilder: the MPN part of `bazuka_tpu/wallet/tx_builder.py` — key
derivation from one seed (ed25519 and JubJub; no VRF) and the
construction and signing of MPN transfers, deposits and withdrawals
(reference: src/wallet/tx_builder.rs)."""

from __future__ import annotations

from ..core.address import MpnAddress
from ..core.transaction import (
    ContractDeposit,
    ContractId,
    ContractWithdraw,
    Money,
    MpnDeposit,
    MpnTransaction,
    MpnWithdraw,
)
from ..crypto import jubjub as jj
from ..crypto.ed25519 import Ed25519
from ..zk.poseidon_host import PoseidonHasher


class TxBuilder:
    """Derives ed25519 + jubjub keys from one seed and builds/signs the MPN
    transactions (reference: tx_builder.rs:28-42)."""

    def __init__(self, seed: bytes):
        self.address, self._sk = Ed25519.generate_keys(seed)
        self.zk_address, self._zk_sk = jj.JubJub.generate_keys(seed)

    # -- accessors

    def get_address(self):
        return self.address

    def get_zk_address(self) -> jj.PublicKey:
        return self.zk_address

    def get_mpn_address(self) -> MpnAddress:
        return MpnAddress(self.zk_address)

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
