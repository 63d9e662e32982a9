"""KvStoreChain — the blockchain engine over any KvStore
(reference: src/blockchain/mod.rs + src/blockchain/ops/).

All mutations run "isolated": a copy-on-write fork absorbs writes, the
committed delta is atomic, and every applied block stores its inverse
WriteOps under RLK-<height> for rollback
(reference: ops/apply_block.rs:181-186).
A copy of `bazuka_tpu/blockchain/chain.py`.
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Tuple

from ..core import GeneralTransaction
from ..core.address import Delegate, MpnAddress, Staker, Undelegation
from ..core.blocks import Block
from ..core.hash import Sha3Hasher
from ..core.header import Header, ProofOfStake, ValidatorProof
from ..core.money import Ratio
from ..core.token import Token
from ..core.transaction import (
    ContractAccount,
    ContractDeposit,
    ContractId,
    ContractUpdate,
    ContractWithdraw,
    Money,
    RegularSendEntry,
    Transaction,
    TransactionAndDelta,
    TransactionData,
)
from ..crypto.ed25519 import PublicKey as Address
from ..crypto.vrf import VRF, PublicKey as VrfPublicKey
from ..db import KvStore, Put, Remove, keys
from ..fields.host import fr_from_le_bytes_mod
from ..mpn.account import get_mpn_account as _sm_get_mpn_account
from ..mpn.account import get_mpn_accounts as _sm_get_mpn_accounts
from ..mpn.account import MpnAccount
from ..utils import ser
from ..zk import proof as zkproof
from ..zk.poseidon_host import PoseidonHasher
from ..zk.state import (
    SCALAR,
    ListModel,
    StateManager,
    Struct,
    ZkCompressedState,
    ZkContract,
    blob_to_u64,
    model_is_valid,
    u64_to_blob,
)
from . import error as E
from .config import BlockchainConfig

TREASURY = Address(bytes(32))
MAX_ATTEMPTS = 3


# ---------------------------------------------------------------- codecs


def u32_to_blob(x: int) -> bytes:
    return int(x).to_bytes(4, "little")


def blob_to_u32(b: bytes) -> int:
    return int.from_bytes(b, "little")


def f64_to_blob(x: float) -> bytes:
    return struct.pack("<d", x)


def blob_to_f64(b: bytes) -> float:
    return struct.unpack("<d", b)[0]


def ops_to_blob(ops: List) -> bytes:
    w = ser.Writer()
    w.u64(len(ops))
    for op in ops:
        if isinstance(op, Put):
            w.u8(1).string(op.key).bytes(op.value)
        else:
            w.u8(0).string(op.key)
    return w.getvalue()


def blob_to_ops(b: bytes) -> List:
    r = ser.Reader(b)
    out = []
    for _ in range(r.u64()):
        if r.u8() == 1:
            out.append(Put(r.string(), r.bytes()))
        else:
            out.append(Remove(r.string()))
    return out


def prover_commitment(prover: Address, reward: int) -> int:
    """The 5th Groth16 public input: SHA3(prover ‖ reward) -> Fr
    (reference: src/mpn/mod.rs:281-295)."""
    return fr_from_le_bytes_mod(
        Sha3Hasher.hash(prover.raw + int(reward).to_bytes(8, "little"))
    )


class KvStoreChain:
    """The Blockchain implementation (reference trait:
    src/blockchain/mod.rs:65-179)."""

    def __init__(self, database: KvStore, config: BlockchainConfig):
        self.db = database
        self.config = config
        self.mgr = StateManager()
        if self.get_height() == 0:
            self.apply_block(config.genesis)

    # ------------------------------------------------ fork machinery

    def isolated(self, fn: Callable[["KvStoreChain"], object]):
        """Run fn against a forked chain; return (delta ops, result)
        WITHOUT committing (reference: mod.rs:204-212)."""
        fork_db = self.db.mirror()
        fork = object.__new__(KvStoreChain)
        fork.db = fork_db
        fork.config = self.config
        fork.mgr = self.mgr
        result = fn(fork)
        return fork_db.to_ops(), result

    def fork_on_ram(self) -> "KvStoreChain":
        fork = object.__new__(KvStoreChain)
        fork.db = self.db.mirror()
        fork.config = self.config
        fork.mgr = self.mgr
        return fork

    # ------------------------------------------------ basic accessors

    def get_height(self) -> int:
        blob = self.db.get(keys.height())
        return blob_to_u64(blob) if blob else 0

    def get_tip(self) -> Header:
        return self.get_header(self.get_height() - 1)

    def get_header(self, index: int) -> Header:
        blob = self.db.get(keys.header(index))
        if blob is None:
            raise E.Inconsistency(f"no header {index}")
        return ser.loads(Header, blob)

    def get_block(self, index: int) -> Block:
        blob = self.db.get(keys.block(index))
        if blob is None:
            raise E.Inconsistency(f"no block {index}")
        return ser.loads(Block, blob)

    def get_headers(self, since: int, count: int) -> List[Header]:
        until = min(self.get_height(), since + count)
        return [self.get_header(i) for i in range(since, until)]

    def get_blocks(self, since: int, count: int) -> List[Block]:
        until = min(self.get_height(), since + count)
        return [self.get_block(i) for i in range(since, until)]

    def get_power(self) -> float:
        return self.get_power_at(self.get_height())

    def get_power_at(self, index: int) -> float:
        blob = self.db.get(keys.power_at(index))
        return blob_to_f64(blob) if blob else 0.0

    def db_checksum(self) -> str:
        return self.db.checksum().hex()

    # ------------------------------------------------ balances & accounts

    def get_balance(self, addr: Address, token_id: ContractId) -> int:
        blob = self.db.get(keys.account_balance(str(addr), str(token_id)))
        return blob_to_u64(blob) if blob else 0

    def _set_balance(self, addr: Address, token_id: ContractId, amount: int):
        self.db.update(
            [Put(keys.account_balance(str(addr), str(token_id)), u64_to_blob(amount))]
        )

    def get_contract_balance(self, cid: ContractId, token_id: ContractId) -> int:
        blob = self.db.get(keys.contract_balance(str(cid), str(token_id)))
        return blob_to_u64(blob) if blob else 0

    def get_nonce(self, addr: Address) -> int:
        blob = self.db.get(keys.nonce(str(addr)))
        return blob_to_u32(blob) if blob else 0

    def get_deposit_nonce(self, addr: Address, cid: ContractId) -> int:
        blob = self.db.get(keys.deposit_nonce(str(addr), str(cid)))
        return blob_to_u32(blob) if blob else 0

    def get_token(self, token_id: ContractId) -> Optional[Token]:
        blob = self.db.get(keys.token(str(token_id)))
        return ser.loads(Token, blob) if blob else None

    def get_contract(self, cid: ContractId) -> ZkContract:
        blob = self.db.get(keys.contract(str(cid)))
        if blob is None:
            raise E.Inconsistency(f"contract not found {cid}")
        return ser.loads(ZkContract, blob)

    def get_contract_account(self, cid: ContractId) -> ContractAccount:
        blob = self.db.get(keys.contract_account(str(cid)))
        if blob is None:
            raise E.Inconsistency(f"contract account not found {cid}")
        return ser.loads(ContractAccount, blob)

    def read_state(self, cid: ContractId, locator: Tuple[int, ...]) -> int:
        return self.mgr.get_data(self.db, str(cid), tuple(locator))

    def next_reward(self) -> int:
        return self.get_balance(TREASURY, ContractId.ZIESHA) // self.config.reward_ratio

    def currency_in_circulation(self) -> int:
        total = 0
        for prefix in ("ACB-", "CAB-"):
            for k, v in self.db.pairs(prefix):
                if k.endswith("Ziesha"):
                    total += blob_to_u64(v)
        for _, v in self.db.pairs("DEL-"):
            total += ser.loads(Delegate, v).amount
        for _, v in self.db.pairs("UDL-"):
            total += ser.loads(Undelegation, v).amount
        return total

    # ------------------------------------------------ MPN accessors

    def get_mpn_account_count(self) -> int:
        blob = self.db.get(keys.mpn_account_count())
        return blob_to_u64(blob) if blob else 0

    def get_mpn_account_indices(self, addr: MpnAddress) -> List[int]:
        prefix = keys.mpn_account_index_prefix(str(addr)) + "-"
        return sorted(
            int(k.rsplit("-", 1)[1], 16) for k, _ in self.db.pairs(prefix)
        )

    def get_mpn_account(self, addr: MpnAddress) -> MpnAccount:
        inds = self.get_mpn_account_indices(addr)
        if not inds:
            return MpnAccount()
        cid = str(self.config.mpn_config.mpn_contract_id)
        acc = _sm_get_mpn_account(self.mgr, self.db, cid, inds[0])
        if acc.address != (0, 0) and acc.address != addr.pub_key.decompress():
            raise E.Inconsistency("mpn index mismatch")
        return acc

    def get_mpn_accounts(self, page: int, page_size: int):
        cid = str(self.config.mpn_config.mpn_contract_id)
        return _sm_get_mpn_accounts(self.mgr, self.db, cid, page, page_size)

    # ------------------------------------------------ staking accessors

    def get_staker(self, addr: Address) -> Optional[Staker]:
        blob = self.db.get(keys.staker(str(addr)))
        return ser.loads(Staker, blob) if blob else None

    def get_stake(self, addr: Address) -> int:
        blob = self.db.get(keys.stake(str(addr)))
        return blob_to_u64(blob) if blob else 0

    def get_stakers(self) -> List[Tuple[str, int]]:
        out = []
        for k, _ in self.db.pairs(keys.staker_rank_prefix()):
            _, inv_amount, addr = k.split("-", 2)
            amount = keys.rank_amount(inv_amount)
            if amount > 0:
                out.append((addr, amount))
        return out

    def get_delegate(self, delegator: Address, delegatee: Address) -> Delegate:
        blob = self.db.get(keys.delegate(str(delegator), str(delegatee)))
        return ser.loads(Delegate, blob) if blob else Delegate(0)

    def get_delegators(self, delegatee: Address, top: Optional[int] = None):
        out = []
        for k, _ in self.db.pairs(keys.delegator_rank_prefix(str(delegatee))):
            parts = k.split("-")
            amount = keys.rank_amount(parts[2])
            out.append((parts[3], amount))
            if top is not None and len(out) >= top:
                break
        return out

    def get_delegatees(self, delegator: Address, top: Optional[int] = None):
        out = []
        for k, _ in self.db.pairs(keys.delegatee_rank_prefix(str(delegator))):
            parts = k.split("-")
            amount = keys.rank_amount(parts[2])
            out.append((parts[3], amount))
            if top is not None and len(out) >= top:
                break
        return out

    def get_auto_delegate_ratio(self, delegator: Address, delegatee: Address) -> Ratio:
        blob = self.db.get(keys.auto_delegate(str(delegator), str(delegatee)))
        return Ratio(blob[0]) if blob else Ratio(0)

    def get_undelegation(self, undelegator: Address, undelegation_id: str):
        blob = self.db.get(keys.undelegation(str(undelegator), undelegation_id))
        return ser.loads(Undelegation, blob) if blob else None

    def get_undelegations(self, undelegator: Address):
        out = []
        for k, v in self.db.pairs(keys.undelegation_prefix(str(undelegator))):
            out.append((k.rsplit("-", 1)[1], ser.loads(Undelegation, v)))
        return out

    # ------------------------------------------------ consensus

    def epoch_slot(self, timestamp: int) -> Tuple[int, int]:
        rel = max(0, timestamp - self.config.chain_start_timestamp)
        index = rel // self.config.slot_duration
        return (index // self.config.slot_per_epoch, index % self.config.slot_per_epoch)

    def epoch_randomness(self) -> bytes:
        blob = self.db.get(keys.randomness())
        return blob if blob else bytes(32)

    def _staker_chances(self) -> Dict[str, float]:
        stakers = self.get_stakers()
        total = sum(a for _, a in stakers)
        if total == 0:
            return {}
        return {addr: amount / total for addr, amount in stakers}

    def is_validator(self, timestamp: int, addr: Address, proof: ValidatorProof) -> bool:
        """Stake-weighted VRF election (reference: mod.rs:564-604)."""
        tip_epoch = self.epoch_slot(self.get_tip().proof_of_stake.timestamp)[0]
        epoch, slot = self.epoch_slot(timestamp)
        if epoch > tip_epoch and proof.attempt != 0:
            return False
        chances = self._staker_chances()
        chance = chances.get(str(addr))
        if chance is None:
            return False
        staker = self.get_staker(addr)
        if staker is None:
            return False
        if proof.vrf_output.as_float() > chance:
            return False
        preimage = (
            f"{self.epoch_randomness().hex()}-{epoch}-{slot}-{proof.attempt}"
        ).encode()
        return VRF.verify(
            VrfPublicKey.parse(staker.vrf_pub_key),
            preimage,
            proof.vrf_output,
            proof.vrf_proof,
        )

    def validator_status(self, timestamp: int, wallet) -> Optional[ValidatorProof]:
        """Try up to 3 attempts (reference: mod.rs:606-613)."""
        tip_epoch = self.epoch_slot(self.get_tip().proof_of_stake.timestamp)[0]
        epoch, slot = self.epoch_slot(timestamp)
        attempts = 1 if epoch > tip_epoch else MAX_ATTEMPTS
        chances = self._staker_chances()
        chance = chances.get(str(wallet.get_address()))
        if chance is None:
            return None
        randomness = self.epoch_randomness()
        for attempt in range(attempts):
            out, proof = wallet.generate_random(randomness, epoch, slot, attempt)
            if out.as_float() <= chance:
                return ValidatorProof(attempt, out, proof)
        return None

    def will_extend(self, from_height: int, headers: List[Header]) -> bool:
        """Fork choice by cumulative power (reference: mod.rs:412-455)."""
        if from_height == 0:
            raise E.ExtendFromGenesis()
        if from_height > self.get_height():
            raise E.ExtendFromFuture()
        last_header = self.get_header(from_height - 1)
        sum_powers = sum(
            (h.proof_of_stake.proof.power() if h.proof_of_stake.proof else 1.0)
            for h in headers
        )
        if self.get_power_at(from_height) + sum_powers <= self.get_power():
            return False
        for h in headers:
            last_es = self.epoch_slot(last_header.proof_of_stake.timestamp)
            h_es = self.epoch_slot(h.proof_of_stake.timestamp)
            if h_es <= last_es:
                raise E.InvalidEpochSlot()
            if h.number != last_header.number + 1:
                raise E.InvalidBlockNumber()
            if h.parent_hash != last_header.hash():
                raise E.InvalidParentHash()
            last_header = h
        return True

    def extend(self, from_height: int, blocks: List[Block]):
        def body(chain):
            if from_height == 0:
                raise E.ExtendFromGenesis()
            if from_height > chain.get_height():
                raise E.ExtendFromFuture()
            while chain.get_height() > from_height:
                chain.rollback()
            for block in blocks:
                chain.apply_block(block)

        ops, _ = self.isolated(body)
        self.db.update(ops)

    def rollback(self):
        def body(chain):
            height = chain.get_height()
            if height == 0:
                raise E.NoBlocksToRollback()
            blob = chain.db.get(keys.rollback(height - 1))
            if blob is None:
                raise E.Inconsistency("missing rollback data")
            chain.db.update(blob_to_ops(blob))
            chain.db.update([Remove(keys.rollback(height - 1))])

        ops, _ = self.isolated(body)
        self.db.update(ops)

    # ------------------------------------------------ block production

    def draft_block(
        self, timestamp: int, mempool: List[TransactionAndDelta], wallet, check: bool = True
    ) -> Optional[Block]:
        if self.get_height() == 0:
            raise E.BlockchainEmpty()
        validator_status = self.validator_status(timestamp, wallet)
        if self.config.check_validator and validator_status is None:
            return None
        last_header = self.get_header(self.get_height() - 1)
        tx_and_deltas = self.select_transactions(wallet.get_address(), mempool, check)
        blk = Block(
            header=Header(
                parent_hash=last_header.hash(),
                number=self.get_height(),
                block_root=bytes(32),
                proof_of_stake=ProofOfStake(
                    timestamp=timestamp,
                    validator=wallet.get_address(),
                    proof=validator_status,
                ),
            ),
            body=[td.tx for td in tx_and_deltas],
        )
        blk.header.block_root = blk.merkle_tree().root()
        try:
            self.isolated(lambda chain: chain.apply_block(blk))
        except E.InsufficientMpnUpdates:
            return None
        return blk

    def select_transactions(
        self, validator: Address, txs: List[TransactionAndDelta], check: bool = True
    ) -> List[TransactionAndDelta]:
        """Greedy fee-ordered selection with isolated-fork validation
        (reference: ops/select_transactions.rs)."""
        sorted_txs = [t for t in txs if t.tx.fee.token_id == ContractId.ZIESHA]

        def sort_key(td: TransactionAndDelta):
            cost = len(ser.dumps(td.tx))
            is_mpn = (
                td.tx.data.kind == "update_contract"
                and td.tx.data.contract_id == self.config.mpn_config.mpn_contract_id
            )
            return (is_mpn, td.tx.fee.amount // max(cost, 1), -td.tx.nonce)

        sorted_txs.sort(key=sort_key)
        if not check:
            return sorted_txs

        def body(chain):
            chain.pay_validator_and_delegators(validator, 0)
            result = []
            block_sz = 0
            for td in reversed(sorted_txs):
                try:
                    ops, _ = chain.isolated(lambda c: c.apply_tx(td.tx, False))
                except E.BlockchainError:
                    continue
                diff = len(ser.dumps(td.tx))
                if block_sz + diff <= chain.config.max_block_size and td.tx.verify_signature():
                    block_sz += diff
                    chain.db.update(ops)
                    result.append(td)
            return result

        _, result = self.isolated(body)
        return result

    # ------------------------------------------------ applying blocks

    def apply_block(self, block: Block):
        ops, _ = self.isolated(lambda chain: chain._apply_block_inner(block))
        self.db.update(ops)

    def _apply_block_inner(self, block: Block):
        curr_height = self.get_height()
        curr_pow = self.get_power()
        cfg = self.config

        if cfg.testnet_height_limit is not None:
            if block.header.number >= cfg.testnet_height_limit:
                raise E.TestnetHeightLimitReached()

        is_genesis = block.header.number == 0
        if is_genesis:
            model = ListModel(cfg.teleport_log4_tree_size, Struct([SCALAR, SCALAR]))
            teleport = ZkContract(ZkCompressedState.empty(model), model)
            self.db.update(
                [Put(keys.contract(str(cfg.teleport_contract_id)), ser.dumps(teleport))]
            )

        if curr_height > 0:
            if block.merkle_tree().root() != block.header.block_root:
                raise E.InvalidMerkleRoot()
            self.will_extend(curr_height, [block.header])

        if not is_genesis:
            if cfg.check_validator:
                proof = block.header.proof_of_stake.proof
                if proof is None:
                    raise E.ValidatorProofNotGiven()
                curr_pow += proof.power()
                if not self.is_validator(
                    block.header.proof_of_stake.timestamp,
                    block.header.proof_of_stake.validator,
                    proof,
                ):
                    raise E.UnelectedValidator()
            else:
                curr_pow += 1.0  # tests only
            fee_sum = sum(t.fee.amount for t in block.body)
            self.pay_validator_and_delegators(
                block.header.proof_of_stake.validator, fee_sum
            )

        if not is_genesis and not all(tx.verify_signature() for tx in block.body):
            raise E.SignatureError()

        body_size = 0
        num_calls = num_deposits = num_withdraws = 0
        for tx in block.body:
            if (
                tx.data.kind == "update_contract"
                and tx.data.contract_id == cfg.mpn_config.mpn_contract_id
            ):
                for upd in tx.data.updates:
                    if upd.data.kind == "deposit":
                        num_deposits += 1
                    elif upd.data.kind == "withdraw":
                        num_withdraws += 1
                    elif upd.data.kind == "function_call":
                        num_calls += 1
            body_size += len(ser.dumps(tx))
            self.apply_tx(tx, is_genesis)

        if not is_genesis and (
            num_calls < cfg.mpn_config.mpn_num_update_batches
            or num_deposits < cfg.mpn_config.mpn_num_deposit_batches
            or num_withdraws < cfg.mpn_config.mpn_num_withdraw_batches
        ):
            raise E.InsufficientMpnUpdates()

        if body_size > cfg.max_block_size:
            raise E.BlockTooBig()

        if curr_height > 0:
            tip_epoch = self.epoch_slot(self.get_tip().proof_of_stake.timestamp)[0]
            block_epoch = self.epoch_slot(block.header.proof_of_stake.timestamp)[0]
            if block_epoch > tip_epoch:
                # new randomness = H(H(tip) | VRF_out)
                preimage = self.get_tip().hash()
                proof = block.header.proof_of_stake.proof
                if proof is not None:
                    if proof.attempt != 0:
                        raise E.RandomnessChangeNotPermitted()
                    preimage += proof.vrf_output.to_bytes()
                self.db.update([Put(keys.randomness(), Sha3Hasher.hash(preimage))])

        self.db.update(
            [
                Put(keys.power_at(curr_height + 1), f64_to_blob(curr_pow)),
                Put(keys.height(), u64_to_blob(curr_height + 1)),
                Put(keys.header(block.header.number), ser.dumps(block.header)),
                Put(keys.block(block.header.number), ser.dumps(block)),
                Put(
                    keys.merkle(block.header.number),
                    b"".join(tx.hash() for tx in block.body),
                ),
            ]
        )
        rollback_ops = self.db.rollback_ops()
        self.db.update(
            [Put(keys.rollback(block.header.number), ops_to_blob(rollback_ops))]
        )

    # ------------------------------------------------ applying txs

    def apply_tx(self, tx: Transaction, internal: bool = False):
        ops, _ = self.isolated(lambda chain: chain._apply_tx_inner(tx, internal))
        self.db.update(ops)

    def _apply_tx_inner(self, tx: Transaction, internal: bool):
        cfg = self.config
        if tx.src is None and not internal:
            raise E.IllegalTreasuryAccess()
        if tx.fee.token_id != ContractId.ZIESHA:
            raise E.OnlyZieshaFeesAccepted()
        if len(tx.memo) > cfg.max_memo_length:
            raise E.MemoTooLong()
        tx_src = tx.src if tx.src is not None else TREASURY

        acc_nonce = self.get_nonce(tx_src)
        acc_bal = self.get_balance(tx_src, tx.fee.token_id)
        if (not internal and tx.nonce != acc_nonce + 1) or (internal and tx.nonce != 0):
            raise E.InvalidTransactionNonce()
        if acc_bal < tx.fee.amount:
            raise E.BalanceInsufficient()
        if not internal:
            self.db.update([Put(keys.nonce(str(tx_src)), u32_to_blob(acc_nonce + 1))])
        self._set_balance(tx_src, tx.fee.token_id, acc_bal - tx.fee.amount)

        d = tx.data
        if d.kind == "update_staker":
            self._op_update_staker(tx_src, d.vrf_pub_key, d.commission)
        elif d.kind == "delegate":
            self._op_delegate(tx_src, d.amount, d.to)
        elif d.kind == "auto_delegate":
            self.db.update(
                [Put(keys.auto_delegate(str(tx_src), str(d.to)), bytes([d.ratio.value]))]
            )
        elif d.kind == "undelegate":
            undelegation_id = tx.hash().hex()
            self._op_undelegate(undelegation_id, tx_src, d.amount, d.frm)
        elif d.kind == "regular_send":
            self._op_regular_send(tx_src, d.entries)
        elif d.kind == "create_contract":
            cid = ContractId.from_tx(tx)
            # the genesis Ziesha-token contract IS the Ziesha asset
            # (reference: apply_tx/mod.rs:127-134)
            if cid == cfg.ziesha_token_id:
                cid = ContractId.ZIESHA
            self._op_create_contract(tx_src, cid, d.contract, d.state, d.money)
        elif d.kind == "update_contract":
            self._op_update_contract(tx_src, d.contract_id, d.updates, d.delta)
        else:
            raise E.BlockchainError(f"unknown tx kind {d.kind}")

        # fees go to the treasury (reference: apply_tx/mod.rs:153-161)
        if tx.src is not None:
            treasury_balance = self.get_balance(TREASURY, tx.fee.token_id)
            self._set_balance(TREASURY, tx.fee.token_id, treasury_balance + tx.fee.amount)

    # -- individual ops (reference: src/blockchain/ops/apply_tx/*)

    def _op_update_staker(self, tx_src, vrf_pub_key: str, commission: Ratio):
        commission = min(
            commission, self.config.max_validator_commission, key=lambda r: r.value
        )
        self.db.update(
            [Put(keys.staker(str(tx_src)), ser.dumps(Staker(vrf_pub_key, commission)))]
        )

    def _op_delegate(self, tx_src, amount: int, to):
        src_bal = self.get_balance(tx_src, ContractId.ZIESHA)
        if src_bal < amount:
            raise E.BalanceInsufficient()
        self._set_balance(tx_src, ContractId.ZIESHA, src_bal - amount)
        delegate = self.get_delegate(tx_src, to)
        old_amount = delegate.amount
        new_amount = old_amount + amount
        self.db.update(
            [Put(keys.delegate(str(tx_src), str(to)), ser.dumps(Delegate(new_amount)))]
        )
        old_stake = self.get_stake(to)
        new_stake = old_stake + amount
        self.db.update(
            [
                Remove(keys.delegatee_rank(str(tx_src), old_amount, str(to))),
                Put(keys.delegatee_rank(str(tx_src), new_amount, str(to)), b""),
                Remove(keys.delegator_rank(str(to), old_amount, str(tx_src))),
                Put(keys.delegator_rank(str(to), new_amount, str(tx_src)), b""),
                Remove(keys.staker_rank(old_stake, str(to))),
                Put(keys.staker_rank(new_stake, str(to)), b""),
                Put(keys.stake(str(to)), u64_to_blob(new_stake)),
            ]
        )

    def _op_undelegate(self, undelegation_id: str, tx_src, amount: int, frm):
        unlocks_on = self.get_height() + 10
        delegate = self.get_delegate(tx_src, frm)
        old_amount = delegate.amount
        if old_amount < amount:
            raise E.BalanceInsufficient()
        new_amount = old_amount - amount
        self.db.update(
            [Put(keys.delegate(str(tx_src), str(frm)), ser.dumps(Delegate(new_amount)))]
        )
        old_stake = self.get_stake(frm)
        if old_stake < amount:
            raise E.Inconsistency("stake below delegation")
        new_stake = old_stake - amount
        self.db.update(
            [
                Put(
                    keys.undelegation(str(tx_src), undelegation_id),
                    ser.dumps(Undelegation(amount, unlocks_on)),
                ),
                Put(keys.undelegation_callback(unlocks_on, f"{tx_src}-{undelegation_id}"), b""),
                Remove(keys.delegatee_rank(str(tx_src), old_amount, str(frm))),
                Put(keys.delegatee_rank(str(tx_src), new_amount, str(frm)), b""),
                Remove(keys.delegator_rank(str(frm), old_amount, str(tx_src))),
                Put(keys.delegator_rank(str(frm), new_amount, str(tx_src)), b""),
                Remove(keys.staker_rank(old_stake, str(frm))),
                Put(keys.staker_rank(new_stake, str(frm)), b""),
                Put(keys.stake(str(frm)), u64_to_blob(new_stake)),
            ]
        )

    def _op_regular_send(self, tx_src, entries: List[RegularSendEntry]):
        for entry in entries:
            if entry.dst == tx_src:
                continue
            src_bal = self.get_balance(tx_src, entry.amount.token_id)
            if src_bal < entry.amount.amount:
                raise E.BalanceInsufficient()
            self._set_balance(tx_src, entry.amount.token_id, src_bal - entry.amount.amount)
            dst_bal = self.get_balance(entry.dst, entry.amount.token_id)
            self._set_balance(entry.dst, entry.amount.token_id, dst_bal + entry.amount.amount)
            self._put_in_teleport_tree(entry.dst, entry.amount)

    def _put_in_teleport_tree(self, dst: Address, money: Money):
        """(reference: apply_tx/regular_send.rs:9-32)."""
        cid = str(self.config.teleport_contract_id)
        as_scalar = int.from_bytes(dst.raw[:31], "little")
        height = self.mgr.height_of(self.db, cid)
        commitment = PoseidonHasher.hash([money.token_id.scalar, money.amount, 0])
        self.mgr.update_contract(
            self.db,
            cid,
            {(height, 0): as_scalar, (height, 1): commitment},
            height + 1,
        )

    def _op_create_contract(self, tx_src, cid: ContractId, contract: ZkContract,
                            state, money: Money):
        if not model_is_valid(contract.state_model):
            raise E.InvalidStateModel()
        if contract.token is not None:
            if not contract.token.token.validate():
                raise E.TokenBadNameSymbol()
            self._set_balance(tx_src, cid, contract.token.token.supply)
            self.db.update([Put(keys.token(str(cid)), ser.dumps(contract.token.token))])
        self.db.update([Put(keys.contract(str(cid)), ser.dumps(contract))])
        self.db.update(
            [
                Put(
                    keys.contract_account(str(cid)),
                    ser.dumps(ContractAccount(1, contract.initial_state)),
                )
            ]
        )
        if state is None:
            raise E.StateNotGiven()
        delta = {k: v for k, v in state.items()}
        if cid == self.config.mpn_config.mpn_contract_id:
            self._index_mpn_accounts(delta)
        self.mgr.update_contract(self.db, str(cid), delta, 1)
        if self.mgr.root(self.db, str(cid)) != contract.initial_state:
            raise E.InvalidState()
        src_bal = self.get_balance(tx_src, money.token_id)
        if src_bal < money.amount:
            raise E.BalanceInsufficient()
        self._set_balance(tx_src, money.token_id, src_bal - money.amount)
        dst_bal = self.get_contract_balance(cid, money.token_id)
        self.db.update(
            [
                Put(
                    keys.contract_balance(str(cid), str(money.token_id)),
                    u64_to_blob(dst_bal + money.amount),
                )
            ]
        )

    def _index_mpn_accounts(self, delta: Dict):
        """Track address -> account-index mappings from a state delta
        (reference: apply_tx/mod.rs:14-58)."""
        from ..crypto import jubjub as jj

        acc_count = self.get_mpn_account_count()
        org: Dict[int, Dict[int, int]] = {}
        for loc, v in delta.items():
            if len(loc) == 2 and loc[1] in (2, 3):
                org.setdefault(loc[0], {}).setdefault(loc[1], v or 0)
        for index, data in org.items():
            if 2 not in data or 3 not in data:
                raise E.Inconsistency("partial mpn address delta")
            x, y = data[2], data[3]
            addr = MpnAddress(jj.PublicKey(*jj.compress((x, y))))
            self.db.update([Put(keys.mpn_account_index(str(addr), index), b"")])
        for ind in sorted(org):
            if ind == acc_count:
                acc_count += 1
            elif ind > acc_count:
                raise E.Inconsistency("non-contiguous mpn index")
        self.db.update([Put(keys.mpn_account_count(), u64_to_blob(acc_count))])

    # -- contract updates (reference: apply_tx/update_contract/)

    def _op_update_contract(self, tx_src, cid: ContractId,
                            updates: List[ContractUpdate], delta):
        contract = self.get_contract(cid)
        executor_fees: List[Money] = []
        prev_account = self.get_contract_account(cid)
        cont_account = self.get_contract_account(cid)
        self.db.update(
            [
                Put(
                    keys.contract_account(str(cid)),
                    ser.dumps(
                        ContractAccount(cont_account.height + 1, cont_account.compressed_state)
                    ),
                )
            ]
        )
        for update in updates:
            commit = prover_commitment(update.prover, update.reward)
            src_bal = self.get_balance(tx_src, ContractId.ZIESHA)
            if src_bal < update.reward:
                raise E.BalanceInsufficient()
            self._set_balance(tx_src, ContractId.ZIESHA, src_bal - update.reward)
            prover_bal = self.get_balance(update.prover, ContractId.ZIESHA)
            self._set_balance(update.prover, ContractId.ZIESHA, prover_bal + update.reward)

            if update.data.kind == "deposit":
                circuit, aux_data = self._cu_deposit(
                    cid, contract, update.circuit_id, update.data.deposits, executor_fees
                )
            elif update.data.kind == "withdraw":
                circuit, aux_data = self._cu_withdraw(
                    cid, contract, update.circuit_id, update.data.withdraws, executor_fees
                )
            elif update.data.kind == "function_call":
                circuit, aux_data = self._cu_function_call(
                    cid, contract, update.circuit_id, update.data.fee, executor_fees
                )
            elif update.data.kind == "mint":
                circuit, aux_data = self._cu_mint(
                    cid, contract, update.circuit_id, update.data.amount, executor_fees
                )
            else:
                raise E.BlockchainError("bad contract update kind")

            cont_account = self.get_contract_account(cid)
            if not zkproof.check_proof(
                circuit,
                commit,
                prev_account.height,
                cont_account.compressed_state.state_hash,
                aux_data.state_hash,
                update.next_state.state_hash,
                update.proof,
            ):
                raise E.IncorrectZkProof()
            self.db.update(
                [
                    Put(
                        keys.contract_account(str(cid)),
                        ser.dumps(ContractAccount(cont_account.height, update.next_state)),
                    )
                ]
            )

        for fee in executor_fees:
            bal = self.get_balance(tx_src, fee.token_id)
            self._set_balance(tx_src, fee.token_id, bal + fee.amount)

        cont_account = self.get_contract_account(cid)
        if delta is None:
            raise E.StateNotGiven()
        if cid == self.config.mpn_config.mpn_contract_id:
            self._index_mpn_accounts(delta)
        self.mgr.update_contract(self.db, str(cid), delta, cont_account.height)
        if self.mgr.root(self.db, str(cid)) != cont_account.compressed_state:
            raise E.InvalidState()

    def _cu_deposit(self, cid, contract, circuit_id, deposits, executor_fees):
        from ..mpn.deposit import deposit_aux_model
        from ..zk.state import ZkStateBuilder

        if circuit_id >= len(contract.deposit_functions):
            raise E.ContractFunctionNotFound()
        func = contract.deposit_functions[circuit_id]
        builder = ZkStateBuilder(deposit_aux_model(func.log4_payment_capacity))
        for i, dep in enumerate(deposits):
            if dep.contract_id != cid or dep.deposit_circuit_id != circuit_id:
                raise E.DepositWithdrawPassedToWrongFunction()
            executor_fees.append(dep.fee)
            builder.batch_set(
                {
                    (i, 0): 1,
                    (i, 1): dep.amount.token_id.scalar,
                    (i, 2): dep.amount.amount,
                    (i, 3): dep.calldata,
                }
            )
            self.apply_deposit(dep)
        return func.verifier_key, builder.compress()

    def _cu_withdraw(self, cid, contract, circuit_id, withdraws, executor_fees):
        from ..mpn.withdraw import withdraw_aux_model
        from ..zk.state import ZkStateBuilder

        if circuit_id >= len(contract.withdraw_functions):
            raise E.ContractFunctionNotFound()
        func = contract.withdraw_functions[circuit_id]
        builder = ZkStateBuilder(withdraw_aux_model(func.log4_payment_capacity))
        for i, wd in enumerate(withdraws):
            if wd.contract_id != cid or wd.withdraw_circuit_id != circuit_id:
                raise E.DepositWithdrawPassedToWrongFunction()
            # withdraw fees go to the update executor (reference:
            # ops/apply_tx/update_contract/withdraw.rs:38)
            executor_fees.append(wd.fee)
            builder.batch_set(
                {
                    (i, 0): 1,
                    (i, 1): wd.amount.token_id.scalar,
                    (i, 2): wd.amount.amount,
                    (i, 3): wd.fee.token_id.scalar,
                    (i, 4): wd.fee.amount,
                    (i, 5): wd.fingerprint(),
                    (i, 6): wd.calldata,
                }
            )
            self.apply_withdraw(wd)
        return func.verifier_key, builder.compress()

    def _cu_function_call(self, cid, contract, circuit_id, fee: Money, executor_fees):
        if circuit_id >= len(contract.functions):
            raise E.ContractFunctionNotFound()
        func = contract.functions[circuit_id]
        # fee paid out of the contract's balance
        bal = self.get_contract_balance(cid, fee.token_id)
        if bal < fee.amount:
            raise E.ContractBalanceInsufficient()
        self.db.update(
            [
                Put(
                    keys.contract_balance(str(cid), str(fee.token_id)),
                    u64_to_blob(bal - fee.amount),
                )
            ]
        )
        executor_fees.append(fee)
        # aux_data = Poseidon2(fee_token, fee)
        aux = PoseidonHasher.hash([fee.token_id.scalar, fee.amount])
        return func.verifier_key, ZkCompressedState(aux, 0)

    def _cu_mint(self, cid, contract, circuit_id, amount: int, executor_fees):
        if contract.token is None:
            raise E.ContractFunctionNotFound()
        if circuit_id >= len(contract.token.mint_functions):
            raise E.ContractFunctionNotFound()
        func = contract.token.mint_functions[circuit_id]
        token = self.get_token(cid)
        if token is None:
            raise E.Inconsistency("token missing")
        bal = self.get_contract_balance(cid, cid)
        # amounts are u64-serialized; overflow must reject, mirroring the
        # reference's checked adds (mint.rs:13-15)
        U64_MAX = (1 << 64) - 1
        if bal + amount > U64_MAX or token.supply + amount > U64_MAX:
            raise E.TokenSupplyOverflow()
        token.supply += amount
        self.db.update([Put(keys.token(str(cid)), ser.dumps(token))])
        self.db.update(
            [Put(keys.contract_balance(str(cid), str(cid)), u64_to_blob(bal + amount))]
        )
        # aux_data = compressed Scalar state whose root IS the amount
        # (mint.rs:32-36: ZkStateBuilder over ZkStateModel::Scalar), and the
        # minted amount is credited to the update executor (mint.rs:38-41)
        from ..fields.host import FR_MODULUS

        aux_scalar = amount % FR_MODULUS
        executor_fees.append(Money(cid, amount))
        return func.verifier_key, ZkCompressedState(
            aux_scalar, 1 if aux_scalar else 0
        )

    # -- L1<->contract bridges (reference: ops/apply_deposit.rs, apply_withdraw.rs)

    def apply_deposit(self, deposit: ContractDeposit):
        def body(chain):
            if not deposit.verify_signature():
                raise E.InvalidContractPaymentSignature()
            nonce = chain.get_deposit_nonce(deposit.src, deposit.contract_id)
            if deposit.nonce != nonce + 1:
                raise E.InvalidTransactionNonce()
            chain.db.update(
                [
                    Put(
                        keys.deposit_nonce(str(deposit.src), str(deposit.contract_id)),
                        u32_to_blob(nonce + 1),
                    )
                ]
            )
            if deposit.amount.token_id == deposit.fee.token_id:
                bal = chain.get_balance(deposit.src, deposit.amount.token_id)
                need = deposit.amount.amount + deposit.fee.amount
                if bal < need:
                    raise E.BalanceInsufficient()
                chain._set_balance(deposit.src, deposit.amount.token_id, bal - need)
            else:
                bal = chain.get_balance(deposit.src, deposit.amount.token_id)
                fee_bal = chain.get_balance(deposit.src, deposit.fee.token_id)
                if bal < deposit.amount.amount or fee_bal < deposit.fee.amount:
                    raise E.BalanceInsufficient()
                chain._set_balance(
                    deposit.src, deposit.amount.token_id, bal - deposit.amount.amount
                )
                chain._set_balance(
                    deposit.src, deposit.fee.token_id, fee_bal - deposit.fee.amount
                )
            cbal = chain.get_contract_balance(deposit.contract_id, deposit.amount.token_id)
            chain.db.update(
                [
                    Put(
                        keys.contract_balance(
                            str(deposit.contract_id), str(deposit.amount.token_id)
                        ),
                        u64_to_blob(cbal + deposit.amount.amount),
                    )
                ]
            )

        ops, _ = self.isolated(body)
        self.db.update(ops)

    def apply_withdraw(self, withdraw: ContractWithdraw):
        def body(chain):
            if withdraw.amount.token_id == withdraw.fee.token_id:
                cbal = chain.get_contract_balance(withdraw.contract_id, withdraw.amount.token_id)
                need = withdraw.amount.amount + withdraw.fee.amount
                if cbal < need:
                    raise E.ContractBalanceInsufficient()
                chain.db.update(
                    [
                        Put(
                            keys.contract_balance(
                                str(withdraw.contract_id), str(withdraw.amount.token_id)
                            ),
                            u64_to_blob(cbal - need),
                        )
                    ]
                )
            else:
                cbal = chain.get_contract_balance(withdraw.contract_id, withdraw.amount.token_id)
                fbal = chain.get_contract_balance(withdraw.contract_id, withdraw.fee.token_id)
                if cbal < withdraw.amount.amount or fbal < withdraw.fee.amount:
                    raise E.ContractBalanceInsufficient()
                chain.db.update(
                    [
                        Put(
                            keys.contract_balance(
                                str(withdraw.contract_id), str(withdraw.amount.token_id)
                            ),
                            u64_to_blob(cbal - withdraw.amount.amount),
                        ),
                        Put(
                            keys.contract_balance(
                                str(withdraw.contract_id), str(withdraw.fee.token_id)
                            ),
                            u64_to_blob(fbal - withdraw.fee.amount),
                        ),
                    ]
                )
            bal = chain.get_balance(withdraw.dst, withdraw.amount.token_id)
            chain._set_balance(
                withdraw.dst, withdraw.amount.token_id, bal + withdraw.amount.amount
            )

        ops, _ = self.isolated(body)
        self.db.update(ops)

    # ------------------------------------------------ rewards

    def pay_validator_and_delegators(self, validator: Address, fee_sum: int) -> int:
        """(reference: ops/pay_validator_and_delegators.rs)."""
        height = self.get_height()
        staker = self.get_staker(validator)
        if staker is None:
            raise E.ValidatorNotRegistered()
        next_reward = self.next_reward() + fee_sum
        stakers_reward = next_reward * (1.0 - staker.commission.as_float())
        delegators = self.get_delegators(validator, None)
        total = sum(a for _, a in delegators)
        payments = []
        if total > 0:
            for addr_str, stake in delegators:
                payments.append(
                    (Address.parse(addr_str), int(stake / total * stakers_reward))
                )
        validator_reward = next_reward - sum(a for _, a in payments)
        payments.append((validator, validator_reward))
        for addr, amnt in payments:
            self.apply_tx(
                Transaction(
                    src=None,
                    nonce=0,
                    data=TransactionData(
                        "regular_send",
                        entries=[RegularSendEntry(addr, Money.ziesha(amnt))],
                    ),
                    fee=Money.ziesha(0),
                    memo="",
                ),
                internal=True,
            )
            ratio = self.get_auto_delegate_ratio(addr, validator)
            if ratio.value > 0:
                self.apply_tx(
                    Transaction(
                        src=addr,
                        nonce=0,
                        data=TransactionData(
                            "delegate",
                            amount=int(amnt * ratio.as_float()),
                            to=validator,
                        ),
                        fee=Money.ziesha(0),
                        memo="",
                    ),
                    internal=True,
                )
        # undelegation callbacks that unlock at this height
        for k, _ in list(self.db.pairs(keys.undelegation_callback_prefix(height + 1))):
            tail = k.split("-", 2)[2]
            undelegator_str, undelegation_id = tail.split("-", 1)
            undelegator = Address.parse(undelegator_str)
            undelegation = self.get_undelegation(undelegator, undelegation_id)
            if undelegation is None:
                raise E.Inconsistency("missing undelegation")
            bal = self.get_balance(undelegator, ContractId.ZIESHA)
            self.db.update(
                [
                    Remove(keys.undelegation(str(undelegator), undelegation_id)),
                    Put(
                        keys.account_balance(str(undelegator), str(ContractId.ZIESHA)),
                        u64_to_blob(bal + undelegation.amount),
                    ),
                ]
            )
        return validator_reward

    # ------------------------------------------------ misc

    def min_validator_reward(self, validator: Address) -> int:
        """The reward the validator will receive for the next block (the
        proving-job rewards are carved out of this)."""
        return self.next_reward()

    def check_tx(self, tx: Transaction):
        self.isolated(lambda chain: chain._apply_tx_inner(tx, False))
