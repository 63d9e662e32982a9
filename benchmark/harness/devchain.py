"""The validator's side of a dev chain's blocks, for a cell of driver
"chain" (rewritten from the `DevChain` of `chip_smoke.py`).

A traffic file of driver "chain" gives the users and the amounts:

    {"driver": "chain", "users": 3, "withdrawers": 2, "l1_funds": 100000,
     "deposit": [900, 1100], "pay": [50, 150], "fee": [1, 9],
     "withdraw": [20, 80]}

Before block 1 the users (keys from the seed) are funded on L1 and the
validator is registered as a staker.  Odd blocks: each user deposits an
amount drawn from `deposit` into the MPN contract, and the validator's
reward self-deposit rides the same batch.  Even blocks: user i pays user
i + 1 (mod users) an amount from `pay` with a fee from `fee`, and the first
`withdrawers` users withdraw an amount from `withdraw` to their L1 address.
Every block has the same shape whatever the seed: only keys, amounts and
the order of the users change.  `sent` keeps what each block sent, for the
reference's arithmetic.
"""

from __future__ import annotations

import random

from bazuka_tpu_torch.blockchain import KvStoreChain
from bazuka_tpu_torch.blockchain.chain import TREASURY
from bazuka_tpu_torch.core.money import Ratio
from bazuka_tpu_torch.core.transaction import ContractId, Money
from bazuka_tpu_torch.db import RamKvStore
from bazuka_tpu_torch.mpn.workpool import MpnWorker, prepare_works
from bazuka_tpu_torch.wallet.tx_builder import TxBuilder

from .mpn_batch import KINDS

# the work rewards, in percent of the validator's reward, as the node's
# heartbeat pays them (bazuka_tpu_torch/node/heartbeat.py)
WORK_PERCENT = {"deposit": 5, "withdraw": 5, "update": 15}


class DevChain:
    def __init__(self, conf, traffic: dict, seed: int):
        self.conf, self.traffic = conf, traffic
        self.rng = random.Random(seed)
        self.cid = conf.mpn_config.mpn_contract_id
        self.chain = KvStoreChain(RamKvStore(), conf)
        self.validator = TxBuilder(b"bench-%d-validator" % seed)
        self.worker = TxBuilder(b"bench-%d-worker" % seed)
        n = traffic["users"]
        if n >= 1 << (2 * conf.mpn_config.log4_deposit_batch_size):
            raise ValueError("the validator's self-deposit needs a slot of "
                             "each deposit batch")
        self.users = [TxBuilder(b"bench-%d-user-%d" % (seed, i))
                      for i in range(n)]
        self.rng.shuffle(self.users)
        self.withdrawers = self.users[:traffic["withdrawers"]]
        zsh = ContractId.ZIESHA
        for u in self.users:
            self.chain._set_balance(u.get_address(), zsh,
                                    traffic["l1_funds"])
        v = self.validator.get_address()
        self.chain.apply_tx(self.validator.register_validator(
            "", Ratio(12), Money.ziesha(0), self.chain.get_nonce(v) + 1).tx)
        self.treasury = self.chain.get_balance(TREASURY, zsh)
        self.sent = []

    def draw(self, key: str) -> int:
        lo, hi = self.traffic[key]
        return self.rng.randint(lo, hi)

    def mpn_txs(self, block: int):
        """(deposits, withdraws, transfers) of block `block` (1-based),
        noted in `sent`."""
        zsh, chain, users = Money.ziesha, self.chain, self.users
        if block % 2:
            amounts = [self.draw("deposit") for _ in users]
            self.sent.append({"deposit": amounts})
            return [u.deposit_mpn(
                "", self.cid, u.get_mpn_address(),
                chain.get_deposit_nonce(u.get_address(), self.cid) + 1,
                zsh(a), zsh(0)) for u, a in zip(users, amounts)], [], []
        acc = [chain.get_mpn_account(u.get_mpn_address()) for u in users]
        n = len(users)
        out = [self.draw("withdraw") for _ in self.withdrawers]
        pays = [self.draw("pay") for _ in users]
        fees = [self.draw("fee") for _ in users]
        self.sent.append({"withdraw": out, "pay": pays, "fee": fees})
        withdraws = [u.withdraw_mpn(
            "", self.cid, a.withdraw_nonce + 1, zsh(w), zsh(0),
            u.get_address())
            for u, a, w in zip(self.withdrawers, acc, out)]
        transfers = [users[i].create_mpn_transaction(
            users[(i + 1) % n].get_mpn_address(), zsh(pays[i]), zsh(fees[i]),
            acc[i].tx_nonce + 1) for i in range(n)]
        return [], withdraws, transfers

    def prepare(self, block: int):
        v = self.validator.get_address()
        reward = self.chain.min_validator_reward(v)
        return prepare_works(
            self.conf.mpn_config, self.chain,
            {"worker": MpnWorker(self.worker.get_address())},
            *self.mpn_txs(block), reward,
            *(reward // 100 * WORK_PERCENT[k] for k in KINDS),
            self.chain.get_deposit_nonce(v, self.cid),
            self.validator, self.validator)

    def draft(self, pool, block: int):
        """The drafted block of the pool's update transaction."""
        td = pool.ready(self.validator, self.chain.get_nonce(
            self.validator.get_address()) + 1)
        if td is None:
            raise RuntimeError("the work pool is not ready")
        blk = self.chain.draft_block(block * self.conf.slot_duration, [td],
                                     self.validator)
        if blk is None or len(blk.body) != 1:
            raise RuntimeError("the chain drafted no block of the pool's "
                               "update")
        return blk

    def state(self) -> dict:
        """The balances and the contract's height as the chain reads
        them."""
        chain, zsh = self.chain, ContractId.ZIESHA

        def mpn(b):
            acc = chain.get_mpn_account(b.get_mpn_address())
            return sum(m.amount for m in acc.tokens.values()
                       if m.token_id == zsh)
        return {
            "mpn": [mpn(u) for u in self.users],
            "l1": [chain.get_balance(u.get_address(), zsh)
                   for u in self.users],
            "validator_mpn": mpn(self.validator),
            "worker_l1": chain.get_balance(self.worker.get_address(), zsh),
            "contract_height": chain.get_contract_account(self.cid).height}
