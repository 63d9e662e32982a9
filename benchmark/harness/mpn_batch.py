"""One MPN batch for a prover cell, built from the seed by the port's own
witness generators (the batch is the prover's input, as a block is).

A traffic file of driver "prove" names the circuit and the batch:

    {"driver": "prove", "circuit": "withdraw", "accounts": 64,
     "enabled": 64, "deposit": [900, 1100], "amount": [100, 400],
     "fee": [1, 9]}

`accounts` users (keys from the seed) each deposit an amount drawn from
`deposit` of one token into a fresh MPN state (one deposit batch); then
`enabled` of them act, each drawing its amount and fee: "withdraw" withdraws
to its L1 address, "update" pays the next user, and "deposit" makes the
deposits themselves the batch.  The circuit's remaining transitions are its
kind's null transition.  Every seed gives the same sizes: only keys, amounts
and the order of the users change.
"""

from __future__ import annotations

import random

from bazuka_tpu_torch.blockchain.chain import prover_commitment
from bazuka_tpu_torch.core.transaction import ContractId, Money
from bazuka_tpu_torch.db import Put, RamKvStore, keys as db_keys
from bazuka_tpu_torch.mpn import circuits
from bazuka_tpu_torch.mpn.chain_view import MpnChainView
from bazuka_tpu_torch.mpn.config import MpnConfig
from bazuka_tpu_torch.mpn.deposit import deposit
from bazuka_tpu_torch.mpn.transitions import (
    DepositTransition,
    UpdateTransition,
    WithdrawTransition,
)
from bazuka_tpu_torch.mpn.update import update
from bazuka_tpu_torch.mpn.withdraw import withdraw
from bazuka_tpu_torch.utils import ser
from bazuka_tpu_torch.wallet.tx_builder import TxBuilder
from bazuka_tpu_torch.zk.state import ZkCompressedState, ZkContract

KINDS = {
    "deposit": (circuits.DepositCircuit, DepositTransition,
                "log4_deposit_batch_size"),
    "withdraw": (circuits.WithdrawCircuit, WithdrawTransition,
                 "log4_withdraw_batch_size"),
    "update": (circuits.UpdateCircuit, UpdateTransition,
               "log4_update_batch_size"),
}

# the MPN contract and the token of the batch (any ids; the circuit's size
# does not depend on them)
CONTRACT = ContractId(0xBEEF)
TOKEN = ContractId(123)
# the prover who earns the batch's reward (the first public input)
PROVER_SEED, PROVER_REWARD = b"WORKER", 10


def mpn_config(config: dict) -> MpnConfig:
    m = config["mpn"]
    return MpnConfig(m["log4_tree_size"], m["log4_token_tree_size"],
                     m["log4_deposit_batch_size"],
                     m["log4_withdraw_batch_size"],
                     m["log4_update_batch_size"], CONTRACT)


def draw(rng: random.Random, bounds) -> int:
    lo, hi = bounds
    return rng.randint(lo, hi)


def build(config: dict, traffic: dict, seed: int):
    """(circuit, [commitment, height, state, aux_data, next_state]) of the
    batch that `traffic` describes at `config`'s sizes, from `seed`."""
    conf = mpn_config(config)
    cls, null, batch_key = KINDS[traffic["circuit"]]
    log4_batch = getattr(conf, batch_key)
    size = 1 << (2 * log4_batch)
    n_acc, n_on = traffic["accounts"], traffic["enabled"]
    if not 0 < n_on <= min(n_acc, size):
        raise ValueError("enabled must lie in 1..min(accounts, batch)")
    if n_acc > 1 << (2 * conf.log4_deposit_batch_size):
        raise ValueError("the accounts are made by one deposit batch")
    rng = random.Random(seed)
    lt, ltt = conf.log4_tree_size, conf.log4_token_tree_size
    model = conf.state_model()
    db = RamKvStore()
    db.update([Put(db_keys.contract(str(CONTRACT)), ser.dumps(
        ZkContract(ZkCompressedState.empty(model), model)))])
    chain = MpnChainView(db)
    users = [TxBuilder(b"bench-%d-user-%d" % (seed, i)) for i in range(n_acc)]
    rng.shuffle(users)
    deps = [u.deposit_mpn("", CONTRACT, u.get_mpn_address(), 1,
                          Money(TOKEN, draw(rng, traffic["deposit"])),
                          Money.ziesha(0)) for u in users]
    if traffic["circuit"] == "deposit":
        _, pubs, transitions = deposit(
            CONTRACT, lt, ltt, log4_batch, chain, deps[:n_on], {},
            check_balance=False)
        extra = {}
    else:
        idx = {}
        deposit(CONTRACT, lt, ltt, conf.log4_deposit_batch_size, chain,
                deps, idx, check_balance=False)
        for addr, i in idx.items():
            chain.add_mpn_account_index(addr, i)
        acting = users[:n_on]
        if traffic["circuit"] == "withdraw":
            txs = [u.withdraw_mpn(
                "", CONTRACT, 1, Money(TOKEN, draw(rng, traffic["amount"])),
                Money(TOKEN, draw(rng, traffic["fee"])), u.get_address())
                for u in acting]
            _, pubs, transitions = withdraw(CONTRACT, lt, ltt, log4_batch,
                                            chain, txs, {})
            extra = {}
        else:
            txs = [u.create_mpn_transaction(
                acting[(i + 1) % n_on].get_mpn_address(),
                Money(TOKEN, draw(rng, traffic["amount"])),
                Money(TOKEN, draw(rng, traffic["fee"])), 1)
                for i, u in enumerate(acting)]
            _, pubs, transitions = update(CONTRACT, lt, ltt, log4_batch,
                                          TOKEN, chain, txs, {})
            extra = {"fee_token": TOKEN.scalar}
    if len(transitions) != n_on:
        raise RuntimeError(f"the witness generator took {len(transitions)} "
                           f"of {n_on} transactions")
    commitment = prover_commitment(TxBuilder(PROVER_SEED).get_address(),
                                   PROVER_REWARD)
    inputs = [commitment, *pubs.as_list()]
    circuit = cls(lt, ltt, log4_batch, *inputs, transitions=list(
        transitions) + [null.null(lt, ltt) for _ in range(size - n_on)],
        **extra)
    return circuit, inputs
