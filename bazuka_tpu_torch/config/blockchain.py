"""Genesis assembly & chain presets (reference: src/config/blockchain.rs).

`get_blockchain_config()` builds the mainnet-shaped chain (4^15 account
tree, batch sizes 4^3/4^3/4^4); `get_test_blockchain_config()` the test
chain with Dummy verifier keys, no required MPN batches, and
check_validator off — so consensus logic is testable without proving
(reference: src/config/blockchain.rs:457-544).
A copy of `bazuka_tpu/config/blockchain.py`.
"""

from __future__ import annotations

from typing import Optional

from ..blockchain.config import BlockchainConfig
from ..core.blocks import Block
from ..core.header import Header, ProofOfStake
from ..core.money import Ratio
from ..core.token import Token
from ..core.transaction import (
    ContractId,
    Money,
    RegularSendEntry,
    Transaction,
    TransactionData,
)
from ..crypto.ed25519 import PublicKey as Address
from ..mpn.config import MpnConfig
from ..wallet.tx_builder import TxBuilder
from ..zk.proof import (
    ZkMultiInputVerifierKey,
    ZkSingleInputVerifierKey,
    ZkTokenContract,
    ZkVerifierKey,
)
from ..zk.state import SCALAR, ZkCompressedState, ZkContract

UNIT_ZEROS = 9
UNIT = 10**UNIT_ZEROS

MPN_LOG4_TREE_SIZE = 15
MPN_LOG4_TOKENS_TREE_SIZE = 3
MPN_LOG4_DEPOSIT_BATCH_SIZE = 3
MPN_LOG4_WITHDRAW_BATCH_SIZE = 3
MPN_LOG4_UPDATE_BATCH_SIZE = 4

CHAIN_START_TIMESTAMP = 1678976362
TESTNET_HEIGHT_LIMIT = 1_000_000
MB = 1_000_000

TREASURY = Address(bytes(32))


def get_ziesha_token_creation_tx() -> Transaction:
    return Transaction(
        src=None,
        nonce=0,
        data=TransactionData(
            "create_contract",
            contract=ZkContract(
                initial_state=ZkCompressedState.empty(SCALAR),
                state_model=SCALAR,
                token=ZkTokenContract(
                    token=Token("Ziesha", "ZSH", 2_000_000_000 * UNIT, UNIT_ZEROS, None)
                ),
            ),
            money=Money.ziesha(0),
            state={},
        ),
        fee=Money.ziesha(0),
        memo="Happy Birthday Ziesha!",
    )


def get_mpn_contract_tx(
    log4_tree_size: int,
    log4_token_tree_size: int,
    log4_deposit_batch_size: int,
    log4_withdraw_batch_size: int,
    deposit_vk: ZkVerifierKey,
    withdraw_vk: ZkVerifierKey,
    update_vk: ZkVerifierKey,
    initial_balances=(),
) -> Transaction:
    """MPN contract-creation tx.  With `initial_balances` (MpnAddress,
    amount) pairs, the initial state holds those L2 accounts — pub key at
    [i,2]/[i,3], a Ziesha token slot at [i,4,0,*] — and the tx moves the
    L1 sum into the contract (reference: src/config/blockchain.rs:70-147)."""
    from ..zk.state import ZkStateBuilder

    config = MpnConfig(
        log4_tree_size=log4_tree_size,
        log4_token_tree_size=log4_token_tree_size,
        log4_deposit_batch_size=log4_deposit_batch_size,
        log4_withdraw_batch_size=log4_withdraw_batch_size,
        log4_update_batch_size=0,
        mpn_contract_id=ContractId.NULL,
    )
    model = config.state_model()
    if initial_balances:
        builder = ZkStateBuilder(model)
        data = {}
        sum_amount = 0
        for i, (addr, amount) in enumerate(initial_balances):
            pt = addr.pub_key.decompress()
            entries = {
                (i, 2): pt[0],
                (i, 3): pt[1],
                (i, 4, 0, 0): ContractId.ZIESHA.scalar,
                (i, 4, 0, 1): amount,
            }
            data.update(entries)
            builder.batch_set(entries)
            sum_amount += amount
        initial_state = builder.compress()
        money = Money.ziesha(sum_amount)
    else:
        data = {}
        initial_state = ZkCompressedState.empty(model)
        money = Money.ziesha(0)
    contract = ZkContract(
        initial_state=initial_state,
        state_model=model,
        deposit_functions=[
            ZkMultiInputVerifierKey(deposit_vk, log4_deposit_batch_size)
        ],
        withdraw_functions=[
            ZkMultiInputVerifierKey(withdraw_vk, log4_withdraw_batch_size)
        ],
        functions=[ZkSingleInputVerifierKey(update_vk)],
    )
    return Transaction(
        src=None,
        nonce=0,
        data=TransactionData(
            "create_contract", contract=contract, money=money, state=data
        ),
        fee=Money.ziesha(0),
        memo="A Payment-Network to rule them all!",
    )


def _genesis_header() -> Header:
    return Header(
        parent_hash=bytes(32),
        number=0,
        block_root=bytes(32),
        proof_of_stake=ProofOfStake(
            validator=TREASURY, timestamp=CHAIN_START_TIMESTAMP, proof=None
        ),
    )


def load_initial_balances(path: str | None = None):
    """Mainnet L1 initial balances — 3254 (ed25519 address, amount)
    entries extracted from the reference's src/config/initials.rs by
    tools/extract_initials.py (protocol constants)."""
    import importlib.resources as res
    import json

    if path is not None:
        data = json.loads(open(path).read())
    else:
        data = json.loads(
            (res.files("bazuka_tpu_torch.config") / "data" / "initial_balances.json")
            .read_text()
        )
    return [(Address.parse(addr), int(amount)) for addr, amount in data]


def load_initial_mpn_balances():
    """Mainnet L2 (MPN) initial balances — 211 (MpnAddress, amount)
    entries from the reference's initials.rs."""
    import importlib.resources as res
    import json

    from ..core.address import MpnAddress

    data = json.loads(
        (res.files("bazuka_tpu_torch.config") / "data" / "initial_mpn_balances.json")
        .read_text()
    )
    return [(MpnAddress.parse(addr), int(amount)) for addr, amount in data]


def load_mainnet_vks() -> dict:
    """The three MPN ceremony VKs, decoded from the reference's hardcoded
    bincode blobs (src/config/blockchain.rs:31-38; extracted to
    zk/data/mpn_*_vk.bin by tools/extract_mpn_vks.py).  Every point is
    re-validated (on-curve + prime-order subgroup) on load; a missing or
    corrupt file raises — the mainnet config must NEVER fall back to
    dummy verifier keys (cf. the reference's #[cfg(test)] Dummy gating)."""
    import importlib.resources as res

    from ..zk.wire import decode_vk, validate_vk_points

    out = {}
    data_dir = res.files("bazuka_tpu_torch.zk") / "data"
    for name in ("deposit", "withdraw", "update"):
        raw = (data_dir / f"mpn_{name}_vk.bin").read_bytes()
        vk = decode_vk(raw)
        err = validate_vk_points(vk)
        if err is not None:
            raise ValueError(f"mainnet {name} VK invalid: {err}")
        out[name] = ZkVerifierKey.groth16(vk)
    return out


FIRST_STAKER = "ed744735b5239d32a5b5b6441474bf65a6aaa6bfcf8905d4616f1acc14cf3847f0"
FIRST_STAKER_VRF = "vrf2a3531b9978e7d1293fa58b4f04cb8d78c72f681b58cd664703c3b0f2a531e04"


def blockchain_config_template(
    deposit_vk=None, withdraw_vk=None, update_vk=None, with_initials=False
) -> BlockchainConfig:
    """Mainnet-shaped chain config.  With `with_initials`, the genesis
    carries the full reference launch state: 211 L2 MPN accounts inside
    the contract's initial state, the first staker + treasury delegation,
    and 3254 L1 airdrop sends (reference: src/config/blockchain.rs:230-315)."""
    if deposit_vk is None or withdraw_vk is None or update_vk is None:
        mainnet = load_mainnet_vks()
        deposit_vk = deposit_vk or mainnet["deposit"]
        withdraw_vk = withdraw_vk or mainnet["withdraw"]
        update_vk = update_vk or mainnet["update"]
    dvk, wvk, uvk = deposit_vk, withdraw_vk, update_vk
    mpn_tx = get_mpn_contract_tx(
        MPN_LOG4_TREE_SIZE,
        MPN_LOG4_TOKENS_TREE_SIZE,
        MPN_LOG4_DEPOSIT_BATCH_SIZE,
        MPN_LOG4_WITHDRAW_BATCH_SIZE,
        dvk, wvk, uvk,
        initial_balances=load_initial_mpn_balances() if with_initials else (),
    )
    mpn_contract_id = ContractId.from_tx(mpn_tx)
    ziesha_tx = get_ziesha_token_creation_tx()
    ziesha_token_id = ContractId.from_tx(ziesha_tx)

    genesis = Block(header=_genesis_header(), body=[ziesha_tx, mpn_tx])
    if with_initials:
        staker_addr = Address.parse(FIRST_STAKER)
        genesis.body.append(
            Transaction(
                src=staker_addr, nonce=0,
                data=TransactionData(
                    "update_staker",
                    vrf_pub_key=FIRST_STAKER_VRF,
                    commission=Ratio(12),
                ),
                fee=Money.ziesha(0), memo="Very first staker created!",
            )
        )
        genesis.body.append(
            Transaction(
                src=None, nonce=0,
                data=TransactionData(
                    "delegate", to=staker_addr, amount=1_000_000_000_000,
                ),
                fee=Money.ziesha(0), memo="Very first delegation!",
            )
        )
        for addr, amount in load_initial_balances():
            genesis.body.append(
                Transaction(
                    src=None, nonce=0,
                    data=TransactionData(
                        "regular_send",
                        entries=[RegularSendEntry(addr, Money.ziesha(amount))],
                    ),
                    fee=Money.ziesha(0), memo="",
                )
            )
    return BlockchainConfig(
        genesis=genesis,
        ziesha_token_id=ziesha_token_id,
        mpn_config=MpnConfig(
            log4_tree_size=MPN_LOG4_TREE_SIZE,
            log4_token_tree_size=MPN_LOG4_TOKENS_TREE_SIZE,
            log4_deposit_batch_size=MPN_LOG4_DEPOSIT_BATCH_SIZE,
            log4_withdraw_batch_size=MPN_LOG4_WITHDRAW_BATCH_SIZE,
            log4_update_batch_size=MPN_LOG4_UPDATE_BATCH_SIZE,
            mpn_contract_id=mpn_contract_id,
            mpn_num_update_batches=1,
            mpn_num_deposit_batches=1,
            mpn_num_withdraw_batches=1,
            deposit_vk=dvk, withdraw_vk=wvk, update_vk=uvk,
        ),
        reward_ratio=10_000_000,
        max_block_size=MB,
        testnet_height_limit=TESTNET_HEIGHT_LIMIT,
        max_memo_length=64,
        slot_duration=90,
        slot_per_epoch=10,
        chain_start_timestamp=CHAIN_START_TIMESTAMP,
        check_validator=True,
        max_validator_commission=Ratio(26),
        teleport_log4_tree_size=10,
        teleport_contract_id=ContractId.NULL,
    )


def get_blockchain_config() -> BlockchainConfig:
    """Mainnet config: real ceremony VKs (hard failure if the VK data is
    missing — dummy proofs are rejected outside explicit test configs)
    and the full reference genesis (initial L1/L2 balances, first staker)."""
    return blockchain_config_template(with_initials=True)


def get_dev_blockchain_config(
    log4_tree: int = 3, log4_token_tree: int = 1, log4_batch: int = 1,
    seed: bytes = b"bazuka-tpu-dev", device: str = "cuda",
    keys: Optional[dict] = None,
) -> BlockchainConfig:
    """Dev-mode chain with REAL in-process Groth16 parameter generation
    for small MPN circuits (reference `--dev --small-mpn`:
    src/config/blockchain.rs:355-417).  Keygen runs on `device` (K1, K6
    and K7 on the card; without one it raises unless the caller asks for
    the CPU).  If `keys` is a dict, it receives under each circuit's name
    ("deposit", "withdraw", "update") a dict of the proving key
    ("params"), the circuit's "n_constraints", "synthesis_s", "keygen_s"
    and the key's stage seconds ("stage_s"): a prover needs the keys to
    prove the pool's works under these VKs."""
    import time

    from ..groth16.keygen import generate_parameters
    from ..mpn import circuits as circ_mod

    vks = {}
    for name, cls in (
        ("deposit", circ_mod.DepositCircuit),
        ("withdraw", circ_mod.WithdrawCircuit),
        ("update", circ_mod.UpdateCircuit),
    ):
        t0 = time.perf_counter()
        circuit = cls.empty(log4_tree, log4_token_tree, log4_batch)
        cs = circ_mod.synthesize_circuit(circuit)
        t1 = time.perf_counter()
        record = {}
        params = generate_parameters(cs, seed=seed + name.encode(),
                                     device=device, record=record)
        vks[name] = ZkVerifierKey.groth16(params.vk)
        if keys is not None:
            keys[name] = {"params": params, "n_constraints": cs.n_constraints,
                          "synthesis_s": t1 - t0,
                          "keygen_s": time.perf_counter() - t1,
                          "stage_s": record["seconds"]}
        del cs

    conf = blockchain_config_template(
        deposit_vk=vks["deposit"], withdraw_vk=vks["withdraw"],
        update_vk=vks["update"],
    )
    mpn_tx = get_mpn_contract_tx(
        log4_tree, log4_token_tree, log4_batch, log4_batch,
        vks["deposit"], vks["withdraw"], vks["update"],
    )
    conf.mpn_config = MpnConfig(
        log4_tree_size=log4_tree,
        log4_token_tree_size=log4_token_tree,
        log4_deposit_batch_size=log4_batch,
        log4_withdraw_batch_size=log4_batch,
        log4_update_batch_size=log4_batch,
        mpn_contract_id=ContractId.from_tx(mpn_tx),
        deposit_vk=vks["deposit"], withdraw_vk=vks["withdraw"],
        update_vk=vks["update"],
    )
    conf.genesis.body[1] = mpn_tx
    conf.check_validator = False
    conf.chain_start_timestamp = 0
    conf.genesis.header.proof_of_stake.timestamp = 0
    conf.testnet_height_limit = None
    return conf


def get_test_blockchain_config() -> BlockchainConfig:
    """Small-tree test chain: Dummy VKs, 0 required MPN batches,
    validator checks off, fast slots.  Flips the dummy-proof gate the way
    the reference's #[cfg(test)] does."""
    from ..zk.proof import allow_dummy_proofs

    allow_dummy_proofs(True)
    dummy = ZkVerifierKey.dummy()
    conf = blockchain_config_template(dummy, dummy, dummy)
    mpn_tx = get_mpn_contract_tx(
        3, 1, 1, 1,
        ZkVerifierKey.dummy(), ZkVerifierKey.dummy(), ZkVerifierKey.dummy(),
    )
    mpn_contract_id = ContractId.from_tx(mpn_tx)
    conf.mpn_config = MpnConfig(
        log4_tree_size=3,
        log4_token_tree_size=1,
        log4_deposit_batch_size=1,
        log4_withdraw_batch_size=1,
        log4_update_batch_size=1,
        mpn_contract_id=mpn_contract_id,
        mpn_num_update_batches=0,
        mpn_num_deposit_batches=0,
        mpn_num_withdraw_batches=0,
        deposit_vk=ZkVerifierKey.dummy(),
        withdraw_vk=ZkVerifierKey.dummy(),
        update_vk=ZkVerifierKey.dummy(),
    )
    conf.genesis.body[1] = mpn_tx
    conf.testnet_height_limit = None
    conf.chain_start_timestamp = 0
    conf.check_validator = False
    conf.slot_duration = 5
    conf.reward_ratio = 100_000
    conf.genesis.header.proof_of_stake.timestamp = 0

    abc = TxBuilder(b"ABC")
    delegator = TxBuilder(b"DELEGATOR")
    conf.genesis.body.append(
        Transaction(
            src=None, nonce=0,
            data=TransactionData(
                "regular_send",
                entries=[RegularSendEntry(abc.get_address(), Money.ziesha(10000))],
            ),
            fee=Money.ziesha(0), memo="Dummy tx",
        )
    )
    conf.genesis.body.append(
        Transaction(
            src=None, nonce=0,
            data=TransactionData(
                "regular_send",
                entries=[RegularSendEntry(delegator.get_address(), Money.ziesha(100))],
            ),
            fee=Money.ziesha(0), memo="",
        )
    )
    for seed in (b"VALIDATOR", b"VALIDATOR2", b"VALIDATOR3"):
        val = TxBuilder(seed)
        reg = val.register_validator("Test validator", Ratio(12), Money.ziesha(0), 0)
        # genesis txs are internal (treasury-mode): nonce 0, unsigned allowed
        conf.genesis.body.append(reg.tx)
        conf.genesis.body.append(
            delegator.delegate("", val.get_address(), 25, Money.ziesha(0), 0).tx
        )
    return conf
