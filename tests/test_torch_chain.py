"""The port's chain engine (`blockchain/chain.py`, `config/blockchain.py`)
against the JAX package's.

- The genesis pins of tests/test_genesis.py:44-126: the initial balances,
  the mainnet genesis header's hash and the MPN contract transaction's
  bytes; in the slow tier, the mainnet genesis state (about 150 s of the
  port's pure-Python Poseidon on one core) with the JAX chain's
  checksum.
- Each case of tests/test_blockchain.py (the mempool's among them) and
  the chain cases of tests/test_advice_fixes.py:73, 126, run in both
  packages on the test chain: the same observations, block hashes and
  `db_checksum`s.
- The mempool: one sequence of `add_tx` (local and remote, gaps, stale
  and replaced nonces, a bad signature, MPN deposits, transfers and
  withdrawals), `refresh` after blocks and the bans of inactive senders
  leaves the same queues, bans and median fees in both packages.
"""

import importlib
import types

import pytest
import torch

from bazuka_tpu.zk import proof as jzkproof
from bazuka_tpu_torch.zk import proof as zkproof

torch.set_num_threads(1)

# tests/test_genesis.py's pins
MPN_GENESIS_ROOT = (
    5598568384144783990585920207595467297849593467222007634357028426684414928491
)
MPN_GENESIS_SIZE = 844
GENESIS_HEADER_HASH = (
    "fd179ffe7d0927ba463239228b1b3135ff525baf429d6e0ea2dab4014a8ae154")
MPN_TX_BYTES_SHA3 = (
    "7a51c523e914c4c939cf45b0f2420e10b30d8dbb752ad0c8ba834834a977f9e6")
MPN_TX_BYTES_LEN = 43419
FIRST_STAKER = ("ed744735b5239d32a5b5b6441474bf65a6aaa6bfcf8905d4616f1acc14c"
                "f3847f0")


def lib(pkg: str):
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    tr, cfg, zk = mod("core.transaction"), mod("config.blockchain"), \
        mod("zk.proof")
    return types.SimpleNamespace(
        KvStoreChain=mod("blockchain").KvStoreChain,
        RamKvStore=mod("db").RamKvStore, E=mod("blockchain.error"),
        cfg=cfg, tr=tr, zk=zk, ser=mod("utils.ser"),
        TxBuilder=mod("wallet.tx_builder").TxBuilder,
        Mempool=mod("blockchain").Mempool,
        GeneralTransaction=mod("core").GeneralTransaction,
        mempool=mod("blockchain.mempool"))


PORT, JAX = lib("bazuka_tpu_torch"), lib("bazuka_tpu")


@pytest.fixture(autouse=True)
def dummy_proofs_restored():
    """`get_test_blockchain_config` switches each package's dummy-proof
    gate on; put both back as they were after the test."""
    saved = zkproof._ALLOW_DUMMY, jzkproof._ALLOW_DUMMY
    yield
    zkproof._ALLOW_DUMMY, jzkproof._ALLOW_DUMMY = saved


# ------------------------------------------------------------------ genesis


def test_initials_data():
    l1 = PORT.cfg.load_initial_balances()
    l2 = PORT.cfg.load_initial_mpn_balances()
    assert len(l1) == 3254 and len(l2) == 211
    assert sum(a for _, a in l1) == 19664470
    assert sum(a for _, a in l2) == 2484681
    assert str(l1[0][0]) == ("edf9f4952b0de27c3cd2202c31b7840a7081f6a3eafc898"
                             "c8632a6b0d29a6c3177")
    assert str(l2[0][0]) == ("jub220b276df9fcd7db35f292a3011e1ac423a5c5950eba"
                             "64242d0fb8e4f2a8351f2")
    j1, j2 = JAX.cfg.load_initial_balances(), JAX.cfg.load_initial_mpn_balances()
    assert [(str(a), v) for a, v in l1] == [(str(a), v) for a, v in j1]
    assert [(str(a), v) for a, v in l2] == [(str(a), v) for a, v in j2]


def test_genesis_block_pins():
    import hashlib

    conf = PORT.cfg.get_blockchain_config()
    assert conf.genesis.header.hash().hex() == GENESIS_HEADER_HASH
    raw = PORT.ser.dumps(conf.genesis.body[1])
    assert len(raw) == MPN_TX_BYTES_LEN
    assert hashlib.sha3_256(raw).hexdigest() == MPN_TX_BYTES_SHA3
    state = conf.genesis.body[1].data.contract.initial_state
    assert (state.state_hash, state.state_size) == (MPN_GENESIS_ROOT,
                                                    MPN_GENESIS_SIZE)
    assert len(conf.genesis.body) == 2 + 2 + 3254


@pytest.mark.slow
def test_mainnet_genesis_state():
    conf = PORT.cfg.get_blockchain_config()
    chain = PORT.KvStoreChain(PORT.RamKvStore(), conf)
    cid = conf.mpn_config.mpn_contract_id
    acc = chain.get_contract_account(cid)
    assert acc.compressed_state.state_hash == MPN_GENESIS_ROOT
    assert chain.get_contract_balance(
        cid, PORT.tr.ContractId.ZIESHA) == 2484681
    staker = PORT.cfg.Address.parse(FIRST_STAKER)
    assert chain.get_stake(staker) == 1_000_000_000_000
    l2 = PORT.cfg.load_initial_mpn_balances()
    mpn_acc = chain.get_mpn_account(l2[0][0])
    assert mpn_acc.tokens[0].amount == l2[0][1]
    jchain = JAX.KvStoreChain(JAX.RamKvStore(), JAX.cfg.get_blockchain_config())
    assert chain.db_checksum() == jchain.db_checksum()


# -------------------------------------------------------------- chain cases


def users(m):
    return types.SimpleNamespace(**{
        k.lower(): m.TxBuilder(k.encode())
        for k in ("ABC", "DELEGATOR", "VALIDATOR", "BOB")})


def case_genesis(m, chain):
    u = users(m)
    zsh = m.tr.ContractId.ZIESHA
    assert chain.get_height() == 1
    assert chain.get_balance(u.abc.get_address(), zsh) == 10000
    assert chain.get_balance(u.delegator.get_address(), zsh) == 100 - 75
    t = chain.get_balance(m.cfg.TREASURY, zsh)
    assert 0 < t < 2_000_000_000 * 10**9
    assert chain.get_stake(u.validator.get_address()) == 25
    assert len(chain.get_stakers()) == 3
    return [t, chain.get_stakers(), chain.get_tip().hash()]


def case_regular_send_and_nonce(m, chain):
    u, z = users(m), m.tr.Money.ziesha
    td = u.abc.create_transaction("", u.bob.get_address(), z(500), z(1), 1)
    chain.apply_tx(td.tx)
    assert chain.get_balance(u.bob.get_address(), m.tr.ContractId.ZIESHA) == 500
    assert chain.get_nonce(u.abc.get_address()) == 1
    with pytest.raises(m.E.InvalidTransactionNonce):
        chain.apply_tx(td.tx)
    td2 = u.abc.create_transaction("", u.bob.get_address(), z(10**9), z(1), 2)
    with pytest.raises(m.E.BalanceInsufficient):
        chain.apply_tx(td2.tx)
    td3 = u.abc.create_transaction("", u.bob.get_address(), z(1), z(1), 2)
    td3.tx.nonce = 3
    assert not td3.tx.verify_signature()
    return [td.tx.hash()]


def case_treasury_access_denied(m, chain):
    u = users(m)
    tx = m.tr.Transaction(
        src=None, nonce=0, data=m.tr.TransactionData("regular_send", entries=[
            m.tr.RegularSendEntry(u.abc.get_address(), m.tr.Money.ziesha(1))]),
        fee=m.tr.Money.ziesha(0), memo="")
    with pytest.raises(m.E.IllegalTreasuryAccess):
        chain.apply_tx(tx, internal=False)
    return []


def _send_block(m, chain, amount, fee, ts=10):
    u = users(m)
    td = u.abc.create_transaction("", u.bob.get_address(),
                                  m.tr.Money.ziesha(amount),
                                  m.tr.Money.ziesha(fee), 1)
    return chain.draft_block(ts, [td], u.validator, check=True)


def case_draft_and_apply_block(m, chain):
    blk = _send_block(m, chain, 100, 5)
    assert blk is not None and len(blk.body) == 1
    chain.apply_block(blk)
    u, zsh = users(m), m.tr.ContractId.ZIESHA
    assert chain.get_height() == 2
    assert chain.get_balance(u.bob.get_address(), zsh) == 100
    assert chain.get_balance(u.validator.get_address(), zsh) > 0
    return [blk.header.hash(), chain.get_balance(u.validator.get_address(),
                                                 zsh)]


def case_rollback(m, chain):
    before = chain.db_checksum()
    blk = _send_block(m, chain, 100, 5)
    chain.apply_block(blk)
    after = chain.db_checksum()
    assert after != before
    chain.rollback()
    assert chain.get_height() == 1
    assert chain.db_checksum() == before
    return [blk.header.hash(), after]


def case_merkle_root_rejection(m, chain):
    blk = _send_block(m, chain, 10, 1)
    assert blk.body
    blk.header.block_root = bytes([9] * 32)
    with pytest.raises(m.E.InvalidMerkleRoot):
        chain.apply_block(blk)
    return [blk.header.hash()]


def case_parent_hash_rejection(m, chain):
    blk = chain.draft_block(10, [], users(m).validator, check=True)
    blk.header.parent_hash = bytes([1] * 32)
    blk.header.block_root = blk.merkle_tree().root()
    with pytest.raises(m.E.InvalidParentHash):
        chain.apply_block(blk)
    return [blk.header.hash()]


def case_extend_and_power(m, chain):
    v = users(m).validator
    blk1 = chain.draft_block(10, [], v, check=True)
    chain.apply_block(blk1)
    p1 = chain.get_power()
    blk2 = chain.draft_block(20, [], v, check=True)
    chain.apply_block(blk2)
    assert chain.get_power() > p1 and chain.get_height() == 3
    assert [h.number for h in chain.get_headers(0, 10)] == [0, 1, 2]
    assert not chain.will_extend(2, [])
    return [blk1.header.hash(), blk2.header.hash(), chain.get_power()]


def case_delegate_undelegate_flow(m, chain):
    u = users(m)
    va, de = u.validator.get_address(), u.delegator.get_address()
    chain.apply_tx(u.delegator.delegate("", va, 10, m.tr.Money.ziesha(0), 1).tx)
    assert chain.get_stake(va) == 35
    assert chain.get_delegate(de, va).amount == 35
    assert (str(de), 35) in chain.get_delegators(va)
    chain.apply_tx(u.delegator.undelegate("", va, 5, m.tr.Money.ziesha(0),
                                          2).tx)
    assert chain.get_stake(va) == 30
    undels = chain.get_undelegations(de)
    assert len(undels) == 1 and undels[0][1].amount == 5
    return [undels[0][0], undels[0][1].unlocks_on, chain.get_delegatees(de)]


def case_currency_in_circulation(m, chain):
    total = chain.currency_in_circulation()
    assert total == 2_000_000_000 * 10**9
    return [total]


def case_withdraw_fee_credits_executor(m, chain):
    # tests/test_advice_fixes.py:73
    cid = chain.config.mpn_config.mpn_contract_id
    user, z = users(m).abc, m.tr.Money.ziesha
    dep = user.deposit_mpn("", cid, user.get_mpn_address(), 1, z(1000), z(0))
    chain.apply_deposit(dep.payment)
    wd = m.tr.ContractWithdraw(
        memo="", contract_id=cid, withdraw_circuit_id=0, calldata=777,
        dst=user.get_address(), amount=z(200), fee=z(50))
    fees = []
    chain._cu_withdraw(cid, chain.get_contract(cid), 0, [wd], fees)
    assert [(f.token_id.scalar, f.amount) for f in fees] == [(1, 50)]
    zsh = m.tr.ContractId.ZIESHA
    assert chain.get_contract_balance(cid, zsh) == 750
    assert chain.get_balance(user.get_address(), zsh) == 9200
    return [wd.fingerprint()]


def case_mint_semantics(m, chain):
    # tests/test_advice_fixes.py:126
    zsh = m.tr.ContractId.ZIESHA
    contract = chain.get_contract(zsh)
    contract.token.mint_functions.append(
        m.zk.ZkSingleInputVerifierKey(m.zk.ZkVerifierKey.dummy()))
    fees = []
    _, aux = chain._cu_mint(zsh, contract, 0, 123456, fees)
    assert (aux.state_hash, aux.state_size) == (123456, 1)
    assert [(f.token_id.scalar, f.amount) for f in fees] == [(1, 123456)]
    assert chain.get_contract_balance(zsh, zsh) == 123456
    assert chain.get_token(zsh).supply == 2_000_000_000 * 10**9 + 123456
    _, aux0 = chain._cu_mint(zsh, contract, 0, 0, [])
    assert (aux0.state_hash, aux0.state_size) == (0, 0)
    with pytest.raises(m.E.TokenSupplyOverflow):
        chain._cu_mint(zsh, contract, 0, 2**64 - 1, [])
    return [chain.get_token(zsh).supply]


def case_mempool_nonce_chaining(m, chain):
    # tests/test_blockchain.py:153
    pool = m.Mempool(min_balance_per_tx=1)
    u, z = users(m), m.tr.Money.ziesha
    tds = [u.abc.create_transaction("", u.bob.get_address(), z(10), z(1), n)
           for n in (1, 2, 4)]  # a gap at 3
    for td in tds:
        pool.add_tx(chain, m.GeneralTransaction(td), False, now=0)
    accepted = [tx.inner.tx.nonce for tx, _ in pool.all()]
    assert accepted == [1, 2]
    td_old = u.abc.create_transaction("", u.bob.get_address(), z(10), z(1), 1)
    before = len(pool)
    pool.add_tx(chain, m.GeneralTransaction(td_old), False, now=0)
    assert len(pool) == before
    return [accepted, [tx.inner.tx.hash() for tx, _ in pool.all()]]


CASES = [name for name in globals() if name.startswith("case_")]


@pytest.mark.parametrize("case", CASES)
def test_chain_case_equals_jax(case):
    out = []
    for m in (PORT, JAX):
        chain = m.KvStoreChain(m.RamKvStore(), m.cfg.get_test_blockchain_config())
        obs = globals()[case](m, chain)
        out.append((obs, chain.get_height(), chain.get_tip().hash(),
                    chain.db_checksum()))
    assert out[0] == out[1]


def mempool_queues(m):
    """One sequence of `add_tx`, `refresh` and bans on package `m`'s
    mempool over its test chain; what the queues, bans and fees show after
    each step."""
    chain = m.KvStoreChain(m.RamKvStore(), m.cfg.get_test_blockchain_config())
    u, z, gt = users(m), m.tr.Money.ziesha, m.GeneralTransaction
    cid = chain.config.mpn_config.mpn_contract_id
    carol, dave = m.TxBuilder(b"CAROL"), m.TxBuilder(b"DAVE")
    zsh = m.tr.ContractId.ZIESHA
    for who, amount in ((carol, 5_000), (dave, 3 * 10**9)):
        chain._set_balance(who.get_address(), zsh, amount)
    pool = m.Mempool()

    def send(b, n, fee=1, dst=None):
        return gt(b.create_transaction(
            "", (dst or u.bob).get_address(), z(10), z(fee), n))

    def view():
        return ([(g.kind, g.address, q.nonce, q.last_exec,
                  [(m.ser.dumps(tx),
                    s.first_seen, s.is_local, s.claimed_timestamp)
                   for tx, s in q.txs])
                 for g, q in pool.txs.items()],
                sorted(pool.banned.items()), sorted(pool.local_addrs),
                sorted(pool.median_fees().items()), len(pool))

    out = []
    # remote senders: one tx per Ziesha of balance, so CAROL (5,000
    # units) gets one, DAVE (3 Ziesha) three; a gap and a stale nonce
    for n in (1, 2):
        pool.add_tx(chain, send(carol, n), False, now=10)
    for n in (1, 2, 3, 4, 6):
        pool.add_tx(chain, send(dave, n, fee=n), False, now=11)
    out.append(view())
    # local: no limit, and a local tx out of order resets its queue
    for n in (1, 2, 3):
        pool.add_tx(chain, send(u.abc, n), True, now=12)
    pool.add_tx(chain, send(u.abc, 2, fee=9), True, now=13)
    bad = send(u.abc, 3)
    bad.inner.tx.nonce = 4
    pool.add_tx(chain, bad, True, now=13)
    # a newer claimed timestamp replaces the head of DAVE's queue
    pool.add_tx(chain, send(dave, 1, fee=5, dst=carol), False, now=14,
                claimed_timestamp=7)
    out.append(view())
    # MPN kinds: a deposit, then an MPN transfer and a withdrawal of it
    pool.add_tx(chain, gt(u.abc.deposit_mpn(
        "", cid, u.abc.get_mpn_address(), 1, z(1_000), z(0))), True, now=15)
    pool.add_tx(chain, gt(u.abc.deposit_mpn(
        "", m.tr.ContractId(7), u.abc.get_mpn_address(), 1, z(1), z(0))),
        False, now=15)
    pool.add_tx(chain, gt(u.abc.create_mpn_transaction(
        u.bob.get_mpn_address(), z(5), z(1), 1)), True, now=15)
    pool.add_tx(chain, gt(u.abc.withdraw_mpn(
        "", cid, 1, z(5), z(1), u.abc.get_address())), True, now=15)
    out.append(view())
    # a block executes ABC's first two sends; refresh evicts them
    for n in (1, 2):
        chain.apply_tx(u.abc.create_transaction(
            "", u.bob.get_address(), z(10), z(1), n).tx)
    pool.refresh(chain, now=20)
    out.append(view())
    # ten minutes on, the remote senders are banned and their queues go;
    # a banned sender's tx is refused until the ban ends
    pool.refresh(chain, now=20 + m.mempool.BAN_THRESHOLD + 20)
    out.append(view())
    pool.add_tx(chain, send(carol, 1), False, now=700)
    late = 700 + m.mempool.BAN_TIME
    pool.add_tx(chain, send(carol, 1), False, now=late)
    out.append(view())
    return out


def test_mempool_queues_equal_jax():
    port, jax = mempool_queues(PORT), mempool_queues(JAX)
    assert port == jax
    # CAROL 1 (her balance's limit), DAVE 3 (nonce 4 past his limit, 6
    # after a gap); ABC's local 1, 2 and the replacing 2; the three MPN
    # kinds (the other contract's deposit refused); ABC's two sends gone
    # after the block; both remote senders banned, CAROL again after
    # her ban
    assert [step[-1] for step in port] == [4, 4, 7, 5, 3, 4]
    assert [len(step[1]) for step in port] == [0, 0, 0, 0, 2, 1]
