"""The port's L1 types against the JAX package's: the same construction in
both packages gives the same bytes, hashes and signatures.

- Merkle trees: the reference's golden roots (tests/test_core.py:34) and
  equal roots and proofs for 0-17 leaves;
- VRF: equal keys, outputs and proofs, each verifying in the other
  package, and a torsion-shifted output refused
  (tests/test_core.py:80, tests/test_advice_fixes.py:98);
- money, ratios and contract ids (tests/test_core.py:93-103);
- every L1 transaction the port's `TxBuilder` builds, the MPN transfer and
  its nonce group (tests/test_core.py:110-151);
- headers (with and without a VRF proof) and blocks: equal bytes and
  hashes, each read back by the other package (tests/test_wire.py:80-123);
- a dummy proof is refused unless `allow_dummy_proofs` is on, in each
  package.
"""

import hashlib
import importlib
import types

import pytest
import torch

from bazuka_tpu.zk import proof as jzkproof
from bazuka_tpu_torch.core.hash import Sha3Hasher
from bazuka_tpu_torch.crypto import jubjub as jj
from bazuka_tpu_torch.crypto.merkle import MerkleTree, merge_hash
from bazuka_tpu_torch.crypto.vrf import VRF, Output
from bazuka_tpu_torch.zk import proof as zkproof

torch.set_num_threads(1)

MODULES = ("core", "core.money", "core.transaction", "core.header",
           "core.blocks", "crypto.merkle", "crypto.vrf", "crypto.ed25519",
           "utils.ser", "wallet.tx_builder", "zk.proof", "zk.state")


def lib(pkg: str):
    """The modules of `pkg` under their dotted names with `_` for `.`."""
    return types.SimpleNamespace(**{
        m.replace(".", "_"): importlib.import_module(f"{pkg}.{m}")
        for m in MODULES})


PORT, JAX = lib("bazuka_tpu_torch"), lib("bazuka_tpu")


@pytest.fixture(autouse=True)
def dummy_proofs_restored():
    """Each package's dummy-proof switch as it was before the test."""
    saved = zkproof._ALLOW_DUMMY, jzkproof._ALLOW_DUMMY
    yield
    zkproof._ALLOW_DUMMY, jzkproof._ALLOW_DUMMY = saved


def H(i):
    return Sha3Hasher.hash(bytes([i]))


def test_merkle_golden_vectors():
    # reference: src/crypto/merkle.rs:130-161, as tests/test_core.py pins them
    assert MerkleTree([]).root() == bytes(32)
    assert MerkleTree([H(1)]).root().hex() == (
        "2767f15c8af2f2c7225d5273fdd683edc714110a987d1054697c348aed4e6cc7")
    assert MerkleTree([H(2), H(3)]).root().hex() == (
        "93943eec0caa399daef37cdc514abb63fcf34d55035ddfa6b85dbe95d9496b07")
    assert MerkleTree([H(i) for i in range(10)]).root().hex() == (
        "aa98f7f2084c8b4684a813741d08092a0055a4edc06a7baeb4d9207e1226d24f")
    assert MerkleTree([H(i) for i in range(16)]).root().hex() == (
        "cd7f778265f4bf51efaf59005bb7413daa06fd9bf95aba144769531876444677")


@pytest.mark.parametrize("n", range(18))
def test_merkle_roots_and_proofs_equal_jax(n):
    leaves = [H(i) for i in range(n)]
    tree, jtree = MerkleTree(leaves), JAX.crypto_merkle.MerkleTree(leaves)
    assert tree.root() == jtree.root()
    for i in range(n):
        proof = tree.prove(i)
        assert proof == jtree.prove(i)
        curr = leaves[i]
        for entry in proof:
            curr = merge_hash(curr, entry)
        assert curr == tree.root()


def test_vrf_equals_jax():
    for seed in (b"validator", b"other"):
        pk, sk = VRF.generate_keys(seed)
        jpk, jsk = JAX.crypto_vrf.VRF.generate_keys(seed)
        assert str(pk) == str(jpk)
        for msg in (b"epoch-1-slot-3", b"", b"x" * 100):
            out, proof = VRF.sign(sk, msg)
            jout, jproof = JAX.crypto_vrf.VRF.sign(jsk, msg)
            assert out.to_bytes() == jout.to_bytes()
            assert proof.to_bytes() == jproof.to_bytes()
            assert out.as_float() == jout.as_float()
            assert VRF.verify(pk, msg, out, proof)
            assert not VRF.verify(pk, msg + b"!", out, proof)
            assert JAX.crypto_vrf.VRF.verify(
                jpk, msg, JAX.crypto_vrf.Output(out.point),
                JAX.crypto_vrf.Proof.from_bytes(proof.to_bytes()))


def test_vrf_refuses_torsion_shifted_output():
    torsion = (0, jj.P - 1)
    pk, sk = VRF.generate_keys(b"staker")
    for i in range(64):
        msg = b"slot-%d" % i
        out, proof = VRF.sign(sk, msg)
        if proof.c % 2 == 0:
            break
    assert VRF.verify(pk, msg, out, proof)
    assert not VRF.verify(pk, msg, Output(jj.point_add(out.point, torsion)),
                          proof)


def test_money_ratio_and_contract_ids_equal_jax():
    for m in (PORT, JAX):
        money = m.core_money
        assert money.display_amount(123450000, 9) == "0.12345"
        assert money.display_amount(0, 9) == "0.0"
        assert money.Decimal.parse("1.5").to_amount(9) == 1_500_000_000
        with pytest.raises(ValueError):
            money.Decimal.parse(".")
    for v in (0, 1, 123456789, 2**64 - 1):
        for d in (0, 3, 9, 19):
            assert (PORT.core_money.display_amount(v, d)
                    == JAX.core_money.display_amount(v, d))
    for s in ("1", "0.000000001", "18446744073.709551615", "7.25"):
        assert (PORT.core_money.Decimal.parse(s).to_amount(9)
                == JAX.core_money.Decimal.parse(s).to_amount(9))
    for f in (0.0, 0.12, 0.5, 1.0):
        assert (PORT.core_money.Ratio.from_float(f).value
                == JAX.core_money.Ratio.from_float(f).value)
    for cid in (0, 1, 0x1234, 2**250 + 7):
        c, jc = (m.core_transaction.ContractId(cid) for m in (PORT, JAX))
        assert str(c) == str(jc)
        assert PORT.core_transaction.ContractId.parse(str(jc)) == c
        assert PORT.utils_ser.dumps(c) == JAX.utils_ser.dumps(jc)


def l1_transactions(m) -> dict:
    """Every L1 transaction kind the package's TxBuilder builds, signed."""
    tr, money = m.core_transaction, m.core_money
    alice = m.wallet_tx_builder.TxBuilder(b"alice")
    bob = m.wallet_tx_builder.TxBuilder(b"bob")
    z = tr.Money.ziesha
    token = tr.ContractId(77)
    state = m.zk_state
    contract = state.ZkContract(
        initial_state=state.ZkCompressedState.empty(state.SCALAR),
        state_model=state.SCALAR)
    tds = {
        "send": alice.create_transaction("hi", bob.get_address(), z(100),
                                         z(1), 1),
        "multi_send": alice.create_multi_transaction(
            "", [tr.RegularSendEntry(bob.get_address(), z(5)),
                 tr.RegularSendEntry(bob.get_address(), tr.Money(token, 9))],
            z(2), 2),
        "delegate": alice.delegate("", bob.get_address(), 25, z(0), 3),
        "undelegate": alice.undelegate("", bob.get_address(), 5, z(0), 4),
        "auto_delegate": alice.auto_delegate(
            "", bob.get_address(), money.Ratio(40), z(0), 5),
        "register_validator": alice.register_validator(
            "v", money.Ratio(12), z(0), 6),
        "create_token": alice.create_token(
            "", "Token", "TKN", 10**12, 6, bob.get_address(), z(3), 7)[0],
        "create_contract": alice.create_contract(
            "", contract, {}, z(0), z(0), 8),
    }
    return {k: td.tx for k, td in tds.items()}


def test_l1_transactions_equal_jax():
    port, jax = l1_transactions(PORT), l1_transactions(JAX)
    for kind, tx in port.items():
        raw = PORT.utils_ser.dumps(tx)
        assert raw == JAX.utils_ser.dumps(jax[kind]), kind
        assert tx.hash() == jax[kind].hash(), kind
        assert tx.verify_signature(), kind
        back = PORT.utils_ser.loads(PORT.core_transaction.Transaction, raw)
        assert back.hash() == tx.hash() and back.verify_signature()
        back.nonce += 1
        assert not back.verify_signature()
        g = PORT.core.GeneralTransaction(
            PORT.core_transaction.TransactionAndDelta(tx))
        assert g.nonce_group() == PORT.core.NonceGroup(
            "tx_delta", str(tx.src))
    cid = PORT.core_transaction.ContractId.from_tx(port["create_token"])
    assert cid.scalar == JAX.core_transaction.ContractId.from_tx(
        jax["create_token"]).scalar


def test_mpn_transaction_and_nonce_group_equal_jax():
    out = []
    for m in (PORT, JAX):
        src = m.wallet_tx_builder.TxBuilder(b"l2src")
        dst = m.wallet_tx_builder.TxBuilder(b"l2dst")
        tx = src.create_mpn_transaction(
            dst.get_mpn_address(), m.core_transaction.Money.ziesha(10),
            m.core_transaction.Money.ziesha(1), 0)
        g = m.core.GeneralTransaction(tx)
        out.append((m.utils_ser.dumps(tx), m.utils_ser.dumps(g), g.nonce(),
                    g.nonce_group().kind, g.nonce_group().address,
                    g.verify_signature()))
    assert out[0] == out[1]
    assert out[0][-1]


def chain_objects(m):
    """A header with a VRF proof and a block of three transactions."""
    v = m.wallet_tx_builder.TxBuilder(b"v")
    out, proof = v.generate_random(bytes(range(32)), 3, 7, 1)
    vp = m.core_header.ValidatorProof(1, out, proof)
    txs = list(l1_transactions(m).values())[:3]
    header = m.core_header.Header(
        parent_hash=bytes([1]) * 32, number=9, block_root=bytes(32),
        proof_of_stake=m.core_header.ProofOfStake(
            validator=v.get_address(), timestamp=4321, proof=vp))
    block = m.core_blocks.Block(header=header, body=txs)
    block.header.block_root = block.merkle_tree().root()
    return header, block


def test_header_and_block_equal_jax():
    (h, blk), (jh, jblk) = chain_objects(PORT), chain_objects(JAX)
    ser, jser = PORT.utils_ser, JAX.utils_ser
    assert ser.dumps(h) == jser.dumps(jh)
    assert h.hash() == jh.hash()
    assert ser.dumps(blk) == jser.dumps(jblk)
    assert blk.merkle_tree().root() == jblk.merkle_tree().root()
    back = ser.loads(PORT.core_blocks.Block, jser.dumps(jblk))
    assert back.header.hash() == jh.hash()
    assert [t.hash() for t in back.body] == [t.hash() for t in jblk.body]
    assert back.header.proof_of_stake.proof.power() == 0.5
    plain_h = PORT.core_header.Header(
        parent_hash=b"\x01" * 32, number=7, block_root=b"\x02" * 32,
        proof_of_stake=PORT.core_header.ProofOfStake(
            PORT.crypto_ed25519.PublicKey(b"\x03" * 32), 99))
    assert PORT.core_header.Header.read_from(
        ser.Reader(ser.dumps(plain_h))) == plain_h


def test_header_layout_matches_reference_field_order():
    # tests/test_wire.py:80: the bytes assembled by hand from the field order
    parent, root = bytes(range(32)), bytes(range(32, 64))
    validator = PORT.crypto_ed25519.PublicKey(bytes([0xEE]) * 32)
    h = PORT.core_header.Header(
        parent_hash=parent, number=513, block_root=root,
        proof_of_stake=PORT.core_header.ProofOfStake(validator, 0x01020304))
    assert PORT.utils_ser.dumps(h) == (
        parent + bytes.fromhex("0102000000000000") + root + validator.raw
        + bytes.fromhex("04030201") + b"\x00")
    assert hashlib.sha3_256(PORT.utils_ser.dumps(h)).digest() == h.hash()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_dummy_proof_refused_unless_allowed(pkg):
    zk = PORT.zk_proof if pkg == "port" else JAX.zk_proof
    vk, ok, bad = zk.ZkVerifierKey.dummy(), zk.ZkProof.dummy(True), \
        zk.ZkProof.dummy(False)
    zk.allow_dummy_proofs(False)
    assert not zk.check_proof(vk, 0, 0, 0, 0, 0, ok)
    zk.allow_dummy_proofs(True)
    assert zk.check_proof(vk, 0, 0, 0, 0, 0, ok)
    assert not zk.check_proof(vk, 0, 0, 0, 0, 0, bad)
