"""The port's host copies on the MPN path against the JAX package: Poseidon,
JubJub keys and EdDSA, the pure-Python Ed25519, the state tree and the
bytes of the MPN transactions.

- Poseidon gives the reference's 16 golden vectors and equals
  `bazuka_tpu.zk.poseidon_host.poseidon_python` at every arity 1-16.
- JubJub keys, compression and signatures from the same seeds are equal.
- The port's Ed25519 (RFC 8032 on `hashlib` alone) gives the public keys
  and signature bytes of the JAX package's `cryptography`-backed module,
  for several seeds and messages, the empty one included; `verify`
  rejects a flipped bit of the signature, the message or the key.
- The sparse state tree gives equal roots, leaves and Merkle proofs.
- `MpnTransaction`, `MpnDeposit` and `MpnWithdraw` built by both
  packages' `TxBuilder`s from the same seeds serialise to equal bytes.
"""

import dataclasses
import random

import pytest
import torch

from test_poseidon import GOLDEN

from bazuka_tpu.blockchain.chain import prover_commitment as jax_commitment
from bazuka_tpu.core.transaction import ContractId as JContractId
from bazuka_tpu.core.transaction import Money as JMoney
from bazuka_tpu.crypto import ed25519 as jed
from bazuka_tpu.crypto import jubjub as jjj
from bazuka_tpu.db import Put as JPut, RamKvStore as JRamKvStore
from bazuka_tpu.db import keys as jkeys
from bazuka_tpu.utils import ser as jser
from bazuka_tpu.wallet.tx_builder import TxBuilder as JTxBuilder
from bazuka_tpu.zk import state as jstate
from bazuka_tpu.zk.poseidon_host import poseidon_python as jax_poseidon
from bazuka_tpu_torch.blockchain.chain import prover_commitment
from bazuka_tpu_torch.core.transaction import ContractId, Money
from bazuka_tpu_torch.crypto import ed25519 as ted
from bazuka_tpu_torch.crypto import jubjub as tjj
from bazuka_tpu_torch.db import Put, RamKvStore
from bazuka_tpu_torch.db import keys as tkeys
from bazuka_tpu_torch.fields.host import FR_MODULUS
from bazuka_tpu_torch.utils import ser
from bazuka_tpu_torch.wallet.tx_builder import TxBuilder
from bazuka_tpu_torch.zk import state as tstate
from bazuka_tpu_torch.zk.poseidon_host import MAX_ARITY, poseidon

# The tests are host Python; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

SEEDS = (b"", b"ABC", b"XYZ", b"U17", bytes(range(40)))
SEED_IDS = ("empty", "ABC", "XYZ", "U17", "bytes40")


def test_poseidon_golden_vectors():
    for arity in range(1, MAX_ARITY + 1):
        assert poseidon(list(range(arity))) == int(GOLDEN[arity - 1]), arity


@pytest.mark.parametrize("arity", range(1, MAX_ARITY + 1))
def test_poseidon_matches_jax(arity):
    rng = random.Random(arity)
    for _ in range(3):
        vals = [rng.randrange(FR_MODULUS) for _ in range(arity)]
        assert poseidon(vals) == jax_poseidon(vals)


@pytest.mark.parametrize("seed", SEEDS, ids=SEED_IDS)
def test_jubjub_keys_and_signatures_match_jax(seed):
    pk, sk = tjj.JubJub.generate_keys(seed)
    jpk, jsk = jjj.JubJub.generate_keys(seed)
    assert (pk.x, pk.sign) == (jpk.x, jpk.sign) and str(pk) == str(jpk)
    assert dataclasses.astuple(sk) == dataclasses.astuple(jsk)
    point = pk.decompress()
    assert point == jpk.decompress() == sk.public_point
    assert tjj.compress(point) == jjj.compress(point)
    assert tjj.PublicKey.parse(str(pk)) == pk
    msg = int.from_bytes(seed.ljust(8, b"m"), "little") % FR_MODULUS
    sig = tjj.JubJub.sign(sk, msg)
    jsig = jjj.JubJub.sign(jsk, msg)
    assert (sig.r, sig.s) == (jsig.r, jsig.s)
    assert tjj.JubJub.verify(pk, msg, sig)
    assert not tjj.JubJub.verify(pk, msg + 1, sig)
    assert not tjj.JubJub.verify(pk, msg, tjj.Signature(sig.r, sig.s + 1))


MESSAGES = (b"", b"\x00", b"abc", bytes(range(256)) * 3)


def _flip(data: bytes, bit: int) -> bytes:
    out = bytearray(data)
    out[bit // 8] ^= 1 << (bit % 8)
    return bytes(out)


@pytest.mark.parametrize("seed", SEEDS, ids=SEED_IDS)
def test_ed25519_matches_jax(seed):
    pk, sk = ted.Ed25519.generate_keys(seed)
    jpk, jsk = jed.Ed25519.generate_keys(seed)
    assert sk.raw == jsk.raw and pk.raw == jpk.raw and str(pk) == str(jpk)
    assert ted.PublicKey.parse(str(pk)) == pk
    for msg in MESSAGES:
        sig = ted.Ed25519.sign(sk, msg)
        assert sig == jed.Ed25519.sign(jsk, msg)
        assert ted.Ed25519.verify(pk, msg, sig)
        assert jed.Ed25519.verify(jpk, msg, sig)
        for bit in (0, 77, 255, 300, 511):  # R's bytes and S's
            assert not ted.Ed25519.verify(pk, msg, _flip(sig, bit))
        assert not ted.Ed25519.verify(pk, msg + b"!", sig)
        other, _ = ted.Ed25519.generate_keys(seed + b"other")
        assert not ted.Ed25519.verify(other, msg, sig)
        assert not ted.Ed25519.verify(pk, msg, sig[:63])


def test_ed25519_rejects_invalid_points():
    # y = 2 is not the y of any point of edwards25519
    bad = ted.PublicKey((2).to_bytes(32, "little"))
    with pytest.raises(ValueError):
        ted.PublicKey.parse(str(bad))
    pk, sk = ted.Ed25519.generate_keys(b"ABC")
    assert not ted.Ed25519.verify(bad, b"m", ted.Ed25519.sign(sk, b"m"))
    # S at or above the group order is refused
    sig = ted.Ed25519.sign(sk, b"m")
    s = int.from_bytes(sig[32:], "little") + ted._L
    assert not ted.Ed25519.verify(pk, b"m", sig[:32] + s.to_bytes(32, "little"))


def test_prover_commitment_matches_jax():
    for seed in SEEDS:
        for reward in (0, 10, 2**63):
            assert (prover_commitment(TxBuilder(seed).get_address(), reward)
                    == jax_commitment(JTxBuilder(seed).get_address(), reward))


def _tree(pkg_state, put, ram, keys, ser_mod):
    from_model = pkg_state.ListModel(2, pkg_state.Struct(
        [pkg_state.SCALAR, pkg_state.ListModel(1, pkg_state.SCALAR)]))
    db = ram()
    cid = "0x" + "ab" * 32
    contract = pkg_state.ZkContract(
        pkg_state.ZkCompressedState.empty(from_model), from_model)
    db.update([put(keys.contract(cid), ser_mod.dumps(contract))])
    mgr = pkg_state.StateManager()
    rng = random.Random(4)
    out = []
    for _ in range(12):
        loc = (rng.randrange(16), 1, rng.randrange(4)) if rng.random() < 0.5 \
            else (rng.randrange(16), 0)
        val = rng.choice([0, 1, rng.randrange(FR_MODULUS)])
        root, size_diff = mgr.set_data(db, cid, loc, val)
        out.append((root, size_diff, mgr.get_data(db, cid, loc),
                    mgr.prove(db, cid, (), loc[0]),
                    mgr.prove(db, cid, (loc[0], 1), 2)))
    mgr.update_contract(db, cid, {(3, 0): 5, (3, 1, 1): None}, 7)
    out.append((mgr.root(db, cid), mgr.height_of(db, cid)))
    return out, db.pairs()


def test_state_tree_matches_jax():
    ours, pairs = _tree(tstate, Put, RamKvStore, tkeys, ser)
    theirs, jpairs = _tree(jstate, JPut, JRamKvStore, jkeys, jser)
    assert ours[:-1] == theirs[:-1]
    (root, height), (jroot, jheight) = ours[-1], theirs[-1]
    assert (root.state_hash, root.state_size, height) == (
        jroot.state_hash, jroot.state_size, jheight)
    assert pairs == jpairs


@pytest.mark.parametrize("seed", SEEDS[1:4], ids=SEED_IDS[1:4])
def test_mpn_tx_bytes_match_jax(seed):
    cid, token = ContractId(0xBEEF), ContractId(123)
    jcid, jtoken = JContractId(0xBEEF), JContractId(123)
    me, you = TxBuilder(seed), TxBuilder(seed + b"-dst")
    jme, jyou = JTxBuilder(seed), JTxBuilder(seed + b"-dst")
    assert str(me.get_mpn_address()) == str(jme.get_mpn_address())
    pairs = [
        (me.create_mpn_transaction(you.get_mpn_address(), Money(token, 100),
                                   Money(token, 7), 3),
         jme.create_mpn_transaction(jyou.get_mpn_address(),
                                    JMoney(jtoken, 100), JMoney(jtoken, 7), 3)),
        (me.deposit_mpn("memo", cid, you.get_mpn_address(), 2,
                        Money(token, 1000), Money.ziesha(1)),
         jme.deposit_mpn("memo", jcid, jyou.get_mpn_address(), 2,
                         JMoney(jtoken, 1000), JMoney.ziesha(1))),
        (me.withdraw_mpn("w", cid, 1, Money(token, 30), Money(token, 26),
                         you.get_address()),
         jme.withdraw_mpn("w", jcid, 1, JMoney(jtoken, 30),
                          JMoney(jtoken, 26), jyou.get_address())),
    ]
    for ours, theirs in pairs:
        assert ser.dumps(ours) == jser.dumps(theirs)
        assert ser.dumps(type(ours).read_from(ser.Reader(ser.dumps(ours)))) \
            == ser.dumps(ours)
    tx, dep, wd = (p[0] for p in pairs)
    assert tx.hash() == pairs[0][1].hash() and tx.verify_signature()
    assert dep.payment.verify_signature() and wd.verify_signature()
    assert wd.verify_calldata() and wd.calldata() == pairs[2][1].calldata()
    dep.payment.amount = Money(token, 1001)
    assert not dep.payment.verify_signature()
