"""The port's MPN witness generators and circuits against the JAX package.

- At log4 (tree, token tree, batch) = (3, 1, 1) each package runs its own
  witness generators on the same seeded transactions (2 deposits, then 2
  transfers, then 1 withdrawal): the new roots, the public inputs and the
  transitions are equal.
- Each of the three circuits of those batches compiles to the same R1CS
  arrays and full assignment in both packages, is satisfied, and is not
  once next_state is off by one.  So do the three empty circuits.
- `chip_smoke.py`'s MPN batch (deposits, then a ring of transfers) equals
  the same steps run by the JAX package at (3, 1, 1), and its pinned
  public inputs at (15, 1, 3) and (15, 1, 4), 64 and 256 transfers, are
  the JAX package's (the slow tier also recomputes the 256-transfer ones
  with the port, and both packages' constraint and variable counts).
- Slow tier: a proof of the deposit circuit at (1, 1, 0) under a key the
  port generated, on the CPU, verified.
"""

import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

import chip_smoke
from bazuka_tpu_torch.groth16.keygen import generate_parameters
from bazuka_tpu_torch.groth16.prove import create_proof
from bazuka_tpu_torch.groth16.verify import groth16_verify

# The tests are host Python; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

PACKAGES = ("bazuka_tpu", "bazuka_tpu_torch")
KINDS = ("deposit", "update", "withdraw")


def _mods(pkg: str):
    """One package's modules of the MPN path, by their last name."""
    return types.SimpleNamespace(**{
        name.split(".")[-1]: importlib.import_module(f"{pkg}.{name}")
        for name in ("core.transaction", "db", "db.keys", "utils.ser",
                     "mpn.config", "mpn.chain_view", "mpn.circuits",
                     "mpn.transitions", "mpn.deposit", "mpn.update",
                     "mpn.withdraw", "zk.state", "zk.poseidon_host",
                     "wallet.tx_builder", "blockchain.chain")})


def _state(m, log4_tree, log4_token, log4_batch):
    cid = m.transaction.ContractId(0xBEEF)
    conf = m.config.MpnConfig(log4_tree, log4_token, log4_batch, log4_batch,
                              log4_batch, cid)
    model = conf.state_model()
    db = m.db.RamKvStore()
    db.update([m.db.Put(m.keys.contract(str(cid)), m.ser.dumps(
        m.state.ZkContract(m.state.ZkCompressedState.empty(model), model)))])
    return cid, m.chain_view.MpnChainView(db)


def _deposit_all(m, cid, chain, users, log4):
    money = m.transaction.Money
    token = m.transaction.ContractId(123)
    deps = [u.deposit_mpn("", cid, u.get_mpn_address(), 1,
                          money(token, 1000), money.ziesha(0))
            for u in users]
    idx = {}
    out = m.deposit.deposit(cid, *log4, chain, deps, idx, check_balance=False)
    for addr, i in idx.items():
        chain.add_mpn_account_index(addr, i)
    return out


def _batches(pkg: str):
    """2 deposits, then 2 transfers, then 1 withdrawal at (3, 1, 1):
    {kind: (new root, public inputs, transitions)}."""
    m = _mods(pkg)
    log4 = (3, 1, 1)
    cid, chain = _state(m, *log4)
    money, token = m.transaction.Money, m.transaction.ContractId(123)
    alice, bob = (m.tx_builder.TxBuilder(s) for s in (b"ABC", b"XYZ"))
    out = {"deposit": _deposit_all(m, cid, chain, [alice, bob], log4)}
    txs = [a.create_mpn_transaction(b.get_mpn_address(), money(token, 100),
                                    money(token, 7), 1)
           for a, b in ((alice, bob), (bob, alice))]
    out["update"] = m.update.update(cid, *log4, token, chain, txs, {})
    wd = alice.withdraw_mpn("", cid, 1, money(token, 30), money(token, 26),
                            alice.get_address())
    wd_bad_nonce = bob.withdraw_mpn("", cid, 5, money(token, 1),
                                    money(token, 1), bob.get_address())
    out["withdraw"] = m.withdraw.withdraw(cid, *log4, chain,
                                          [wd, wd_bad_nonce], {})
    return out


@pytest.fixture(scope="module")
def batches():
    return {pkg: _batches(pkg) for pkg in PACKAGES}


def _circuit(pkg: str, kind: str, batch, commitment=5):
    m = _mods(pkg)
    _, pubs, transitions = batch
    cls = {"deposit": m.circuits.DepositCircuit,
           "update": m.circuits.UpdateCircuit,
           "withdraw": m.circuits.WithdrawCircuit}[kind]
    null = {"deposit": m.transitions.DepositTransition,
            "update": m.transitions.UpdateTransition,
            "withdraw": m.transitions.WithdrawTransition}[kind].null
    c = cls(3, 1, 1, commitment, *pubs.as_list(),
            transitions=list(transitions)
            + [null(3, 1) for _ in range(4 - len(transitions))])
    if kind == "update":
        c.fee_token = 123
    return c


def _assert_same_r1cs(cs, jcs):
    comp, jcomp = cs.compiled(), jcs.compiled()
    assert (comp.num_vars, comp.num_inputs, comp.n_constraints) == (
        jcomp.num_vars, jcomp.num_inputs, jcomp.n_constraints)
    for m in range(3):
        for field in ("rows", "vars", "cids"):
            assert np.array_equal(getattr(comp, field)[m],
                                  getattr(jcomp, field)[m]), (m, field)
    assert comp.palette == jcomp.palette
    assert list(cs.full_assignment()) == list(jcs.full_assignment())


def test_witness_generators_match_jax(batches):
    ours, theirs = batches["bazuka_tpu_torch"], batches["bazuka_tpu"]
    for kind, n in zip(KINDS, (2, 2, 1)):
        (root, pubs, trans), (jroot, jpubs, jtrans) = ours[kind], theirs[kind]
        assert len(trans) == n, kind
        assert (root.state_hash, root.state_size) == (jroot.state_hash,
                                                      jroot.state_size)
        assert pubs.as_list() == jpubs.as_list()
        assert pubs.state != pubs.next_state
        assert ([dataclasses.asdict(t) for t in trans]
                == [dataclasses.asdict(t) for t in jtrans])


@pytest.mark.parametrize("kind", KINDS)
def test_circuit_matches_jax(batches, kind):
    ours = _circuit("bazuka_tpu_torch", kind, batches["bazuka_tpu_torch"][kind])
    theirs = _circuit("bazuka_tpu", kind, batches["bazuka_tpu"][kind])
    synth = _mods("bazuka_tpu_torch").circuits.synthesize_circuit
    cs = synth(ours)
    _assert_same_r1cs(cs, _mods("bazuka_tpu").circuits.synthesize_circuit(
        theirs))
    assert cs.is_satisfied() is None
    ours.next_state += 1
    assert synth(ours).is_satisfied() is not None


@pytest.mark.parametrize("kind", KINDS)
def test_empty_circuit_matches_jax(kind):
    """As tests/test_mpn_circuits.py:test_empty_circuits_satisfied, in both
    packages."""
    out = {}
    for pkg in PACKAGES:
        m = _mods(pkg)
        root = m.state.compress_default(
            m.config.MpnConfig(3, 1, 1, 1, 1, m.transaction.ContractId(0xBEEF))
            .state_model())
        if kind == "deposit":
            c = m.circuits.DepositCircuit.empty(3, 1, 1)
            c.aux_data = m.deposit.compute_deposit_aux([], 1)
        elif kind == "withdraw":
            c = m.circuits.WithdrawCircuit.empty(3, 1, 1)
            c.aux_data = m.withdraw.compute_withdraw_aux([], 1)
        else:
            c = m.circuits.UpdateCircuit.empty(3, 1, 1)
            c.fee_token = 123
            c.aux_data = m.poseidon_host.PoseidonHasher.hash([123, 0])
        c.state = c.next_state = root
        out[pkg] = m.circuits.synthesize_circuit(c)
    _assert_same_r1cs(out["bazuka_tpu_torch"], out["bazuka_tpu"])
    assert out["bazuka_tpu_torch"].is_satisfied() is None


def _jax_update_batch(log4_tree, log4_token, log4_batch):
    """chip_smoke.mpn_update_batch's steps on the JAX package:
    (public inputs, transitions)."""
    m = _mods("bazuka_tpu")
    log4 = (log4_tree, log4_token, log4_batch)
    n = 1 << (2 * log4_batch)
    cid, chain = _state(m, *log4)
    money, token = m.transaction.Money, m.transaction.ContractId(123)
    users = [m.tx_builder.TxBuilder(b"U%d" % i) for i in range(n)]
    _deposit_all(m, cid, chain, users, log4)
    txs = [users[i].create_mpn_transaction(
        users[(i + 1) % n].get_mpn_address(), money(token, 100),
        money(token, 7), 1) for i in range(n)]
    _, pubs, trans = m.update.update(cid, *log4, token, chain, txs, {})
    worker = m.tx_builder.TxBuilder(b"WORKER").get_address()
    return [m.chain.prover_commitment(worker, 10), *pubs.as_list()], trans


def test_chip_smoke_batch_matches_jax():
    circuit, inputs, txs = chip_smoke.mpn_update_batch(3, 1, 1)
    jinputs, jtrans = _jax_update_batch(3, 1, 1)
    assert inputs == jinputs
    assert ([dataclasses.asdict(t) for t in circuit.transitions]
            == [dataclasses.asdict(t) for t in jtrans])
    assert all(t.enabled for t in circuit.transitions)
    assert (circuit.commitment, circuit.height, circuit.state,
            circuit.aux_data, circuit.next_state) == tuple(inputs)
    assert len(txs) == 4 and all(tx.verify_signature() for tx in txs)


def test_chip_smoke_public_inputs_are_jax_s():
    """The batches of 64 and of 256 transfers (mainnet's) at log4_tree 15
    that phase 6 proves."""
    for log4_batch, pinned in (
            (chip_smoke.MPN_B64_LOG4_BATCH, chip_smoke.MPN_B64_PUBLIC_INPUTS),
            (chip_smoke.MPN_LOG4_BATCH, chip_smoke.MPN_B256_PUBLIC_INPUTS)):
        inputs, trans = _jax_update_batch(chip_smoke.MPN_LOG4_TREE,
                                          chip_smoke.MPN_LOG4_TOKEN_TREE,
                                          log4_batch)
        assert len(trans) == 4 ** log4_batch
        assert all(t.enabled for t in trans)
        assert tuple(inputs) == pinned


@pytest.mark.slow
def test_chip_smoke_b256_pins_in_both_packages():
    """Phase 6's pinned values at (15, 1, 4), recomputed: the public
    inputs by each package's witness generators, and the constraint and
    variable counts by each package's update circuit synthesised in setup
    mode (no witness, a few GB; the proving-mode synthesis takes tens)."""
    log4 = (chip_smoke.MPN_LOG4_TREE, chip_smoke.MPN_LOG4_TOKEN_TREE,
            chip_smoke.MPN_LOG4_BATCH)
    _, inputs, txs = chip_smoke.mpn_update_batch(*log4)
    assert len(txs) == 256
    assert tuple(inputs) == chip_smoke.MPN_B256_PUBLIC_INPUTS
    assert _jax_update_batch(*log4)[0] == inputs
    for pkg in PACKAGES:
        m = _mods(pkg)
        c = m.circuits.UpdateCircuit.empty(*log4)
        cs = m.circuits.synthesize_circuit(c, proving=False)
        assert cs.n_constraints == chip_smoke.MPN_B256_CONSTRAINTS, pkg
        assert len(cs.assignment) == chip_smoke.MPN_B256_VARS, pkg
        del cs


@pytest.mark.slow
def test_deposit_proof_on_cpu():
    """The deposit circuit at (1, 1, 0): 4,948 constraints, d = 2^13."""
    m = _mods("bazuka_tpu_torch")
    log4 = (1, 1, 0)
    cid, chain = _state(m, *log4)
    user = m.tx_builder.TxBuilder(b"ABC")
    _, pubs, trans = _deposit_all(m, cid, chain, [user], log4)
    commitment = m.chain.prover_commitment(user.get_address(), 3)
    c = m.circuits.DepositCircuit(*log4, commitment, *pubs.as_list(),
                                  transitions=trans)
    cs = m.circuits.synthesize_circuit(c)
    assert cs.n_constraints == 4948 and cs.is_satisfied() is None
    params = generate_parameters(cs, seed=b"mpn-deposit", device="cpu")
    proof = create_proof(params, cs, r=7, s=11, device="cpu")
    inputs = [commitment, *pubs.as_list()]
    assert groth16_verify(params.vk, inputs, proof)
    assert not groth16_verify(params.vk, inputs[:4] + [inputs[4] + 1], proof)
