"""The port's wallet (`wallet/__init__.py`: `Mnemonic`, `Wallet`,
`WalletCollection`) against the JAX package's.

- tests/test_wallet.py's cases on the port: the canonical BIP39 wordlist,
  the Trezor vectors (phrases and the seed with passphrase "TREZOR"),
  tampered and short phrases refused, generated phrases standard, the
  legacy compact phrases.
- The port's `bip39_english.txt` is byte-equal to the JAX package's.
- The same entropy gives the same phrase and every role's seed in both
  packages.
- A wallet file saved by either package opens in the other with the same
  mnemonic, wallets and tokens, and the same L1, MPN, validator and VRF
  addresses; the other package saves it back byte for byte.
- `Wallet`'s pending-transaction tracking (`add_tx`, `new_nonce`,
  `reset`) is the JAX package's.
"""

import hashlib
import importlib
import json
import os
import types

import pytest

from bazuka_tpu_torch.wallet import _LEGACY_WORDS, WORDLIST, Mnemonic

# tests/test_wallet.py's vectors: (entropy hex, phrase, seed with passphrase
# "TREZOR")
VECTORS = [
    ("00000000000000000000000000000000",
     "abandon abandon abandon abandon abandon abandon abandon abandon"
     " abandon abandon abandon about",
     "c55257c360c07c72029aebc1b53c05ed0362ada38ead3e3e9efa3708e5349553"
     "1f09a6987599d18264c1e1c92f2cf141630c7a3c4ab7c81b2f001698e7463b04"),
    ("7f7f7f7f7f7f7f7f7f7f7f7f7f7f7f7f",
     "legal winner thank year wave sausage worth useful legal winner"
     " thank yellow", None),
    ("9e885d952ad362caeb4efe34a8e91bd2",
     "ozone drill grab fiber curtain grace pudding thank cruise elder"
     " eight picnic", None),
    ("ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff",
     "zoo zoo zoo zoo zoo zoo zoo zoo zoo zoo zoo zoo zoo zoo zoo zoo"
     " zoo zoo zoo zoo zoo zoo zoo vote", None),
]


def lib(pkg: str):
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    w = mod("wallet")
    return types.SimpleNamespace(
        w=w, tr=mod("core.transaction"), core=mod("core"),
        TxBuilder=mod("wallet.tx_builder").TxBuilder)


PORT, JAX = lib("bazuka_tpu_torch"), lib("bazuka_tpu")


def test_wordlist_is_canonical_and_equal():
    assert len(WORDLIST) == 2048
    data = "\n".join(WORDLIST) + "\n"
    assert hashlib.sha256(data.encode()).hexdigest() == (
        "2f5eed53a4727b4bf8880d8f3f199efc90e58503646d9ff8eff3a2ed3b24dbda")
    paths = [os.path.join(os.path.dirname(m.w.__file__), "bip39_english.txt")
             for m in (PORT, JAX)]
    raw = [open(p, "rb").read() for p in paths]
    assert raw[0] == raw[1]
    assert WORDLIST == JAX.w.WORDLIST


def test_bip39_vectors():
    for ent_hex, phrase, seed in VECTORS:
        m = Mnemonic.from_entropy(bytes.fromhex(ent_hex))
        assert m.phrase == phrase, ent_hex
        assert m.validate_checksum()
        if seed is not None:
            assert Mnemonic(phrase).to_seed("TREZOR").hex() == seed


def test_checksum_rejects_tampering_and_generated_phrases_are_standard():
    m = Mnemonic.from_entropy(bytes(16))
    words = m.phrase.split()
    words[0] = "ability"
    assert not Mnemonic(" ".join(words)).validate_checksum()
    assert not Mnemonic(" ".join(words[:11])).validate_checksum()
    g = Mnemonic.generate()
    assert len(g.phrase.split()) == 12
    assert all(w in WORDLIST for w in g.phrase.split())
    assert g.validate_checksum()


def test_legacy_compact_phrases_still_import():
    data = bytes(range(3, 11))
    check = hashlib.sha3_256(data).digest()[0]
    phrase = " ".join(_LEGACY_WORDS[b] for b in data + bytes([check]))
    assert Mnemonic(phrase).validate_checksum()
    assert JAX.w.Mnemonic(phrase).validate_checksum()
    bad = phrase.split()
    bad[0] = _LEGACY_WORDS[(data[0] + 1) % 256]
    assert not Mnemonic(" ".join(bad)).validate_checksum()


def test_roles_and_seeds_equal_jax():
    ent = bytes(range(16, 48))
    pm, jm = PORT.w.Mnemonic.from_entropy(ent), JAX.w.Mnemonic.from_entropy(ent)
    assert pm.phrase == jm.phrase
    pc, jc = PORT.w.WalletCollection(pm), JAX.w.WalletCollection(jm)
    for p, j in ((pc.validator(), jc.validator()), (pc.user(0), jc.user(0)),
                 (pc.user(3), jc.user(3))):
        assert p.seed() == j.seed()
        assert addresses(p.tx_builder()) == addresses(j.tx_builder())
    assert pc.validator().seed() != pc.user(0).seed() != pc.user(3).seed()


def addresses(tb):
    return (str(tb.get_address()), str(tb.get_mpn_address()),
            str(tb.get_vrf_public_key()))


def collection(m, phrase):
    wc = m.w.WalletCollection(m.w.Mnemonic(phrase))
    wc.user(0)
    wc.user(2).add_token(m.tr.ContractId(12345))
    wc.validator()
    return wc


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_wallet_file_opens_in_the_other_package(tmp_path, writer, reader):
    phrase = VECTORS[2][1]
    path = os.fspath(tmp_path / "wallet.json")
    wc = collection(writer, phrase)
    wc.save(path)
    opened = reader.w.WalletCollection.open(path)
    assert str(opened.mnemonic) == phrase
    assert sorted(opened.wallets) == sorted(wc.wallets) == [
        "user-0", "user-2", "validator"]
    for key, w in wc.wallets.items():
        o = opened.wallets[key]
        assert [str(t) for t in o.tokens] == [str(t) for t in w.tokens]
        assert (o.wallet_type, o.index) == (w.wallet_type, w.index)
        assert addresses(o.tx_builder()) == addresses(w.tx_builder())
    again = os.fspath(tmp_path / "again.json")
    opened.save(again)
    assert open(again, "rb").read() == open(path, "rb").read()
    assert json.load(open(path))["mnemonic"] == phrase
    assert reader.w.WalletCollection.open(os.fspath(tmp_path / "no")) is None


def test_pending_txs_equal_jax():
    out = []
    for m in (PORT, JAX):
        wc = collection(m, VECTORS[1][1])
        w, tb = wc.user(0), wc.user(0).tx_builder()
        bob = m.TxBuilder(b"BOB")
        z = m.tr.Money.ziesha
        group = None
        for n in (1, 2, 5):
            gt = m.core.GeneralTransaction(tb.create_transaction(
                "", bob.get_address(), z(10), z(1), n))
            group = gt.nonce_group()
            w.add_tx(gt)
        nonce = w.new_nonce(group)
        w.reset()
        out.append((nonce, w.new_nonce(group), [str(t) for t in w.tokens],
                    group.kind, group.address))
    assert out[0] == out[1]
    assert out[0][:2] == (6, None)
