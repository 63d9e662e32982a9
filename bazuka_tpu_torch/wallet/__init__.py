"""Wallets: mnemonic -> per-role seeds -> TxBuilder key bundles
(reference: src/wallet/mod.rs).

Full BIP39 compatibility (reference uses the bip39 crate,
src/wallet/mod.rs:16-35): generation, checksum validation and seed
derivation (PBKDF2-HMAC-SHA512, 2048 rounds, salt
"mnemonic"+passphrase) all use the standard English 2048-word list,
vendored as `bip39_english.txt` (sha256
2f5eed53a4727b4bf8880d8f3f199efc90e58503646d9ff8eff3a2ed3b24dbda —
the canonical list).  Phrases from the pre-round-3 compact syllable
scheme still validate for import (legacy branch in
`validate_checksum`).
A copy of `bazuka_tpu/wallet/__init__.py`.
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..core import GeneralTransaction, NonceGroup
from ..core.transaction import ContractId
from .tx_builder import TxBuilder

with open(os.path.join(os.path.dirname(__file__), "bip39_english.txt")) as _f:
    WORDLIST = _f.read().split()
assert len(WORDLIST) == 2048
_WORD_INDEX = {w: i for i, w in enumerate(WORDLIST)}

# pre-round-3 compact scheme (16 consonant-vowel pairs squared): accepted
# on import only, never generated
_SYL = ["ba", "ce", "di", "fo", "gu", "ha", "je", "ki", "lo", "mu",
        "na", "pe", "ri", "so", "tu", "za"]
_LEGACY_WORDS = [a + b for a in _SYL for b in _SYL]
_LEGACY_INDEX = {w: i for i, w in enumerate(_LEGACY_WORDS)}


class Mnemonic:
    def __init__(self, phrase: str):
        self.phrase = phrase.strip()

    @staticmethod
    def from_entropy(ent: bytes) -> "Mnemonic":
        """Standard BIP39 encoding: ENT bits + ENT/32 checksum bits from
        SHA-256, split into 11-bit word indexes."""
        if len(ent) not in (16, 20, 24, 28, 32):
            raise ValueError("entropy must be 128-256 bits")
        cs_bits = len(ent) * 8 // 32
        check = hashlib.sha256(ent).digest()
        bits = "".join(f"{b:08b}" for b in ent)
        bits += "".join(f"{b:08b}" for b in check)[:cs_bits]
        words = [
            WORDLIST[int(bits[i : i + 11], 2)] for i in range(0, len(bits), 11)
        ]
        return Mnemonic(" ".join(words))

    @staticmethod
    def generate(entropy_bytes: int = 16) -> "Mnemonic":
        return Mnemonic.from_entropy(secrets.token_bytes(entropy_bytes))

    def validate_checksum(self) -> bool:
        words = self.phrase.split()
        if len(words) in (12, 15, 18, 21, 24) and all(
            w in _WORD_INDEX for w in words
        ):
            bits = "".join(f"{_WORD_INDEX[w]:011b}" for w in words)
            ent_bits = len(bits) * 32 // 33
            ent = int(bits[:ent_bits], 2).to_bytes(ent_bits // 8, "big")
            cs = len(bits) - ent_bits
            check = "".join(
                f"{b:08b}" for b in hashlib.sha256(ent).digest()
            )[:cs]
            return bits[ent_bits:] == check
        # legacy compact phrases (pre-round-3 wallets): 2-letter syllable
        # words, one trailing sha3 checksum byte
        if len(words) >= 2 and all(w in _LEGACY_INDEX for w in words):
            data = bytes(_LEGACY_INDEX[w] for w in words)
            return hashlib.sha3_256(data[:-1]).digest()[0] == data[-1]
        return False

    def to_seed(self, passphrase: str = "") -> bytes:
        """BIP39 seed derivation (works for ANY phrase)."""
        return hashlib.pbkdf2_hmac(
            "sha512",
            self.phrase.encode("utf-8"),
            b"mnemonic" + passphrase.encode("utf-8"),
            2048,
            dklen=64,
        )

    def __str__(self):
        return self.phrase


USER = "user"
VALIDATOR = "validator"


def _passphrase(wallet_type: str, index: int = 0) -> str:
    if wallet_type == VALIDATOR:
        return "validator"
    return "" if index == 0 else str(index)


@dataclass
class Wallet:
    """One role's wallet: token list + pending-tx tracking
    (reference: src/wallet/mod.rs:88-140)."""

    mnemonic: Mnemonic
    wallet_type: str
    index: int = 0
    tokens: List[ContractId] = field(default_factory=lambda: [ContractId.ZIESHA])
    txs: Dict[NonceGroup, List[GeneralTransaction]] = field(default_factory=dict)

    def seed(self) -> bytes:
        return self.mnemonic.to_seed(_passphrase(self.wallet_type, self.index))

    def tx_builder(self) -> TxBuilder:
        return TxBuilder(self.seed())

    def add_token(self, token_id: ContractId):
        if token_id not in self.tokens:
            self.tokens.append(token_id)

    def add_tx(self, tx: GeneralTransaction):
        self.txs.setdefault(tx.nonce_group(), []).append(tx)

    def new_nonce(self, group: NonceGroup) -> Optional[int]:
        pending = self.txs.get(group)
        if pending:
            return max(tx.nonce() for tx in pending) + 1
        return None

    def reset(self):
        for k in self.txs:
            self.txs[k] = []


class WalletCollection:
    """Mnemonic + per-role wallets, persisted as JSON
    (reference: src/wallet/mod.rs:45-87)."""

    def __init__(self, mnemonic: Optional[Mnemonic] = None):
        self.mnemonic = mnemonic or Mnemonic.generate()
        self.wallets: Dict[str, Wallet] = {}

    def user(self, index: int) -> Wallet:
        key = f"{USER}-{index}"
        if key not in self.wallets:
            self.wallets[key] = Wallet(self.mnemonic, USER, index)
        return self.wallets[key]

    def validator(self) -> Wallet:
        if VALIDATOR not in self.wallets:
            self.wallets[VALIDATOR] = Wallet(self.mnemonic, VALIDATOR)
        return self.wallets[VALIDATOR]

    def save(self, path: str):
        data = {
            "mnemonic": str(self.mnemonic),
            "wallets": {
                key: {"tokens": [str(t) for t in w.tokens]}
                for key, w in self.wallets.items()
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, path)

    @staticmethod
    def open(path: str) -> Optional["WalletCollection"]:
        if not os.path.exists(path):
            return None
        with open(path) as f:
            data = json.load(f)
        wc = WalletCollection(Mnemonic(data["mnemonic"]))
        for key, wdata in data.get("wallets", {}).items():
            if key == VALIDATOR:
                w = wc.validator()
            else:
                w = wc.user(int(key.split("-")[1]))
            w.tokens = [ContractId.parse(t) for t in wdata.get("tokens", [])]
        return wc
