"""The port's sqlite3 `DiskKvStore` (`db/__init__.py`) against the JAX
package's.

- tests/test_db.py's disk case on the port: the same pairs and checksum
  as a `RamKvStore` after the same writes, and again after the file is
  opened anew; removes, overwrites, prefixes and the empty prefix.
- A test chain over a `DiskKvStore` (genesis, a block of a send, a
  delegation, a rollback and the block again) ends with the `db_checksum`
  of the same chain over a `RamKvStore`, and opened anew from its file,
  reads the same height, tip and checksum.
- A file written by either package's `DiskKvStore` reads the same pairs
  in the other's (one table `kv (k TEXT PRIMARY KEY, v BLOB)`), and a
  JAX chain's file opens as a port chain at the same checksum.
"""

import importlib
import os
import sqlite3
import types

import pytest
import torch

from bazuka_tpu.zk import proof as jzkproof
from bazuka_tpu_torch.zk import proof as zkproof

torch.set_num_threads(1)


def lib(pkg: str):
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    db = mod("db")
    return types.SimpleNamespace(
        db=db, KvStoreChain=mod("blockchain").KvStoreChain,
        cfg=mod("config.blockchain"), tr=mod("core.transaction"),
        TxBuilder=mod("wallet.tx_builder").TxBuilder)


PORT, JAX = lib("bazuka_tpu_torch"), lib("bazuka_tpu")


@pytest.fixture(autouse=True)
def dummy_proofs_restored():
    saved = zkproof._ALLOW_DUMMY, jzkproof._ALLOW_DUMMY
    yield
    zkproof._ALLOW_DUMMY, jzkproof._ALLOW_DUMMY = saved


def fill(m, store):
    store.update([m.db.Put("aa", b"1"), m.db.Put("ab", b"2"),
                  m.db.Put("b", b"3"), m.db.Put("ba", b"4")])


def writes(m, store):
    """tests/test_db.py's writes, then an overwrite, a remove of a key
    that is not there and a binary value."""
    fill(m, store)
    store.update([m.db.Remove("b"), m.db.Put("c", b"5")])
    store.update([m.db.Put("aa", b"X" * 300), m.db.Remove("zz"),
                  m.db.Put("dé", bytes(range(256)))])


def test_disk_matches_ram(tmp_path):
    # tests/test_db.py:35 on the port
    path = os.fspath(tmp_path / "kv.sqlite")
    ram, disk = PORT.db.RamKvStore(), PORT.db.DiskKvStore(path)
    for s in (ram, disk):
        writes(PORT, s)
    assert ram.pairs("") == disk.pairs("")
    assert ram.pairs("a") == disk.pairs("a") == [("aa", b"X" * 300),
                                                  ("ab", b"2")]
    assert disk.get("b") is None and disk.get("c") == b"5"
    assert ram.checksum() == disk.checksum()
    disk.close()
    again = PORT.db.DiskKvStore(path)
    assert again.pairs("") == ram.pairs("")
    assert again.checksum() == ram.checksum()
    again.close()


def chain_steps(m, store):
    """The test chain over `store`: a block of a send, a delegation, a
    rollback and the block again.  Returns the chain."""
    chain = m.KvStoreChain(store, m.cfg.get_test_blockchain_config())
    abc, bob = m.TxBuilder(b"ABC"), m.TxBuilder(b"BOB")
    val, de = m.TxBuilder(b"VALIDATOR"), m.TxBuilder(b"DELEGATOR")
    z = m.tr.Money.ziesha
    td = abc.create_transaction("", bob.get_address(), z(100), z(5), 1)
    blk = chain.draft_block(10, [td], val, check=True)
    chain.apply_block(blk)
    chain.apply_tx(de.delegate("", val.get_address(), 10, z(0), 1).tx)
    chain.rollback()
    chain.extend(1, [blk])
    return chain


def test_chain_on_disk_equals_ram(tmp_path):
    path = os.fspath(tmp_path / "chain.sqlite")
    disk = chain_steps(PORT, PORT.db.DiskKvStore(path))
    ram = chain_steps(PORT, PORT.db.RamKvStore())
    assert disk.get_height() == ram.get_height() == 2
    assert disk.db_checksum() == ram.db_checksum()
    tip = disk.get_tip().hash()
    disk.db.close()
    again = PORT.KvStoreChain(PORT.db.DiskKvStore(path),
                              PORT.cfg.get_test_blockchain_config())
    assert again.get_height() == 2 and again.get_tip().hash() == tip
    assert again.db_checksum() == ram.db_checksum()
    again.db.close()


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_sqlite_file_opens_in_the_other_package(tmp_path, writer, reader):
    path = os.fspath(tmp_path / "kv.sqlite")
    w = writer.db.DiskKvStore(path)
    writes(writer, w)
    want = w.pairs("")
    w.close()
    with sqlite3.connect(path) as conn:
        assert conn.execute(
            "SELECT sql FROM sqlite_master WHERE name = 'kv'").fetchone() == (
            "CREATE TABLE kv (k TEXT PRIMARY KEY, v BLOB)",)
    r = reader.db.DiskKvStore(path)
    assert r.pairs("") == want and r.pairs("a") == want[:2]
    ram = reader.db.RamKvStore()
    writes(reader, ram)
    assert r.checksum() == ram.checksum()
    # and the reader writes on: the writer sees it
    r.update([reader.db.Put("e", b"6")])
    r.close()
    w2 = writer.db.DiskKvStore(path)
    assert w2.get("e") == b"6"
    w2.close()


def test_jax_chain_file_opens_as_port_chain(tmp_path):
    path = os.fspath(tmp_path / "chain.sqlite")
    jchain = chain_steps(JAX, JAX.db.DiskKvStore(path))
    want = jchain.db_checksum(), jchain.get_tip().hash()
    jchain.db.close()
    chain = PORT.KvStoreChain(PORT.db.DiskKvStore(path),
                              PORT.cfg.get_test_blockchain_config())
    assert (chain.db_checksum(), chain.get_tip().hash()) == want
    assert chain.get_height() == 2
    chain.db.close()
