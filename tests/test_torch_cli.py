"""The port's command line (`cli/`) against the JAX package's.

- `init --mnemonic <pinned>` under a temporary HOME writes the same
  config (`~/.bazuka-tpu.json`) and the same wallet file
  (`~/.bazuka-tpu-wallet.json`) in both packages, and refuses to
  overwrite them without `--force`.
- `wallet add-token`, `wallet reset` and `wallet info` (with no node
  running) on that wallet act the same in both packages.
- Both parsers have the same commands, and each command the same
  options, defaults and requirements.
- Against a port node served over HTTP on 127.0.0.1 at the configured
  port, both packages' `node status`, `node add-mpn-worker`, `wallet
  info` and `wallet send` give the same answers, and the sends reach the
  node's mempool.
- `python -m bazuka_tpu_torch.cli --help` runs.

None of them opens the chain: `_chain()` builds the mainnet genesis.
"""

import argparse
import asyncio
import contextlib
import importlib
import io
import os
import json
import socket
import subprocess
import sys
import threading

from bazuka_tpu_torch.core.transaction import ContractId

PORT = importlib.import_module("bazuka_tpu_torch.cli")
JAX = importlib.import_module("bazuka_tpu.cli")

MNEMONIC = ("legal winner thank year wave sausage worth useful legal winner"
            " thank yellow")
TOKEN = str(ContractId(12345))  # a token's contract id, as displayed


def run_cli(cli, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def files(home):
    """The config and wallet files, HOME written as "~"."""
    return {name: open(os.path.join(home, name), "rb").read().replace(
                home.encode(), b"~")
            for name in (".bazuka-tpu.json", ".bazuka-tpu-wallet.json")}


def session(cli, home, monkeypatch):
    """`init`, a refused second `init`, `wallet info` with the node
    offline, `wallet add-token`, `wallet reset`: each step's exit code,
    output and the files after it."""
    os.makedirs(home)
    monkeypatch.setenv("HOME", home)
    steps = []
    for argv in (["init", "--mnemonic", MNEMONIC, "--port", "18765",
                  "--bootstrap", "10.0.0.1:8765", "10.0.0.2:8765"],
                 ["init", "--mnemonic", MNEMONIC],
                 ["wallet", "info"],
                 ["wallet", "add-token", TOKEN],
                 ["wallet", "reset"]):
        rc, out = run_cli(cli, argv)
        steps.append((argv, rc, out.replace(home, "~"), files(home)))
    return steps


def test_init_and_wallet_commands_equal_jax(tmp_path, monkeypatch):
    port = session(PORT, os.fspath(tmp_path / "port"), monkeypatch)
    jax = session(JAX, os.fspath(tmp_path / "jax"), monkeypatch)
    for p, j in zip(port, jax):
        assert p == j, p[0]
    assert [s[1] for s in port] == [0, 1, 0, 0, 0]
    assert MNEMONIC in port[0][2] and "node offline" in port[2][2]
    assert port[3][3] != port[2][3]


def tree(parser):
    """A parser's commands and options as nested plain values."""
    out = {"prog": parser.prog, "description": parser.description}
    opts = []
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            out["commands"] = {name: tree(sub)
                               for name, sub in a.choices.items()}
            out["commands_dest"] = (a.dest, a.required)
        elif not isinstance(a, argparse._HelpAction):
            opts.append((tuple(a.option_strings), a.dest, a.required,
                         a.default, a.nargs, getattr(a.type, "__name__", None),
                         type(a).__name__))
    out["options"] = opts
    return out


def test_parsers_have_the_same_commands_and_options():
    port, jax = tree(PORT.build_parser()), tree(JAX.build_parser())
    assert port == jax
    assert sorted(port["commands"]) == ["chain", "init", "node", "wallet"]
    assert sorted(port["commands"]["wallet"]["commands"]) == sorted([
        "info", "send", "register-validator", "delegate", "new-token",
        "undelegate", "auto-delegate", "add-token", "reset",
        "resend-pending"])


def test_python_m_runs(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "bazuka_tpu_torch.cli", "--help"],
        cwd=root, capture_output=True, text=True, timeout=120,
        env={**os.environ, "HOME": os.fspath(tmp_path)})
    assert res.returncode == 0, res.stderr
    assert "init" in res.stdout and "wallet" in res.stdout
    assert "jax" not in res.stderr


class ServedNode:
    """A port node on the test chain, served over HTTP on 127.0.0.1:port
    by an event loop of its own in a thread."""

    def __init__(self, port: int):
        from bazuka_tpu_torch.blockchain import KvStoreChain
        from bazuka_tpu_torch.client import OutgoingSender, PeerAddress
        from bazuka_tpu_torch.config.blockchain import (
            get_test_blockchain_config)
        from bazuka_tpu_torch.db import RamKvStore
        from bazuka_tpu_torch.node import (get_simulator_options,
                                           node_create, serve_http)
        from bazuka_tpu_torch.wallet.tx_builder import TxBuilder

        async def nowhere(peer, req):
            raise ConnectionError("no peers")

        self.node = node_create(
            get_simulator_options(), "sim", PeerAddress("127.0.0.1", port),
            [], KvStoreChain(RamKvStore(), get_test_blockchain_config()),
            (TxBuilder(b"VALIDATOR"), TxBuilder(b"VALIDATOR-user")),
            OutgoingSender(nowhere))
        self.node.context.mempool.min_balance_per_tx = 1
        self.loop = asyncio.new_event_loop()
        self.port = port
        self._serve = serve_http
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.tasks = [self.loop.create_task(self.node.run()),
                      self.loop.create_task(
                          self._serve(self.node, "127.0.0.1", self.port))]
        self.loop.run_until_complete(asyncio.gather(
            *self.tasks, return_exceptions=True))

    def __enter__(self):
        self.thread.start()
        for _ in range(200):
            with socket.socket() as sock:
                if sock.connect_ex(("127.0.0.1", self.port)) == 0:
                    return self
            threading.Event().wait(0.05)
        raise TimeoutError("the node is not served")

    def __exit__(self, *exc):
        def stop():
            self.node.context.shutdown = True
            for t in self.tasks:
                t.cancel()
        self.loop.call_soon_threadsafe(stop)
        self.thread.join(timeout=30)


def test_cli_talks_to_a_served_node(tmp_path, monkeypatch):
    from bazuka_tpu_torch.wallet.tx_builder import TxBuilder
    from bazuka_tpu_torch.zk import proof as zkproof
    from bazuka_tpu.zk import proof as jzkproof

    saved = zkproof._ALLOW_DUMMY, jzkproof._ALLOW_DUMMY
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    home = os.fspath(tmp_path / "home")
    os.makedirs(home)
    monkeypatch.setenv("HOME", home)
    bob = str(TxBuilder(b"BOB").get_address())
    try:
        assert run_cli(PORT, ["init", "--mnemonic", MNEMONIC, "--port",
                              str(port)])[0] == 0
        with ServedNode(port) as served:
            out = {}
            for name, cli in (("port", PORT), ("jax", JAX)):
                rc, status = run_cli(cli, ["node", "status"])
                stats = json.loads(status)
                for key in ("timestamp", "epoch", "slot"):  # the clock's
                    stats.pop(key)
                rc2, worker = run_cli(cli, ["node", "add-mpn-worker", bob])
                rc3, info = run_cli(cli, ["wallet", "info"])
                rc4, sent = run_cli(cli, ["wallet", "send", "--to", bob,
                                          "--amount", "0.000000001"])
                out[name] = ([rc, rc2, rc3, rc4], stats, worker, info, sent)
            mempool = len(served.node.context.mempool)
            workers = sorted(served.node.context.mpn_workers)
    finally:
        zkproof._ALLOW_DUMMY, jzkproof._ALLOW_DUMMY = saved
    assert out["port"] == out["jax"]
    rcs, stats, worker, info, sent = out["port"]
    assert rcs == [0, 0, 0, 0]
    assert stats["height"] == 1 and stats["network"] == "sim"
    assert json.loads(worker) == {"accepted": True} and workers == [bob]
    assert "Ziesha balance:   0" in info and json.loads(sent) == {}
    # the same send twice: one queued (the second repeats its nonce)
    assert mempool == 1
