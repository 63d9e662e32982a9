"""Command-line interface (reference: src/cli/).

Commands: `init`, `node {start,status,add-mpn-worker}`,
`wallet {new-token,send,register-validator,delegate,auto-delegate,
undelegate,reset,info,resend-pending,add-token}`,
`chain {rollback,db-query,health-check}`.

Config lives at ~/.bazuka-tpu.json (reference: ~/.bazuka.yaml).
A copy of `bazuka_tpu/cli/__init__.py`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

CURRENT_NETWORK = "deruny-tpu-1"
DEFAULT_PORT = 8765


def config_path() -> str:
    return os.path.expanduser("~/.bazuka-tpu.json")


def wallet_path() -> str:
    return os.path.expanduser("~/.bazuka-tpu-wallet.json")


def db_path() -> str:
    return os.path.expanduser("~/.bazuka-tpu-chain.sqlite")


def load_config():
    with open(config_path()) as f:
        return json.load(f)


def _open_wallet():
    from ..wallet import WalletCollection

    wc = WalletCollection.open(wallet_path())
    if wc is None:
        print("No wallet! Run `bazuka-tpu init` first.", file=sys.stderr)
        sys.exit(1)
    return wc


def _chain(conf=None):
    from ..blockchain import KvStoreChain
    from ..config.blockchain import get_blockchain_config
    from ..db import DiskKvStore

    return KvStoreChain(DiskKvStore(db_path()), get_blockchain_config())


# ---------------------------------------------------------------- commands


def cmd_init(args):
    """(reference: src/cli/init.rs) — write config + generate mnemonic."""
    from ..wallet import Mnemonic, WalletCollection

    if os.path.exists(config_path()) and not args.force:
        print("Config already exists! Use --force to overwrite.")
        return 1
    mnemonic = Mnemonic(args.mnemonic) if args.mnemonic else None
    wc = WalletCollection(mnemonic)
    wc.user(0)
    wc.validator()
    wc.save(wallet_path())
    cfg = {
        "network": CURRENT_NETWORK,
        "external": args.external or f"127.0.0.1:{DEFAULT_PORT}",
        "listen": f"0.0.0.0:{args.port}",
        "bootstrap": args.bootstrap or [],
        "db": db_path(),
    }
    with open(config_path(), "w") as f:
        json.dump(cfg, f, indent=1)
    print("Config written to", config_path())
    print("Wallet created! Your mnemonic phrase (KEEP SAFE!):")
    print(" ", str(wc.mnemonic))
    print("Your L1 address:", wc.user(0).tx_builder().get_address())
    print("Your MPN address:", wc.user(0).tx_builder().get_mpn_address())
    return 0


def cmd_node_start(args):
    """(reference: src/cli/node/start.rs)."""
    from ..client import PeerAddress
    from ..node import Firewall, get_node_options, http_sender, node_create, serve_http

    cfg = load_config()
    wc = _open_wallet()
    chain = _chain()
    validator = wc.validator().tx_builder()
    user = wc.user(0).tx_builder()
    listen_ip, listen_port = cfg["listen"].rsplit(":", 1)
    node = node_create(
        get_node_options(),
        cfg["network"],
        PeerAddress.parse(cfg["external"]),
        [PeerAddress.parse(b) for b in cfg.get("bootstrap", [])],
        chain,
        (validator, user),
        http_sender(signer=user),
        firewall=Firewall(),
    )
    print(f"Node listening on {cfg['listen']} (network {cfg['network']})")

    async def main():
        await asyncio.gather(
            node.run(), serve_http(node, listen_ip, int(listen_port))
        )

    asyncio.run(main())
    return 0


def _local_client():
    from ..client import BazukaClient, PeerAddress
    from ..node import http_sender

    cfg = load_config()
    _, port = cfg["listen"].rsplit(":", 1)
    return BazukaClient(http_sender(), PeerAddress("127.0.0.1", int(port)))


def cmd_node_status(args):
    client = _local_client()
    print(json.dumps(asyncio.run(client.stats()), indent=1))
    return 0


def cmd_node_add_mpn_worker(args):
    from ..client import PeerAddress
    from ..node import http_sender

    cfg = load_config()
    _, port = cfg["listen"].rsplit(":", 1)
    sender = http_sender()
    resp = asyncio.run(
        sender.json_post(
            PeerAddress("127.0.0.1", int(port)),
            "/bincode/mpn/worker",
            {"address": args.address},
        )
    )
    print(json.dumps(resp))
    return 0


def cmd_wallet_info(args):
    wc = _open_wallet()
    tb = wc.user(0).tx_builder()
    vb = wc.validator().tx_builder()
    print("L1 address:      ", tb.get_address())
    print("MPN address:     ", tb.get_mpn_address())
    print("Validator:       ", vb.get_address())
    print("VRF public key:  ", vb.get_vrf_public_key())
    try:
        client = _local_client()
        bal = asyncio.run(client.get_balance(str(tb.get_address()), "Ziesha"))
        print("Ziesha balance:  ", bal["balance"])
    except Exception:
        print("(node offline — balances unavailable)")
    return 0


def _send_tx(general_tx):
    from ..core import GeneralTransaction

    client = _local_client()
    resp = asyncio.run(client.transact(GeneralTransaction(general_tx)))
    print(json.dumps(resp))


def cmd_wallet_send(args):
    from ..core import parse_general_address
    from ..core.address import MpnAddress
    from ..core.money import Decimal
    from ..core.transaction import ContractId, Money
    from ..crypto.ed25519 import PublicKey

    wc = _open_wallet()
    tb = wc.user(0).tx_builder()
    token = ContractId.parse(args.token) if args.token else ContractId.ZIESHA
    amount = Decimal.parse(args.amount).to_amount(9)
    fee = Decimal.parse(args.fee).to_amount(9)
    dst = parse_general_address(args.to)
    client = _local_client()
    if isinstance(dst, MpnAddress):
        acct = asyncio.run(client.get_mpn_account(str(tb.get_mpn_address())))
        nonce = acct["account"]["tx_nonce"] + 1
        tx = tb.create_mpn_transaction(dst, Money(token, amount), Money(token, fee), nonce)
    else:
        acct = asyncio.run(client.get_account(str(tb.get_address())))
        nonce = acct["nonce"] + 1
        tx = tb.create_transaction(args.memo, dst, Money(token, amount),
                                  Money.ziesha(fee), nonce)
    _send_tx(tx)
    return 0


def cmd_wallet_register_validator(args):
    from ..core.money import Ratio
    from ..core.transaction import Money

    wc = _open_wallet()
    vb = wc.validator().tx_builder()
    client = _local_client()
    acct = asyncio.run(client.get_account(str(vb.get_address())))
    tx = vb.register_validator(
        args.memo, Ratio.from_float(args.commission), Money.ziesha(0),
        acct["nonce"] + 1,
    )
    _send_tx(tx)
    return 0


def cmd_wallet_delegate(args):
    from ..core.money import Decimal
    from ..core.transaction import Money
    from ..crypto.ed25519 import PublicKey

    wc = _open_wallet()
    tb = wc.user(0).tx_builder()
    client = _local_client()
    acct = asyncio.run(client.get_account(str(tb.get_address())))
    tx = tb.delegate(
        args.memo, PublicKey.parse(args.to),
        Decimal.parse(args.amount).to_amount(9), Money.ziesha(0),
        acct["nonce"] + 1,
    )
    _send_tx(tx)
    return 0


def cmd_wallet_new_token(args):
    from ..core.money import Decimal
    from ..core.transaction import Money

    wc = _open_wallet()
    tb = wc.user(0).tx_builder()
    client = _local_client()
    acct = asyncio.run(client.get_account(str(tb.get_address())))
    td, token_id = tb.create_token(
        args.memo, args.name, args.symbol,
        Decimal.parse(args.supply).to_amount(args.decimals), args.decimals,
        None, Money.ziesha(0), acct["nonce"] + 1,
    )
    wc.user(0).add_token(token_id)
    wc.save(wallet_path())
    print("Token ID:", token_id)
    _send_tx(td)
    return 0


def cmd_wallet_undelegate(args):
    from ..core.money import Decimal
    from ..core.transaction import Money
    from ..crypto.ed25519 import PublicKey

    wc = _open_wallet()
    tb = wc.user(0).tx_builder()
    client = _local_client()
    acct = asyncio.run(client.get_account(str(tb.get_address())))
    tx = tb.undelegate(
        args.memo, PublicKey.parse(args.frm),
        Decimal.parse(args.amount).to_amount(9), Money.ziesha(0),
        acct["nonce"] + 1,
    )
    _send_tx(tx)
    return 0


def cmd_wallet_auto_delegate(args):
    from ..core.money import Ratio
    from ..core.transaction import Money
    from ..crypto.ed25519 import PublicKey

    wc = _open_wallet()
    tb = wc.user(0).tx_builder()
    client = _local_client()
    acct = asyncio.run(client.get_account(str(tb.get_address())))
    tx = tb.auto_delegate(
        args.memo, PublicKey.parse(args.to), Ratio.from_float(args.ratio),
        Money.ziesha(0), acct["nonce"] + 1,
    )
    _send_tx(tx)
    return 0


def cmd_wallet_add_token(args):
    from ..core.transaction import ContractId

    wc = _open_wallet()
    wc.user(0).add_token(ContractId.parse(args.token_id))
    wc.save(wallet_path())
    print("Token added.")
    return 0


def cmd_wallet_reset(args):
    wc = _open_wallet()
    for w in wc.wallets.values():
        w.reset()
    wc.save(wallet_path())
    print("Pending transactions cleared.")
    return 0


def cmd_wallet_resend_pending(args):
    wc = _open_wallet()
    client = _local_client()
    count = 0
    for w in wc.wallets.values():
        for txs in w.txs.values():
            for tx in txs:
                asyncio.run(client.transact(tx))
                count += 1
    print(f"Resent {count} pending transactions.")
    return 0


def cmd_chain_rollback(args):
    chain = _chain()
    chain.rollback()
    print("Rolled back to height", chain.get_height())
    return 0


def cmd_chain_db_query(args):
    chain = _chain()
    for k, v in chain.db.pairs(args.prefix):
        print(k, "=", v.hex()[:64])
    return 0


def cmd_chain_health_check(args):
    chain = _chain()
    print("Height:     ", chain.get_height())
    print("Power:      ", chain.get_power())
    print("DB checksum:", chain.db_checksum())
    print("Currency:   ", chain.currency_in_circulation())
    return 0


# ---------------------------------------------------------------- parser


def build_parser():
    p = argparse.ArgumentParser(prog="bazuka-tpu", description="TPU-native Ziesha node")
    sub = p.add_subparsers(dest="cmd", required=True)

    init = sub.add_parser("init", help="Initialize config + wallet")
    init.add_argument("--force", action="store_true")
    init.add_argument("--mnemonic")
    init.add_argument("--external")
    init.add_argument("--port", type=int, default=DEFAULT_PORT)
    init.add_argument("--bootstrap", nargs="*")
    init.set_defaults(fn=cmd_init)

    node = sub.add_parser("node", help="Node commands").add_subparsers(
        dest="sub", required=True
    )
    node.add_parser("start").set_defaults(fn=cmd_node_start)
    node.add_parser("status").set_defaults(fn=cmd_node_status)
    amw = node.add_parser("add-mpn-worker")
    amw.add_argument("address")
    amw.set_defaults(fn=cmd_node_add_mpn_worker)

    wallet = sub.add_parser("wallet", help="Wallet commands").add_subparsers(
        dest="sub", required=True
    )
    wallet.add_parser("info").set_defaults(fn=cmd_wallet_info)
    send = wallet.add_parser("send")
    send.add_argument("--to", required=True)
    send.add_argument("--amount", required=True)
    send.add_argument("--fee", default="0")
    send.add_argument("--token")
    send.add_argument("--memo", default="")
    send.set_defaults(fn=cmd_wallet_send)
    reg = wallet.add_parser("register-validator")
    reg.add_argument("--commission", type=float, default=0.05)
    reg.add_argument("--memo", default="")
    reg.set_defaults(fn=cmd_wallet_register_validator)
    dele = wallet.add_parser("delegate")
    dele.add_argument("--to", required=True)
    dele.add_argument("--amount", required=True)
    dele.add_argument("--memo", default="")
    dele.set_defaults(fn=cmd_wallet_delegate)
    ntok = wallet.add_parser("new-token")
    ntok.add_argument("--name", required=True)
    ntok.add_argument("--symbol", required=True)
    ntok.add_argument("--supply", required=True)
    ntok.add_argument("--decimals", type=int, default=9)
    ntok.add_argument("--memo", default="")
    ntok.set_defaults(fn=cmd_wallet_new_token)
    undele = wallet.add_parser("undelegate")
    undele.add_argument("--from", dest="frm", required=True)
    undele.add_argument("--amount", required=True)
    undele.add_argument("--memo", default="")
    undele.set_defaults(fn=cmd_wallet_undelegate)
    adel = wallet.add_parser("auto-delegate")
    adel.add_argument("--to", required=True)
    adel.add_argument("--ratio", type=float, required=True)
    adel.add_argument("--memo", default="")
    adel.set_defaults(fn=cmd_wallet_auto_delegate)
    atok = wallet.add_parser("add-token")
    atok.add_argument("token_id")
    atok.set_defaults(fn=cmd_wallet_add_token)
    wallet.add_parser("reset").set_defaults(fn=cmd_wallet_reset)
    wallet.add_parser("resend-pending").set_defaults(fn=cmd_wallet_resend_pending)

    chain = sub.add_parser("chain", help="Chain commands").add_subparsers(
        dest="sub", required=True
    )
    chain.add_parser("rollback").set_defaults(fn=cmd_chain_rollback)
    dbq = chain.add_parser("db-query")
    dbq.add_argument("prefix")
    dbq.set_defaults(fn=cmd_chain_db_query)
    chain.add_parser("health-check").set_defaults(fn=cmd_chain_health_check)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
