"""Explorer JSON mirrors of chain types (reference: src/client/explorer.rs).

Every chain object has a human-readable JSON view used by the explorer
endpoints; blobs/hashes are hex, addresses are display strings.
A copy of `bazuka_tpu/node/explorer.py`.
"""

from __future__ import annotations

from ..core.blocks import Block
from ..core.header import Header
from ..core.transaction import (
    ContractUpdate,
    Transaction,
    TransactionData,
)


def money_to_json(m):
    return {"token_id": str(m.token_id), "amount": m.amount}


# ------------------------------------------------------------- zk views


def state_model_to_json(model):
    """Recursive model mirror (reference ExplorerStateModel embeds the
    full ZkStateModel)."""
    from ..zk.state import ListModel, Scalar, Struct

    if isinstance(model, Scalar):
        return "Scalar"
    if isinstance(model, Struct):
        return {"Struct": [state_model_to_json(f) for f in model.field_types]}
    if isinstance(model, ListModel):
        return {
            "List": {
                "log4_size": model.log4_size,
                "item_type": state_model_to_json(model.item_type),
            }
        }
    return repr(model)


def compressed_state_to_json(s):
    return {"state_hash": hex(s.state_hash), "state_size": s.state_size}


def vk_to_json(vk):
    """VK summary: kind + a commitment to the key material (the full
    wire form is hundreds of field elements — the explorer shows the
    digest, `GET /bincode` endpoints carry the real bytes)."""
    import hashlib

    from ..utils import ser

    w = ser.Writer()
    vk.write_to(w)
    return {
        "kind": vk.kind,
        "digest": hashlib.sha3_256(w.getvalue()).hexdigest()[:32],
        "n_inputs": len(vk.vk.ic) - 1 if vk.kind == "groth16" else None,
    }


def multi_vk_to_json(f):
    return {
        "verifier_key": vk_to_json(f.verifier_key),
        "log4_payment_capacity": f.log4_payment_capacity,
    }


def single_vk_to_json(f):
    return {"verifier_key": vk_to_json(f.verifier_key)}


def token_to_json(t):
    return {
        "name": t.name,
        "symbol": t.symbol,
        "supply": t.supply,
        "decimals": t.decimals,
        "minter": t.minter,
    }


def contract_to_json(c):
    """Full contract detail (reference ExplorerContract)."""
    out = {
        "initial_state": compressed_state_to_json(c.initial_state),
        "state_model": state_model_to_json(c.state_model),
        "deposit_functions": [multi_vk_to_json(f) for f in c.deposit_functions],
        "withdraw_functions": [multi_vk_to_json(f) for f in c.withdraw_functions],
        "functions": [single_vk_to_json(f) for f in c.functions],
    }
    if c.token is not None:
        out["token"] = {
            "token": token_to_json(c.token.token),
            "mint_functions": [
                single_vk_to_json(f) for f in c.token.mint_functions
            ],
        }
    return out


def proof_to_json(p):
    out = {"kind": p.kind}
    if p.kind == "groth16":
        out["a"] = {"x": hex(p.proof.a.x), "infinity": p.proof.a.infinity}
        out["c"] = {"x": hex(p.proof.c.x), "infinity": p.proof.c.infinity}
    else:
        out["ok"] = p.ok
    return out


def data_pairs_to_json(pairs):
    """{locator: value} with display locators (reference
    ExplorerDataPairs: `loc` string -> u64/scalar)."""
    from ..zk.state import loc_str

    return {loc_str(k): hex(v) for k, v in sorted(pairs.items())}


def delta_pairs_to_json(pairs):
    from ..zk.state import loc_str

    return {
        loc_str(k): (hex(v) if v is not None else None)
        for k, v in sorted(pairs.items())
    }


# ------------------------------------------------------------- L2 views


def mpn_tx_to_json(tx):
    return {
        "nonce": tx.nonce,
        "src_pub_key": str(tx.src_pub_key),
        "dst_pub_key": str(tx.dst_pub_key),
        "amount": money_to_json(tx.amount),
        "fee": money_to_json(tx.fee),
        "sig": hex(tx.sig.s) if tx.sig else "",
    }


def contract_deposit_to_json(d):
    return {
        "memo": d.memo,
        "contract_id": str(d.contract_id),
        "deposit_circuit_id": d.deposit_circuit_id,
        "calldata": hex(d.calldata),
        "src": str(d.src),
        "amount": money_to_json(d.amount),
        "fee": money_to_json(d.fee),
        "nonce": d.nonce,
    }


def contract_withdraw_to_json(w):
    return {
        "memo": w.memo,
        "contract_id": str(w.contract_id),
        "withdraw_circuit_id": w.withdraw_circuit_id,
        "calldata": hex(w.calldata),
        "dst": str(w.dst),
        "amount": money_to_json(w.amount),
        "fee": money_to_json(w.fee),
    }


def mpn_deposit_to_json(d):
    return {
        "mpn_address": str(d.mpn_address),
        "payment": contract_deposit_to_json(d.payment),
    }


def mpn_withdraw_to_json(w):
    return {
        "mpn_address": str(w.mpn_address),
        "mpn_withdraw_nonce": w.mpn_withdraw_nonce,
        "mpn_sig": hex(w.mpn_sig.s),
        "payment": contract_withdraw_to_json(w.payment),
    }


def header_to_json(h: Header):
    return {
        "parent_hash": h.parent_hash.hex(),
        "number": h.number,
        "block_root": h.block_root.hex(),
        "proof_of_stake": {
            "timestamp": h.proof_of_stake.timestamp,
            "validator": str(h.proof_of_stake.validator),
            "attempt": h.proof_of_stake.proof.attempt
            if h.proof_of_stake.proof
            else None,
        },
        "hash": h.hash().hex(),
    }


def general_tx_to_json(gt):
    """Mempool view of a GeneralTransaction (reference
    ExplorerGeneralTransaction: the 4 mempool kinds, full detail)."""
    t = gt.inner
    if gt.kind == "tx_delta":
        return {"TransactionAndDelta": tx_to_json(t.tx)}
    if gt.kind == "mpn_deposit":
        return {"MpnDeposit": mpn_deposit_to_json(t)}
    if gt.kind == "mpn_withdraw":
        return {"MpnWithdraw": mpn_withdraw_to_json(t)}
    return {"MpnTransaction": mpn_tx_to_json(t)}


def contract_update_to_json(u: ContractUpdate):
    out = {
        "circuit_id": u.circuit_id,
        "kind": u.data.kind,
        "next_state": compressed_state_to_json(u.next_state),
        "prover": str(u.prover),
        "reward": u.reward,
        "proof": proof_to_json(u.proof),
    }
    if u.data.kind == "deposit":
        out["deposits"] = [
            {
                "src": str(d.src), "amount": money_to_json(d.amount),
                "fee": money_to_json(d.fee), "nonce": d.nonce,
                "calldata": hex(d.calldata),
            }
            for d in u.data.deposits
        ]
    elif u.data.kind == "withdraw":
        out["withdraws"] = [
            {
                "dst": str(w.dst), "amount": money_to_json(w.amount),
                "fee": money_to_json(w.fee), "calldata": hex(w.calldata),
            }
            for w in u.data.withdraws
        ]
    elif u.data.kind == "function_call":
        out["fee"] = money_to_json(u.data.fee)
    elif u.data.kind == "mint":
        out["amount"] = u.data.amount
    return out


def tx_data_to_json(d: TransactionData):
    if d.kind == "regular_send":
        return {
            "RegularSend": [
                {"dst": str(e.dst), "amount": money_to_json(e.amount)}
                for e in d.entries
            ]
        }
    if d.kind == "delegate":
        return {"Delegate": {"to": str(d.to), "amount": d.amount}}
    if d.kind == "undelegate":
        return {"Undelegate": {"from": str(d.frm), "amount": d.amount}}
    if d.kind == "auto_delegate":
        return {"AutoDelegate": {"to": str(d.to), "ratio": d.ratio.value}}
    if d.kind == "update_staker":
        return {
            "UpdateStaker": {
                "vrf_pub_key": d.vrf_pub_key,
                "commission": d.commission.value,
            }
        }
    if d.kind == "create_contract":
        return {
            "CreateContract": {
                "contract": contract_to_json(d.contract),
                "state": data_pairs_to_json(d.state)
                if d.state is not None
                else None,
                "money": money_to_json(d.money),
            }
        }
    if d.kind == "update_contract":
        return {
            "UpdateContract": {
                "contract_id": str(d.contract_id),
                "updates": [contract_update_to_json(u) for u in d.updates],
                "delta": delta_pairs_to_json(d.delta)
                if d.delta is not None
                else None,
            }
        }
    return {d.kind: {}}


def tx_to_json(tx: Transaction):
    return {
        "hash": tx.hash().hex(),
        "src": str(tx.src) if tx.src else None,  # None = treasury
        "nonce": tx.nonce,
        "fee": money_to_json(tx.fee),
        "memo": tx.memo,
        "data": tx_data_to_json(tx.data),
    }


def block_to_json(b: Block):
    return {
        "header": header_to_json(b.header),
        "body": [tx_to_json(tx) for tx in b.body],
    }
