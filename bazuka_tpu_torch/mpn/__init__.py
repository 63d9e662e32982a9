"""MPN (Main Payment Network) — the Groth16 zk-rollup engine: a copy of
`bazuka_tpu/mpn/`.

Components (reference: src/mpn/):
  * account.py  — MpnAccount codec over the sparse state tree
  * config.py   — MpnConfig + the account-tree state model
  * deposit.py / withdraw.py / update.py — witness generators: replay
    candidate txs against forked state, emit per-tx Transitions with all
    Merkle proofs + ZkPublicInputs
  * workpool.py — validator-side distributed-proving coordinator
  * circuits.py — the three Groth16 circuits (over groth16/gadgets.py)
"""

from .account import MpnAccount
from .config import MpnConfig, ZkPublicInputs
