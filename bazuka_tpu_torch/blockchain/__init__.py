"""Blockchain engine (reference: src/blockchain/).

  * `KvStoreChain` — the chain over any KvStore: apply/rollback blocks,
    PoS validator election, staking bookkeeping, contract state
  * `BlockchainConfig` — chain parameters + genesis
  * `Mempool` — nonce-chained per-sender queues
A copy of `bazuka_tpu/blockchain/__init__.py`.
"""

from .chain import KvStoreChain
from .config import BlockchainConfig
from .error import BlockchainError
from .mempool import Mempool
