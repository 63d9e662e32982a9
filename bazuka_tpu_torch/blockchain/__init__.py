"""Blockchain engine (reference: src/blockchain/): a copy of
`bazuka_tpu/blockchain/` without the mempool.

  * `KvStoreChain` — the chain over any KvStore: apply/rollback blocks,
    PoS validator election, staking bookkeeping, contract state
  * `BlockchainConfig` — chain parameters + genesis
"""

from .chain import KvStoreChain
from .config import BlockchainConfig
from .error import BlockchainError
