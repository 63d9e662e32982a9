"""Chain configuration (reference: src/blockchain/config.rs).
A copy of `bazuka_tpu/blockchain/config.py`."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Set

from ..core.blocks import Block
from ..core.money import Ratio
from ..core.transaction import ContractId
from ..mpn.config import MpnConfig


@dataclass
class BlockchainConfig:
    genesis: Block
    mpn_config: MpnConfig
    reward_ratio: int = 100_000
    max_block_size: int = 1_000_000
    ziesha_token_id: ContractId = ContractId.ZIESHA
    testnet_height_limit: Optional[int] = None
    max_memo_length: int = 64
    slot_duration: int = 90
    slot_per_epoch: int = 10
    chain_start_timestamp: int = 0
    check_validator: bool = True
    max_validator_commission: Ratio = Ratio(26)  # ~10%
    teleport_log4_tree_size: int = 10
    teleport_contract_id: ContractId = ContractId(2)
    limited_miners: Optional[Set] = None
