"""Blockchain error taxonomy (reference: src/blockchain/error.rs).
A copy of `bazuka_tpu/blockchain/error.py`."""


class BlockchainError(Exception):
    pass


class ExtendFromGenesis(BlockchainError):
    pass


class ExtendFromFuture(BlockchainError):
    pass


class BlockchainEmpty(BlockchainError):
    pass


class InvalidMerkleRoot(BlockchainError):
    pass


class InvalidParentHash(BlockchainError):
    pass


class InvalidBlockNumber(BlockchainError):
    pass


class InvalidEpochSlot(BlockchainError):
    pass


class SignatureError(BlockchainError):
    pass


class BalanceInsufficient(BlockchainError):
    pass


class ContractBalanceInsufficient(BlockchainError):
    pass


class InvalidTransactionNonce(BlockchainError):
    pass


class UnelectedValidator(BlockchainError):
    pass


class ValidatorProofNotGiven(BlockchainError):
    pass


class ValidatorNotRegistered(BlockchainError):
    pass


class IllegalTreasuryAccess(BlockchainError):
    pass


class OnlyZieshaFeesAccepted(BlockchainError):
    pass


class MemoTooLong(BlockchainError):
    pass


class InvalidStateModel(BlockchainError):
    pass


class TokenBadNameSymbol(BlockchainError):
    pass


class StateNotGiven(BlockchainError):
    pass


class InvalidState(BlockchainError):
    pass


class IncorrectZkProof(BlockchainError):
    pass


class ContractFunctionNotFound(BlockchainError):
    pass


class DepositWithdrawPassedToWrongFunction(BlockchainError):
    pass


class InvalidContractPaymentSignature(BlockchainError):
    pass


class InsufficientMpnUpdates(BlockchainError):
    pass


class BlockTooBig(BlockchainError):
    pass


class NoBlocksToRollback(BlockchainError):
    pass


class Inconsistency(BlockchainError):
    pass


class RandomnessChangeNotPermitted(BlockchainError):
    pass


class TestnetHeightLimitReached(BlockchainError):
    pass


class TokenSupplyOverflow(BlockchainError):
    pass
