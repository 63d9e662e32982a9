"""Blockchain: the prover commitment of `bazuka_tpu/blockchain/chain.py`."""
