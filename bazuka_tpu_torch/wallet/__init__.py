"""Wallet: the MPN part of `bazuka_tpu/wallet/`."""
