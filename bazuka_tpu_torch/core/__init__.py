"""Chain datatypes the MPN proving path needs: the part of
`bazuka_tpu/core/` that the witness generators and circuits reach
(the chain hash, tokens, MPN addresses and the MPN transactions)."""
