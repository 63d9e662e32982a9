"""bazuka_tpu_torch — the Groth16 prover of `bazuka_tpu`, ported to PyTorch
and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package imports `torch` and `numpy`, never `jax`, and nothing of
`bazuka_tpu`: host-only modules it needs are kept here as copies.  Every
entry point takes `device=` and defaults to "cuda"; on a CPU tensor each
kernel wrapper runs its plain PyTorch version instead (the tests)."""
