"""BLS12-381 field constants (Python ints).

The part of `bazuka_tpu/fields/host.py` the port needs, copied: the port
imports nothing of the JAX package.  Mirrors the reference's `ff`-derived
fields (reference: src/zk/mod.rs:202-206 for Fr, src/zk/groth16/mod.rs:19-20
for Fp).
"""

from __future__ import annotations

# BLS12-381 scalar field modulus (reference: src/zk/mod.rs:196-199)
FR_MODULUS = int(
    "52435875175126190479447740508185965837690552500527637822603658699938581184513"
)

# BLS12-381 base field modulus (381 bits)
FP_MODULUS = int(
    "0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153"
    "ffffb9feffffffffaaab",
    16,
)

# Multiplicative generator of Fr (reference: src/zk/mod.rs:204 PrimeFieldGenerator=7)
FR_GENERATOR = 7
# Fr has 2-adicity 32: FR_MODULUS - 1 = 2^32 * t
FR_TWO_ADICITY = 32
