"""ntt.table_builds: NTT twiddle and coset tables built per proof (the
program's counter `ntt.table_build`: cache misses and the uncached
rebuilds above the cache's size alike), the median over the process's
proofs."""

from harness.calls import per_proof


def read(layer):
    return per_proof(lambda c: c["counts"].get("ntt.table_build", 0))
