"""setup.keygen_s: seconds of set-up in key generation, the sum of the
process's `generate_parameters` calls as the program records them."""

from harness.calls import total


def read(layer):
    return total("generate_parameters", lambda c: c["seconds"])
