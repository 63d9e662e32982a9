"""setup.synthesis_s: seconds of set-up in circuit synthesis, the sum of
the process's `synthesize_circuit` calls as the program records them."""

from harness.calls import total


def read(layer):
    return total("synthesize_circuit", lambda c: c["seconds"])
