"""setup.keygen_host_s: seconds of set-up in key generation's host loops,
the `lagrange_host` and `h_scalars_host` stages of the process's
`generate_parameters` calls, summed."""

from harness.calls import spans_s, total


def read(layer):
    return total("generate_parameters",
                 lambda c: spans_s(c, "lagrange_host", "h_scalars_host"))
