"""device.peak_gib.prove: `torch.cuda.max_memory_allocated()` over the
window's proofs (the peak reset after set-up), in GiB."""


def read(layer):
    peak = layer.get("window_peak_bytes")
    return peak / 2 ** 30 if peak else None
