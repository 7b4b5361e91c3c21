"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start), in GiB."""


def read(rec):
    if rec["device"]["platform"] != "gpu":
        return None
    return rec["device"]["memory_peak_bytes"] / 2 ** 30
