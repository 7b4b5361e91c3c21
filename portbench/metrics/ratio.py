"""Compressed bytes over input bytes, summed over the window's inputs."""


def read(rec):
    return sum(rec["out_sizes"]) / sum(rec["sizes"])
