"""Input bytes (10^6) encoded in the window over the window's wall time,
whole inputs only (files: the window ends with the file in progress;
objects: with the pass in progress)."""


def read(rec):
    return sum(rec["sizes"]) / 1e6 / rec["window_s"]
