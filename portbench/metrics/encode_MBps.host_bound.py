"""``encode_MBps`` in the host-bound cells (l1-enwik8, the object cells),
whose rate moves with the shared host's speed, 3-11% from run to run:
input bytes (10^6) encoded in the window over its wall time."""


def read(rec):
    return sum(rec["sizes"]) / 1e6 / rec["window_s"]
