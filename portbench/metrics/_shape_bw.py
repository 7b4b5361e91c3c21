"""Shared arithmetic of the <kernel>_shape_GBps readers: the bytes a
kernel's launches would move if every input were read once and every
output written once, counted from their shapes, over their device time,
in GB/s (10^9 bytes).

It is no share of a roofline: a kernel may read less than its shapes
hold (K2 reads a slot's dwords only for the pairs it compares, up to the
first that differs), so a sound kernel could read above the card's
memory bandwidth by this count.  The data-dependent bound needs the
kernels' inputs handed over from inside the program."""


def gbps(rec, calls: str, kernel: str, bytes_of):
    tr = rec.get("trace")
    launches = rec.get("kernel_calls", {}).get(calls)
    if not tr or not launches:
        return None
    t = sum(v for n, v in tr["device_ops_short"].items()
            if n.split("::")[-1].split(" ")[-1] == kernel)
    if t <= 0:
        return None
    return sum(bytes_of(b, n) for b, n in launches) / t / 1e9
