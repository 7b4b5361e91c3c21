"""The host syncs of one batch on the card: where torch's sync debug mode
(``torch.cuda.set_sync_debug_mode("warn")``) sees the host wait on the
device, against the program's own count of them (``trace.host_syncs``).

    python -m orz_tpu_torch.tools.sync_sites [--level 1 2] [--segment BYTES]

Each level encodes one warm-up batch, then one batch of 4 segments of
``--segment`` bytes (default 8 MiB, the production shape) from
``tools/parity_data.py``, and prints each site (file:line, count), the
``sync.*`` spans, and the two totals.  Exits 1 where they differ, 2
without CUDA.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import traceback
import warnings

import torch

from orz_tpu_torch import trace
from orz_tpu_torch.device.batch import encode_segments_batch

# how torch's sync debug mode's warning at each sync begins (its other
# messages, such as the first call's note that the mode is a prototype,
# are not syncs)
SYNC_WARNING = "called a synchronizing CUDA operation"
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)


def _site(stack, filename: str, lineno: int) -> str:
    """The innermost line of the package (this tool aside) on `stack`,
    with the warning's own line where that lies elsewhere."""
    here = os.path.abspath(__file__)
    own = f"{os.path.relpath(filename, _ROOT)}:{lineno}"
    for f in reversed(stack):
        path = os.path.abspath(f.filename)
        if path.startswith(_PKG + os.sep) and path != here:
            site = f"{os.path.relpath(path, _ROOT)}:{f.lineno}"
            return site if site == own else f"{site} ({own})"
    return f"outside the package ({own})"


def batch_syncs(segs: list[bytes], level: int, device="cuda"):
    """(syncs the debug mode reports, syncs the program counts, {site:
    count}, [sync span names]) of one ``encode_segments_batch`` call."""
    torch.cuda.synchronize()
    before = trace.host_syncs
    sites: collections.Counter = collections.Counter()

    def seen(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            sites[_site(traceback.extract_stack()[:-1], filename, lineno)] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        trace.start()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            encode_segments_batch(segs, level, device=device)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            spans = trace.stop()
    names = [s["name"] for s in sorted(spans, key=lambda s: s["start"])
             if s["name"].startswith("sync.")]
    return sum(sites.values()), trace.host_syncs - before, dict(sites), names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--level", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--segment", type=int, default=1 << 23)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sync_sites: no CUDA device", file=sys.stderr)
        return 2
    from orz_tpu_torch.tools.parity_data import make_parity_data

    data = make_parity_data(13, 4 * a.segment)
    segs = [data[i * a.segment:(i + 1) * a.segment] for i in range(4)]
    rc = 0
    for level in a.level:
        encode_segments_batch(segs, level, device="cuda")
        seen, counted, sites, names = batch_syncs(segs, level)
        for site, n in sorted(sites.items()):
            print(f"l{level} site {site} {n}")
        print(f"l{level} spans {' '.join(names)}")
        print(f"l{level} sync_debug_mode {seen} host_syncs {counted}")
        rc |= seen != counted
    return rc


if __name__ == "__main__":
    sys.exit(main())
