"""Segments of the batches sent whole to the staged encoder (an empty
segment or symrank skew): the program's ``device.batch.staged_segments``.

The harness's window resets only its own two counters, so this reads the
program's module counter as it stands: from process start, the warm-up's
encodes included.  None where the program has no such counter."""

import sys


def read(rec):
    mod = sys.modules.get("orz_tpu_torch.device.batch")
    n = getattr(mod, "staged_segments", None)
    return None if n is None else int(n)
