"""Padding copies over all batch slots, in %: the program's
``device.pcontainer.pad_slots`` over ``batch_slots``.

The harness's window resets only its own two counters, so this reads the
program's module counters as they stand: from process start, the warm-up's
one encode per shape bucket included (a batch of one segment and three
copies each).  None where the program has no such counters."""

import sys


def read(rec):
    mod = sys.modules.get("orz_tpu_torch.device.pcontainer")
    slots = getattr(mod, "batch_slots", None)
    pads = getattr(mod, "pad_slots", None)
    if not slots or pads is None:
        return None
    return 100.0 * pads / slots
