"""Shared arithmetic of the readers of the program's own spans and
counters (the record's ``program``, ``portbench/spans.py``): None where the
program has none."""


def idle_share(rec, layer):
    """Device-idle time while the innermost program span belongs to
    `layer`, over the traced window, in %."""
    p, tr = rec.get("program"), rec.get("trace")
    if not p or "idle_by_layer" not in p or not tr or not tr["window_s"]:
        return None
    return 100.0 * p["idle_by_layer"].get(layer, 0.0) / tr["window_s"]


def self_share(rec, span):
    """`span`'s own time over its wall time, in %."""
    p = rec.get("program")
    if not p or not p[span + "_wall"]:
        return None
    return 100.0 * p[span + "_self"] / p[span + "_wall"]
