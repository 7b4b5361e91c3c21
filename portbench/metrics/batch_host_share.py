"""Batch wall time minus the sum of its synchronised stages, over the
batch wall time, in %: padding, copies to the device, host syncs and
stream assembly."""


def read(rec):
    bs = [b for b in rec.get("batches", ()) if b["stages"]]
    if not bs:
        return None
    wall = sum(b["wall"] for b in bs)
    return 100.0 * (wall - sum(sum(b["stages"].values()) for b in bs)) / wall
