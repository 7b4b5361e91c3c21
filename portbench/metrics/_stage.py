"""Shared arithmetic of the stage_share.* readers."""


def share(rec, names):
    bs = [b for b in rec.get("batches", ()) if b["stages"]]
    if not bs or not any(n in b["stages"] for b in bs for n in names):
        return None
    wall = sum(b["wall"] for b in bs)
    return 100.0 * sum(b["stages"].get(n, 0.0) for b in bs for n in names) / wall
