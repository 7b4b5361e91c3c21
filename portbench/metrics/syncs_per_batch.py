"""The program's host syncs (``orz_tpu_torch.trace.host_syncs``) over its
batch calls, in the profiled stretch."""


def read(rec):
    p = rec.get("program")
    if not p or not p["batches"]:
        return None
    return p["stretch_counters"]["host_syncs"] / p["batches"]
