"""1 - (union of the device's busy intervals) / (the traced window), in %,
from torch.profiler over the profiled inputs."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
