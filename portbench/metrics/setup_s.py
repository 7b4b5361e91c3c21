"""Seconds from the start of the process to the first timed input: torch's
import, CUDA's set-up, loading or building the kernel library, the data,
the warm-up."""


def read(rec):
    return rec["setup_s"]
