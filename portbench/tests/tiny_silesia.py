"""A tiny Silesia mix for the tests on the CPU: every kind of the corpus's
files at a few KiB, and a copy of the benchmark with the cell
tiny-silesia-l2 added as new files (``tiny.make_root`` and more)."""

from __future__ import annotations

import json
import os

import tiny

# [name, bytes, kind]: one to three 8 KiB segments a file; sao a whole
# number of 28-byte records; the tars whole 512-byte blocks
TINY_SILESIA = dict(files=[
    ["dickens", 3000, "text"], ["mozilla", 20480, "tar-exe"], ["mr", 9000, "mr"],
    ["nci", 9000, "sdf"], ["ooffice", 5000, "x86"], ["osdb", 3500, "rows"],
    ["reymont", 4000, "pdf-latin2"], ["samba", 10240, "tar-c"], ["sao", 2828, "stars"],
    ["webster", 4000, "dict-html"], ["xml", 10240, "tar-xml"], ["x-ray", 4112, "x-ray"],
], vocabulary=600)


# the tiny cell's mix: a text file, a tar over three segments, an image
TINY_CELL = dict(files=[TINY_SILESIA["files"][i] for i in (0, 1, 11)],
                 vocabulary=TINY_SILESIA["vocabulary"])


def make_root(tmp: str) -> str:
    """``tiny.make_root(tmp)`` plus the cell tiny-silesia-l2 (config tiny-l2,
    mix tiny-silesia of TINY_CELL's files, one pass profiled), which
    reports what l2-silesia reports."""
    root = tiny.make_root(tmp)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "traffic", "silesia-files.json")) as f:
        t = json.load(f)
    t["params"] = TINY_CELL
    t["check"] = {"prefix_bytes": 1024}
    t["trace_inputs"] = len(TINY_CELL["files"])
    tiny.write(os.path.join(pb, "traffic", "tiny-silesia.json"), t)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny-silesia-l2", "config": "tiny-l2",
                               "traffic": "tiny-silesia", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "l2-silesia" in m.get("workloads", ()):
            m["workloads"].append("tiny-silesia-l2")
    tiny.write(os.path.join(root, "BENCHMARK.json"), bench)
    return root
