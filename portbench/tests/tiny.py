"""A copy of the benchmark under a temporary root with tiny cells added as
new files only, for the tests on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import sys

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)
for _d in (REPO, PB, os.path.join(PB, "ref"), os.path.join(PB, "gen")):
    if _d not in sys.path:
        sys.path.insert(0, _d)

TINY_ENWIK8 = dict(file_bytes=20000, pool_bytes=65536, slice_min=1000,
                   slice_max=6000, vocabulary=2000, pages=16, templates=16,
                   refs=16, headings=16)
TINY_CANTERBURY = dict(objects=[["a.lsp", 600, "lisp"], ["b.1", 900, "man"],
                                ["c.c", 1500, "c"], ["d.html", 2500, "html"],
                                ["e", 3500, "exe"], ["f.txt", 3000, "text"],
                                ["g", 4000, "fax"], ["h.xls", 5000, "xls"]],
                       vocabulary=500)
# l1, and l2 on a short schedule that reaches every l2 stage
TINY_CONFIGS = {
    "tiny-l1": {"encode": {"level": 1, "segment_size": 8192, "batch": 2}, "env": {}},
    "tiny-l2": {"encode": {"level": 2, "segment_size": 8192, "batch": 2},
                "env": {"OTZ2_SCHEDULE": "96x1,384x2"}},
}


def write(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(tmp: str) -> str:
    """`tmp` with BENCHMARK.json and portbench/, plus the tiny cells
    tiny-files-l1, tiny-files-l2 and tiny-objects-l1 as new files."""
    shutil.copytree(PB, os.path.join(tmp, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, conf in TINY_CONFIGS.items():
        write(os.path.join(tmp, "portbench", "configs", name + ".json"), conf)
        bench["configs"].append({"name": name, "source": "test", "reduced": [],
                                 "file": f"portbench/configs/{name}.json", "why": "test"})
    for mix, base, params in (("tiny-files", "enwik8-files", TINY_ENWIK8),
                              ("tiny-objects", "canterbury-objects", TINY_CANTERBURY)):
        with open(os.path.join(PB, "traffic", base + ".json")) as f:
            t = json.load(f)
        t["params"] = params
        t["check"] = {"prefix_bytes": 1024}
        t["trace_inputs"] = 2
        write(os.path.join(tmp, "portbench", "traffic", mix + ".json"), t)
    cells = [("tiny-files-l1", "tiny-l1", "tiny-files"),
             ("tiny-files-l2", "tiny-l2", "tiny-files"),
             ("tiny-objects-l1", "tiny-l1", "tiny-objects")]
    for name, conf, mix in cells:
        bench["workloads"].append({"name": name, "config": conf, "traffic": mix,
                                   "chips": 1, "why": "test"})
    # a tiny cell reports what the real cells of its mix and level report
    real = {w["name"]: (w["traffic"], w["config"][-2:]) for w in bench["workloads"]}
    like = {"tiny-files": "enwik8-files", "tiny-objects": "canterbury-objects"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            have = {real[w] for w in m["workloads"] if w in real}
            m["workloads"] += [c[0] for c in cells if (like[c[2]], c[1][-2:]) in have]
    write(os.path.join(tmp, "BENCHMARK.json"), bench)
    return tmp
