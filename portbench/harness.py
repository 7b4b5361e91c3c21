"""The benchmark of ``orz_tpu_torch``: one run of one cell.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics.  Everything that belongs to one configuration, traffic mix or
metric sits in a file of its own that the harness finds by name:

- ``portbench/configs/<file>.json``: the configuration as it is run (the
  ``file`` named in ``BENCHMARK.json``); ``encode`` holds the arguments of
  ``torch_encode_bytes``, ``env`` any knob it sets;
- ``portbench/traffic/<mix>.json``: the mix's parameters, its generator's
  name, the output check's prefix and how many inputs a traced run
  profiles;
- ``portbench/gen/<generator>.py``: ``make(seed, params)`` returns the
  inputs (``item(i)``, ``pass_len``, ``sizes()``, ``warmup(n)``,
  ``digest()``);
- ``portbench/metrics/<metric>.py``: ``read(rec)`` returns the metric's
  value from the run's record, or None where it finds nothing to read.

A run clears the program's ``OTZ*``/``ORZ*`` knobs, builds its data from
the seed, warms up each shape bucket its inputs use, encodes whole inputs
in a closed loop until ``seconds`` have passed and the current pass is
complete, checks what the window produced against the plain reference
decoder (``portbench/ref/``), and prints one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _d in (os.path.join(HERE, "gen"), os.path.join(HERE, "ref"), HERE):
    if _d not in sys.path:
        sys.path.insert(0, _d)

FORBIDDEN = ("jax", "jaxlib", "flax", "orz_tpu")


class Refused(Exception):
    """A run that cannot be made (no card, unknown cell): exit code 2."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, mix and
    metrics resolved by name under `root`."""

    def __init__(self, name: str, root: str = ROOT):
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.cell = cells[name]
        confs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(os.path.join(root, confs[self.cell["config"]]["file"]))
        here = os.path.join(root, os.path.relpath(HERE, ROOT))
        self.traffic = load_json(os.path.join(here, "traffic", self.cell["traffic"] + ".json"))
        self.gen_path = os.path.join(here, "gen", self.traffic["generator"] + ".py")
        self.metrics_dir = os.path.join(here, "metrics")

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: per-layer ones when traced."""
        ms = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in ms if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        return load_module(os.path.join(self.metrics_dir, metric + ".py"),
                           "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))

    def source(self, seed: int):
        gen = load_module(self.gen_path, "portbench_gen_" + self.traffic["generator"])
        return gen.make(seed, self.traffic["params"])


def clear_knobs(env: dict | None = None) -> None:
    """Drop every ``OTZ*``/``ORZ*`` knob so that the program's defaults
    rule, then set the configuration's own."""
    for k in list(os.environ):
        if k.startswith(("OTZ", "ORZ")):
            del os.environ[k]
    os.environ.update(env or {})


def bucket(n: int) -> int:
    """The program's segment shape bucket: a power of two from 4 KiB."""
    cap = 1 << 12
    while cap < n:
        cap *= 2
    return cap


def warmup_sizes(sizes: list[int], segment: int) -> list[int]:
    """One input size per shape bucket that the inputs' segments use: the
    largest segment of each bucket (a batch pads to its full size with
    copies of its first segment, so one segment makes a bucket's shapes)."""
    segs = []
    for n in sizes:
        full, rest = divmod(n, segment)
        segs += [segment] * min(full, 1) + ([rest] if rest else [])
    best = {}
    for s in segs:
        b = min(bucket(s), bucket(segment))
        best[b] = max(best.get(b, 0), s)
    return [best[b] for b in sorted(best)]


def device_info(torch, device: str) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", root: str = ROOT,
             patch=None, check_workers: int | None = None) -> dict:
    """One run of cell `name`: returns the result's dict.  `patch`, given,
    is called with the container module once the program is loaded (the
    output check's tests break the timed path through it)."""
    cell = Cell(name, root)
    clear_knobs(cell.config.get("env"))
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.cell["chips"]:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell "
                          f"asks for {cell.cell['chips']}")
    from orz_tpu_torch.device import container

    if patch is not None:
        patch(container)
    kw = dict(cell.config["encode"])
    segment = kw.get("segment_size", container.DEFAULT_SEGMENT_SIZE)

    def encode(data: bytes) -> bytes:
        return container.torch_encode_bytes(data, device=device, **kw)

    src = cell.source(seed)
    print(f"portbench: {name} seed {seed} data {src.digest()}", flush=True)
    for n in warmup_sizes(src.sizes(), segment):
        encode(src.warmup(n))
    if device == "cuda":
        torch.cuda.synchronize()
    import tracing

    tr = tracing.Tracer(torch, container, device) if trace else None
    setup_s = time.perf_counter() - t_start

    # the window
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tracing.reset_counters(container)
    sizes, outs, times = [], [], []
    # a traced run profiles its first `limit` inputs, then takes spans over
    # at least one more pass
    limit = cell.traffic.get("trace_inputs", src.pass_len)
    least = limit + src.pass_len if tr else 0
    t0 = time.perf_counter()
    if tr:
        tr.start()
    i = 0
    while True:
        data = src.item(i)
        t1 = time.perf_counter()
        if tr:
            out = tr.input(lambda: encode(data))
        else:
            out = encode(data)
        times.append(time.perf_counter() - t1)
        sizes.append(len(data))
        outs.append(out)
        i += 1
        if tr and i == limit:
            tr.stop()
        if time.perf_counter() - t0 >= seconds and i % src.pass_len == 0 and i >= least:
            break
    window_s = time.perf_counter() - t0
    if tr:
        tr.stop()
    rec = {
        "window_s": window_s, "setup_s": setup_s, "sizes": sizes,
        "out_sizes": [len(o) for o in outs], "times": times,
        "device": device_info(torch, device),
        "counters": tracing.read_counters(container),
    }
    if tr:
        rec.update(tr.record())
        tr.close()
    del tr
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    metrics = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules loaded that the run must not load: {bad}")

    import check

    t_check = time.perf_counter()
    numbers, failed = check.check(src, outs, sizes, seed, cell.traffic["check"], segment,
                          workers=check_workers)
    print(f"portbench: setup {setup_s:.3f} s, window {window_s:.3f} s, "
          f"{len(outs)} inputs, check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr, flush=True)
    result = {
        "correct": all(v <= check.LIMITS[k] for k, v in numbers.items()),
        "attempted": len(outs), "failed": failed,
        "metrics": metrics, "device": rec["device"],
    }
    if trace and "breakdown" in rec:
        result["device"]["busy_s"] = rec["busy_s"]
        result["device"]["window_s"] = rec["trace_window_s"]
        result["breakdown"] = rec["breakdown"]
    result["check"] = {k: {"value": v, "limit": check.LIMITS[k]}
                       for k, v in numbers.items()}
    return result


def main(argv: list[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t_start)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for k, v in res["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0
