"""The program's own spans and counters in a traced run, laid over the
device's timeline.

``orz_tpu_torch.trace`` stamps its spans with the clock of
``torch.profiler``'s events, so the profiled stretch of a traced run can
name each idle gap of the device by the program span that was open over
it, and by the last host sync that ended before it.  ``Tracer`` is
``tracing.Tracer`` with the program's spans on for the profiled stretch
only (that stretch has no ``stage`` hook and no sync of the benchmark's:
its gaps are the timed path's own) and the program's counters reset at the
window's start; its record adds ``program`` (``analyse``).  With a program
that has no ``orz_tpu_torch.trace`` it records what ``tracing.Tracer``
records, and the readers of ``program`` return None.
"""

from __future__ import annotations

import bisect
import time

import tracing

# the layer of each span name; a span of another name (``sync.*``) takes
# the layer of its nearest ancestor that has one
LAYERS = {
    "encode": "container", "read": "container", "frame": "container",
    "batch": "batch", "pad_h2d": "batch", "assemble": "batch",
    "otz1_fallback": "batch", "staged": "batch",
    "FRONT": "stages", "QUALITY scan": "stages", "QUALITY tail": "stages",
    "MID2": "stages", "MID": "stages", "BACK": "stages",
}
NO_SPAN = "(no program span)"
NO_SYNC = "(no sync before)"


def device_gaps(events, t_lo: int, t_hi: int) -> list[tuple[int, int]]:
    """The device's idle intervals within [t_lo, t_hi] (ns): the
    complement of the union of its operations (``tracing.is_device_op``)."""
    dev = sorted((tracing._ns(e, "start"), tracing._ns(e, "start") + tracing._ns(e, "duration"))
                 for e in events if tracing.is_device_op(e))
    gaps, last = [], t_lo
    for s, t in dev:
        s, t = max(s, t_lo), min(t, t_hi)
        if t <= s:
            continue
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if t_hi > last:
        gaps.append((last, t_hi))
    return gaps


def layer_of(span: dict, by_id: dict) -> str | None:
    while span is not None:
        if span["name"] in LAYERS:
            return LAYERS[span["name"]]
        span = by_id.get(span["parent"])
    return None


def attribute(gaps, spans) -> dict:
    """Each gap's seconds summed by the innermost span covering its middle
    (the latest started, on any thread), by that span's layer, and by the
    last ``sync.*`` span that ended before the gap began."""
    by_id = {s["id"]: s for s in spans}
    order = sorted(spans, key=lambda s: s["start"])
    syncs = sorted((s for s in spans if s["name"].startswith("sync.")),
                   key=lambda s: s["end"])
    sync_ends = [s["end"] for s in syncs]
    by_span: dict[str, float] = {}
    by_layer: dict[str, float] = {}
    after_sync: dict[str, float] = {}
    active, j = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid, sec = (a + b) // 2, (b - a) * 1e-9
        while j < len(order) and order[j]["start"] <= mid:
            active.append(order[j])
            j += 1
        active = [s for s in active if s["end"] >= mid]
        inner = active[-1] if active else None
        name = inner["name"] if inner else NO_SPAN
        by_span[name] = by_span.get(name, 0.0) + sec
        layer = layer_of(inner, by_id) or NO_SPAN
        by_layer[layer] = by_layer.get(layer, 0.0) + sec
        k = bisect.bisect_right(sync_ends, a) - 1
        name = syncs[k]["name"] if k >= 0 else NO_SYNC
        after_sync[name] = after_sync.get(name, 0.0) + sec
    return {"idle_by_span": by_span, "idle_by_layer": by_layer,
            "idle_after_sync": after_sync}


def covered(lo: int, hi: int, intervals) -> int:
    """ns of [lo, hi] covered by the union of `intervals`."""
    total, last = 0, lo
    for s, t in sorted(intervals):
        s, t = max(s, last), min(t, hi)
        if t > s:
            total += t - s
            last = t
    return total


def descendants(spans) -> dict:
    """id -> the spans below it."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    out: dict = {}

    def below(i):
        if i not in out:
            out[i] = [d for k in kids.get(i, ()) for d in [k] + below(k["id"])]
        return out[i]

    for s in spans:
        below(s["id"])
    return out


def self_times(spans) -> dict:
    """Seconds by span name: each span's duration less what its children
    cover."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append((s["start"], s["end"]))
    out: dict[str, float] = {}
    for s in spans:
        own = s["end"] - s["start"] - covered(s["start"], s["end"], kids.get(s["id"], ()))
        out[s["name"]] = out.get(s["name"], 0.0) + own * 1e-9
    return out


def layer_self(spans) -> dict:
    """The container's and the batch layer's own time, with the walls they
    are shares of (s): ``encode`` less its ``batch`` spans; ``batch`` less
    its stages and host syncs."""
    below = descendants(spans)
    out = {"encode_wall": 0.0, "encode_self": 0.0, "batch_wall": 0.0, "batch_self": 0.0}
    for s in spans:
        if s["name"] not in ("encode", "batch"):
            continue
        if s["name"] == "encode":
            cut = [(d["start"], d["end"]) for d in below[s["id"]] if d["name"] == "batch"]
        else:
            cut = [(d["start"], d["end"]) for d in below[s["id"]]
                   if LAYERS.get(d["name"]) == "stages" or d["name"].startswith("sync.")]
        wall = s["end"] - s["start"]
        out[s["name"] + "_wall"] += wall * 1e-9
        out[s["name"] + "_self"] += (wall - covered(s["start"], s["end"], cut)) * 1e-9
    return out


def launches_in(events, spans, name: str = "batch") -> tuple[int, int]:
    """(CUDA runtime launch calls that lie inside a span `name`, all
    of them): how well the spans and the profiler's events share a clock."""
    union: list[list[int]] = []
    for s, t in sorted((s["start"], s["end"]) for s in spans if s["name"] == name):
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], t)
        else:
            union.append([s, t])
    starts = [s for s, _ in union]
    n = inside = 0
    for e in events:
        if e.name() != "cudaLaunchKernel" or str(e.device_type()).endswith("CUDA"):
            continue
        lo = tracing._ns(e, "start")
        k = bisect.bisect_right(starts, lo) - 1
        n += 1
        inside += k >= 0 and lo + tracing._ns(e, "duration") <= union[k][1]
    return inside, n


def analyse(spans, counters: dict, window: dict, events=None, t_lo=None, t_hi=None) -> dict:
    """The record's ``program``: `spans` (``trace.stop()``'s records) and
    `counters` of the profiled stretch, the `window`'s counters, and, given
    the profiler's `events` over [t_lo, t_hi], the idle gaps named by
    span, layer and sync."""
    out = {"spans": len(spans), "window_ns": [t_lo, t_hi],
           "batches": sum(s["name"] == "batch" for s in spans),
           "stretch_counters": counters, "counters": window,
           "self_s": self_times(spans), **layer_self(spans)}
    if events is not None:
        out.update(attribute(device_gaps(events, t_lo, t_hi), spans))
        out["launches_in_batch"] = launches_in(events, spans)
    return out


class Tracer(tracing.Tracer):
    """``tracing.Tracer`` with the program's spans over its profiled
    stretch and the program's new counters over the window."""

    def __init__(self, torch, container, device: str):
        super().__init__(torch, container, device)
        try:
            from orz_tpu_torch import trace
            from orz_tpu_torch.device import batch
        except ImportError:  # a program without spans
            trace = batch = None
        self.program, self.batch_mod = trace, batch
        self.program_spans: list[dict] = []
        self.stretch_counters: dict = {}
        self.window_ns = [None, None]  # the profiled stretch, on the spans' clock

    def counters(self) -> dict:
        return {"host_syncs": int(self.program.host_syncs),
                "staged_batches": int(self.batch_mod.staged_batches)}

    def start(self) -> None:
        if self.program is not None:
            self.program.host_syncs = 0
            self.batch_mod.staged_batches = 0
            self.program.start()
        super().start()
        self.window_ns[0] = time.time_ns()

    def stop(self) -> None:
        was = self.profiling
        if was:
            self.window_ns[1] = time.time_ns()
        super().stop()
        if was and self.program is not None:
            self.program_spans = self.program.stop()
            self.stretch_counters = self.counters()

    def record(self) -> dict:
        rec = super().record()
        if self.program is None:
            return rec
        ev = lo = hi = None
        if "trace" in rec:
            ev = self.prof.profiler.kineto_results.events()
            ends = [(tracing._ns(e, "start"), tracing._ns(e, "start") + tracing._ns(e, "duration"))
                    for e in ev]
            # the events' span, widened to the stretch: the idle time of
            # `idle_share`'s window, before the first event and after the last
            lo = min([s for s, _ in ends] + self.window_ns[:1])
            hi = max([t for _, t in ends] + self.window_ns[1:])
        rec["program"] = analyse(self.program_spans, self.stretch_counters,
                                 self.counters(), ev, lo, hi)
        return rec
