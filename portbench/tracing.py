"""Spans and counters of a traced run, taken from the benchmark's side.

The traced run drives the same ``torch_encode_bytes`` entry as the timed
one, in two stretches.  First the profiled inputs (the mix's
``trace_inputs``): ``torch.profiler`` records the device's operations and
the CUDA runtime calls (on a card no host operator is recorded, so the
profiler adds little host work) and nothing else is added, so that the
device's idle time is the timed path's own.  Only the kernel wrappers of
K1 and K2 are wrapped, to note the shapes they are launched at.  Then the
rest of the window, not profiled: the tracer wraps the batch layer's entry
``encode_segments_batch`` (ended by a synchronise, and given a ``stage``
hook that synchronises and times each device stage) and times each input,
for the span metrics.  The counters are the program's own module counters
over the whole window.
"""

from __future__ import annotations

import time

def _counter_homes(container):
    from orz_tpu_torch.device import batch

    return [("segment_retries", container, "segment_retries"),
            ("otz1_fallbacks", batch, "otz1_fallbacks")]


def reset_counters(container) -> None:
    for _, mod, attr in _counter_homes(container):
        setattr(mod, attr, 0)


def read_counters(container) -> dict:
    return {name: int(getattr(mod, attr)) for name, mod, attr in _counter_homes(container)}


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


def short_name(name: str) -> str:
    """A kernel's name without its namespace prefix, return type, template
    arguments and signature."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for cut in ("<", "("):
        i = name.find(cut)
        if i > 0:
            name = name[:i]
    return name.strip()[:120]


def is_device_op(e) -> bool:
    """A device event that is work: not the device's copy of a host
    annotation (such ranges span the GPU's idle gaps)."""
    if not str(e.device_type()).endswith("CUDA"):
        return False
    f = getattr(e, "is_user_annotation", None)
    return not (f is not None and f())


def summarise(events, t_lo: int, t_hi: int) -> dict:
    """Device busy time, time by device operation and idle gaps named by
    the host operation that ran through them, from the profiler's events
    (times in ns on one clock) within [t_lo, t_hi]."""
    dev, host = [], []
    for e in events:
        s = _ns(e, "start")
        d = _ns(e, "duration")
        if is_device_op(e):
            dev.append((s, s + d, e.name()))
        elif str(e.device_type()).endswith("CPU"):
            host.append((s, s + d, e.name()))
    by_name: dict[str, float] = {}
    for s, t, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-9
    dev.sort()
    merged = []
    for s, t, _ in dev:
        s, t = max(s, t_lo), min(t, t_hi)
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-9
    gaps, last = [], t_lo
    for s, t in merged:
        if s > last:
            gaps.append((last, s))
        last = t
    if t_hi > last:
        gaps.append((last, t_hi))
    # name each gap by the innermost host event (on a card, a CUDA runtime
    # call) covering its middle
    host.sort(key=lambda h: (h[0], -h[1]))
    idle: dict[str, float] = {}
    stack, j = [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        mid = (a + b) // 2
        while j < len(host) and host[j][0] <= mid:
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        k = len(stack) - 1
        while k >= 0 and stack[k][1] < mid:
            k -= 1
        name = stack[k][2] if k >= 0 else "(host code outside CUDA calls)"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    short: dict[str, float] = {}
    for n, v in by_name.items():
        short[short_name(n)] = short.get(short_name(n), 0.0) + v
    return {"busy_s": busy, "device_s": sum(by_name.values()),
            "device_ops": by_name, "device_ops_short": short, "idle_by_host": idle}


class Tracer:
    """The traced window's two stretches; see the module's docstring."""

    def __init__(self, torch, container, device: str):
        from orz_tpu_torch.ops import batched

        self.torch = torch
        self.sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        self.inputs: list[dict] = []
        self.batches: list[dict] = []
        self.kernel_calls: dict[str, list] = {"match_depth": [], "match_depth_masked": []}
        self.profiling = False
        self.spans = False
        self._cur: dict | None = None
        self._restore = []

        def patch(mod, attr, wrapper):
            orig = getattr(mod, attr)
            self._restore.append((mod, attr, orig))
            setattr(mod, attr, wrapper(orig))

        def stage(name, fn):
            self.sync()
            t0 = time.perf_counter()
            out = fn()
            self.sync()
            st = self._cur["stages"]
            st[name] = st.get(name, 0.0) + time.perf_counter() - t0
            return out

        def batch_wrapper(orig):
            def encode_segments_batch(*a, **kw):
                if not self.spans:
                    return orig(*a, **kw)
                self._cur = {"stages": {}}
                t0 = time.perf_counter()
                out = orig(*a, stage=stage, **kw)
                self.sync()
                self._cur["wall"] = time.perf_counter() - t0
                self.batches.append(self._cur)
                self._cur = None
                return out
            return encode_segments_batch

        def kernel_wrapper(name):
            def wrap(orig):
                def call(msk, *a, **kw):
                    if self.profiling:
                        self.kernel_calls[name].append(tuple(msk.shape))
                    return orig(msk, *a, **kw)
                return call
            return wrap

        patch(container, "encode_segments_batch", batch_wrapper)
        for k in self.kernel_calls:
            patch(batched, k, kernel_wrapper(k))
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(
            activities=[act.CUDA if device == "cuda" else act.CPU])
        self.trace_window_s = 0.0

    def start(self) -> None:
        """Start the profiled stretch."""
        self.sync()
        self.prof.start()
        self.profiling = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """End the profiled stretch and start the spans."""
        if not self.profiling:
            return
        self.sync()
        self.trace_window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.profiling = False
        self.spans = True

    def input(self, fn):
        if not self.spans:
            return fn()
        n0 = len(self.batches)
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        self.inputs.append({"wall": wall,
                            "batch": sum(b["wall"] for b in self.batches[n0:])})
        return out

    def record(self) -> dict:
        rec = {"inputs": self.inputs, "batches": self.batches,
               "kernel_calls": self.kernel_calls,
               "trace_window_s": self.trace_window_s}
        events = self.prof.profiler.kineto_results.events()
        if any(is_device_op(e) for e in events):
            ends = [(_ns(e, "start"), _ns(e, "start") + _ns(e, "duration")) for e in events]
            t_lo, t_hi = min(s for s, _ in ends), max(t for _, t in ends)
            tr = summarise(events, t_lo, t_hi)
            tr["window_s"] = self.trace_window_s  # the host clock's, synchronised
            rec["trace"] = tr
            rec["busy_s"] = tr["busy_s"]
            top = sorted(tr["device_ops_short"].items(), key=lambda kv: -kv[1])[:10]
            gaps = sorted(tr["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
            rec["breakdown"] = {"device_ops": [[n, v] for n, v in top],
                                "idle_gaps": [[n, v] for n, v in gaps]}
        return rec

    def close(self) -> None:
        for mod, attr, orig in reversed(self._restore):
            setattr(mod, attr, orig)
        self._restore.clear()
