"""The program's spans laid over the device's timeline (``spans.py``) and
the readers of them, on synthetic records with known answers; then
``spans.Tracer`` in tiny runs on the CPU, with the program's spans and
without them (a program that has no ``orz_tpu_torch.trace``)."""

import json
import os
import sys
import time

import pytest

import tiny

torch = pytest.importorskip("torch")
import harness  # noqa: E402
import spans  # noqa: E402
import tracing  # noqa: E402

MS = 1_000_000  # ns
NEW = ["idle_share.container", "idle_share.batch", "idle_share.stages",
       "container_self_share", "batch_self_share", "syncs_per_batch",
       "staged_batches"]


class Event:
    """A profiler event: a device operation or a host (runtime) call."""

    def __init__(self, name, lo, hi, device=False):
        self._n, self._lo, self._d = name, lo * MS, (hi - lo) * MS
        self._dev = device

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self._lo

    def duration_ns(self):
        return self._d


# (name, id, parent, start ms, end ms): one encode of one l1 batch
TREE = [("encode", 1, None, 0, 100), ("read", 2, 1, 0, 10), ("batch", 3, 1, 10, 90),
        ("pad_h2d", 4, 3, 10, 15), ("sync.h2d_bufs", 5, 4, 11, 14),
        ("FRONT", 6, 3, 15, 50), ("sync.extend_nonzero", 7, 6, 30, 32),
        ("sync.m_cap", 8, 3, 50, 52), ("MID", 9, 3, 52, 70),
        ("BACK", 10, 3, 70, 85), ("sync.fetch_meta", 11, 10, 80, 84),
        ("assemble", 12, 3, 85, 90), ("frame", 13, 1, 90, 95)]
SPANS = [{"name": n, "id": i, "parent": p, "start": s * MS, "end": e * MS,
          "thread": 1, "encode": 1, "batch": None if i in (1, 2, 13) else 0}
         for n, i, p, s, e in TREE]
# device busy 16-29, 33-49, 53-68, 71-79: gaps 0-16 (read), 29-33
# (sync.extend_nonzero), 49-53 (sync.m_cap), 68-71 (MID), 79-100 (assemble)
DEVICE = [Event("k", 16, 29, True), Event("k", 33, 49, True),
          Event("k", 53, 68, True), Event("k", 71, 79, True)]
LAUNCHES = [Event("cudaLaunchKernel", t, t + 0.5) for t in (15, 32, 52, 70)]
LAUNCHES.append(Event("cudaLaunchKernel", 96, 96.5))  # outside the batch


def record():
    """A traced run's record of TREE over DEVICE, window 0-100 ms."""
    prog = spans.analyse(SPANS, {"host_syncs": 4, "staged_batches": 0},
                         {"host_syncs": 40, "staged_batches": 2},
                         DEVICE + LAUNCHES, 0, 100 * MS)
    return {"trace": {"window_s": 0.1, "busy_s": 0.052}, "program": prog}


def test_gaps_named_by_span_layer_and_sync():
    p = record()["program"]
    s = {k: round(v * 1e3, 6) for k, v in p["idle_by_span"].items()}
    assert s == {"read": 16, "sync.extend_nonzero": 4, "sync.m_cap": 4, "MID": 3,
                 "assemble": 21}
    layer = {k: round(v * 1e3, 6) for k, v in p["idle_by_layer"].items()}
    assert layer == {"container": 16, "stages": 7, "batch": 25}
    after = {k: round(v * 1e3, 6) for k, v in p["idle_after_sync"].items()}
    assert after == {spans.NO_SYNC: 16, "sync.h2d_bufs": 4,
                     "sync.extend_nonzero": 4, "sync.m_cap": 24}
    assert p["launches_in_batch"] == (4, 5)


def test_gap_outside_every_span():
    gaps = [(0, 5 * MS), (200 * MS, 210 * MS)]
    a = spans.attribute(gaps, SPANS)
    assert a["idle_by_span"] == {"read": 5e-3, spans.NO_SPAN: pytest.approx(1e-2)}
    assert a["idle_by_layer"][spans.NO_SPAN] == pytest.approx(1e-2)


def test_self_times_and_layer_self():
    p = record()["program"]
    st = {k: round(v * 1e3, 6) for k, v in p["self_s"].items()}
    assert st["encode"] == 5 and st["batch"] == 0 and st["FRONT"] == 33
    assert st["BACK"] == 11 and st["sync.m_cap"] == 2
    # encode 100 ms less its batch (80); batch 80 less stages (68) and the
    # syncs outside them (3 + 2)
    assert round(p["encode_self"] * 1e3, 6) == 20 and round(p["encode_wall"] * 1e3, 6) == 100
    assert round(p["batch_self"] * 1e3, 6) == 7 and round(p["batch_wall"] * 1e3, 6) == 80


def test_readers_on_a_known_record():
    rec = record()
    cell = harness.Cell("l2-enwik8")
    got = {m: cell.reader(m).read(rec) for m in NEW}
    assert got["idle_share.container"] == pytest.approx(16.0)
    assert got["idle_share.batch"] == pytest.approx(25.0)
    assert got["idle_share.stages"] == pytest.approx(7.0)
    assert got["container_self_share"] == pytest.approx(20.0)
    assert got["batch_self_share"] == pytest.approx(8.75)
    assert got["syncs_per_batch"] == 4 and got["staged_batches"] == 2
    for m in NEW:
        assert cell.reader(m + ".host_bound").read(rec) == got[m]
    # the three layers name all the idle time here: 48 ms of 100
    assert sum(got[m] for m in NEW[:3]) == pytest.approx(48.0)


def test_readers_return_none_without_the_program():
    cell = harness.Cell("l2-enwik8")
    for rec in ({}, {"trace": {"window_s": 0.1, "busy_s": 0.05}},
                {"program": spans.analyse([], {}, {"host_syncs": 0, "staged_batches": 0})}):
        for m in NEW:
            if m == "staged_batches" and "program" in rec:
                continue
            assert cell.reader(m).read(rec) is None, (m, rec)
            assert cell.reader(m + ".host_bound").read(rec) is None


def existing_metrics():
    with open(os.path.join(tiny.REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return [m["name"] for m in bench["per_layer"]]


def test_existing_readers_ignore_the_program():
    """Every accepted reader reads the same with the record's ``program``
    as without it."""
    rec = record()
    rec.update(inputs=[{"wall": 1.0, "batch": 0.9}],
               batches=[{"wall": 0.9, "stages": {"FRONT": 0.3, "QUALITY scan": 0.4}}],
               counters={"segment_retries": 0, "otz1_fallbacks": 0},
               kernel_calls={"match_depth": [], "match_depth_masked": []})
    rec["trace"].update(device_s=0.052, device_ops={}, device_ops_short={})
    bare = {k: v for k, v in rec.items() if k != "program"}
    cell = harness.Cell("l2-enwik8")
    for m in existing_metrics():
        assert cell.reader(m).read(rec) == cell.reader(m).read(bare), m


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny root whose BENCHMARK.json lists the new metrics too."""
    r = tiny.make_root(str(tmp_path_factory.mktemp("pbs")))
    path = os.path.join(r, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    host_bound = ["l1-enwik8", "l2-canterbury", "l1-canterbury", "tiny-files-l1",
                  "tiny-objects-l1"]
    for m in NEW:
        for name, cells in ((m, ["l2-enwik8", "tiny-files-l2"]),
                            (m + ".host_bound", host_bound)):
            bench["per_layer"].append({
                "name": name, "unit": "%", "better": "lower",
                "source": "program_span", "layer": "batch",
                "moves": "encode_MBps" + name[len(m):], "workloads": cells})
    tiny.write(path, bench)
    return r


@pytest.mark.parametrize("program", [True, False])
def test_tracer_in_a_tiny_run(root, monkeypatch, program):
    """``spans.Tracer`` in place of ``tracing.Tracer``: with the program's
    spans the span readers report (the device's idle ones stay silent on
    the CPU); without ``orz_tpu_torch.trace`` every new reader is silent and
    the accepted ones report what they report under ``tracing.Tracer``."""
    import orz_tpu_torch

    def run():
        return harness.run_cell("tiny-files-l1", 2 ** 31 + 5, 0.2, True,
                                time.perf_counter(), device="cpu", root=root,
                                check_workers=0)

    plain = run()
    if not program:
        monkeypatch.delattr(orz_tpu_torch, "trace")
        monkeypatch.setitem(sys.modules, "orz_tpu_torch.trace", None)
    monkeypatch.setattr(tracing, "Tracer", spans.Tracer)
    res = run()
    assert res["correct"] and plain["correct"]
    got = set(res["metrics"])
    new = {m + ".host_bound" for m in NEW}
    assert got - new == set(plain["metrics"])
    if program:
        assert got & new == {m + ".host_bound" for m in NEW[3:]}
        v = {m: res["metrics"][m + ".host_bound"]["value"] for m in NEW[3:]}
        assert 0 < v["container_self_share"] < 100 and 0 < v["batch_self_share"] < 100
        assert v["syncs_per_batch"] >= 7 and v["staged_batches"] == 0
    else:
        assert not got & new
