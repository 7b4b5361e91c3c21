"""The harness finds cells, mixes and metrics by name, runs its window and
prints its line at a tiny size on the CPU, and its output check fails the
control and each fault that a cell can have."""

import json
import os
import sys
import time

import pytest

import tiny

torch = pytest.importorskip("torch")
import faults  # noqa: E402
import harness  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("pb")))


def run(root, cell, seed=2 ** 31 + 17, trace=False, patch=None, seconds=0.5):
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                            device="cpu", root=root, patch=patch, check_workers=0)


def test_new_files_only_are_found_by_name(root, tmp_path):
    """A dummy configuration, mix and metric, added as new files, are
    listed and resolved by name; no existing file is edited."""
    r = tiny.make_root(str(tmp_path))
    pb = os.path.join(r, "portbench")
    before = {p: open(os.path.join(pb, p), "rb").read()
              for p in ("harness.py", "run.py", "tracing.py", "ref/check.py")}
    tiny.write(os.path.join(pb, "configs", "dummy.json"),
               {"encode": {"level": 1, "segment_size": 4096, "batch": 1}, "env": {}})
    mix = json.load(open(os.path.join(pb, "traffic", "tiny-objects.json")))
    mix["params"] = dict(objects=[["x", 500, "text"], ["y", 900, "c"]], vocabulary=100)
    tiny.write(os.path.join(pb, "traffic", "dummy-mix.json"), mix)
    with open(os.path.join(pb, "metrics", "dummy_count.py"), "w") as f:
        f.write("def read(rec):\n    return len(rec['sizes'])\n")
    bench = json.load(open(os.path.join(r, "BENCHMARK.json")))
    bench["configs"].append({"name": "dummy", "source": "test", "reduced": [],
                             "file": "portbench/configs/dummy.json", "why": "test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy",
                               "traffic": "dummy-mix", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "dummy_count", "unit": "count", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["dummy-cell"]})
    tiny.write(os.path.join(r, "BENCHMARK.json"), bench)
    c = harness.Cell("dummy-cell", r)
    assert c.config["encode"]["segment_size"] == 4096
    assert c.source(3).sizes() == [500, 900]
    assert "dummy_count" in [m["name"] for m in c.metrics(False)]
    res = run(r, "dummy-cell", seconds=0.1)
    assert res["correct"] and res["metrics"]["dummy_count"]["value"] == res["attempted"]
    assert before == {p: open(os.path.join(pb, p), "rb").read() for p in before}


@pytest.mark.parametrize("cell,trace", [("tiny-files-l1", False), ("tiny-files-l1", True),
                                        ("tiny-objects-l1", False), ("tiny-objects-l1", True),
                                        ("tiny-files-l2", True)])
def test_window_and_last_line(root, cell, trace, capsys):
    res = run(root, cell, trace=trace)
    assert list(res)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in harness.Cell(cell, root).metrics(trace)}
    got = set(res["metrics"])
    assert got <= want
    if not trace:
        # peak memory is a device reading: absent on the CPU
        assert want - got <= {"peak_mem_GiB"}
        rate = "encode_MBps" if cell == "tiny-files-l2" else "encode_MBps.host_bound"
        assert res["metrics"][rate]["unit"] == "MB/s"
    else:
        # the device trace's readers find nothing on the CPU and stay silent
        silent = {"scan_share", "K1_shape_GBps", "K2_shape_GBps", "idle_share"}
        silent |= {m + ".host_bound" for m in silent}
        assert want - got <= silent and not got & silent
        sfx = "" if cell == "tiny-files-l2" else ".host_bound"
        assert res["metrics"]["segment_retries" + sfx]["value"] == 0
        if cell.endswith("l2"):
            assert 0 < res["metrics"]["stage_share.QUALITY" + sfx]["value"] < 100
    json.dumps(res)
    assert res["check"] == {"bytes_wrong": {"value": 0, "limit": 0},
                            "streams_bad": {"value": 0, "limit": 0}}


def test_main_prints_check_last(root, monkeypatch, capsys):
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {
        "correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
        "check": {"bytes_wrong": {"value": 0, "limit": 0}}})
    assert harness.main(["--workload", "x", "--seed", "1", "--seconds", "1"], 0.0) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
    assert err.strip().splitlines()[-1] == "check bytes_wrong 0 limit 0"


# the control breaks the lossless guarantee; the faults are those a cell
# can have (the Canterbury cells' batches hold one object padded with
# copies of it, so half a batch left out cannot show there)
@pytest.mark.parametrize("cell,fault", [
    ("tiny-files-l1", "control"), ("tiny-objects-l1", "control"),
    ("tiny-files-l1", "unchanged"), ("tiny-objects-l1", "unchanged"),
    ("tiny-files-l1", "half_batch"),
    ("tiny-files-l1", "token"), ("tiny-objects-l1", "token"),
])
def test_check_fails_control_and_faults(root, cell, fault):
    from orz_tpu_torch.device import container

    orig = container.encode_segments_batch
    try:
        res = run(root, cell, patch=faults.patch(fault))
    finally:
        container.encode_segments_batch = orig
    assert res["correct"] is False
    n = {k: v["value"] for k, v in res["check"].items()}
    assert n["bytes_wrong"] > 0 or n["streams_bad"] > 0


def test_warmup_sizes_one_per_bucket():
    assert harness.warmup_sizes([10 ** 8], 1 << 23) == [1 << 23]
    assert harness.warmup_sizes([3721, 4000, 5000, 1029744], 1 << 23) == [4000, 5000, 1029744]


def test_tracer_adds_nothing_while_profiling():
    """The profiled inputs run the batch layer as the timed path does, with
    no stage hook and no span; the inputs after them get both."""
    from orz_tpu_torch.device import container
    import tracing

    seen = []
    orig = container.encode_segments_batch

    def spy(*a, **kw):
        seen.append("stage" in kw)
        return orig(*a, **kw)

    container.encode_segments_batch = spy
    data = bytes(range(256)) * 40
    try:
        tr = tracing.Tracer(torch, container, "cpu")
        enc = lambda: container.torch_encode_bytes(data, level=1, device="cpu",  # noqa: E731
                                                   segment_size=8192, batch=1)
        tr.start()
        tr.input(enc)
        n = len(seen)
        tr.stop()
        tr.input(enc)
        rec = tr.record()
        tr.close()
    finally:
        container.encode_segments_batch = orig
    assert n == 2 and seen == [False] * n + [True] * n
    assert len(rec["inputs"]) == 1 and len(rec["batches"]) == n
    assert all(b["stages"] for b in rec["batches"])
