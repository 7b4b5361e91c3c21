"""A short run of a cell on the card, through the benchmark's own
command; skips where no card is present."""

import json
import os
import subprocess
import sys

import pytest

import tiny


@pytest.mark.cuda
def test_short_run_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, os.path.join(tiny.PB, "run.py"),
                          "--workload", "l1-canterbury", "--seed", str(2 ** 31 + 101),
                          "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=tiny.REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"encode_MBps.host_bound", "ratio", "object_p90_s",
                                   "peak_mem_GiB", "setup_s"}
