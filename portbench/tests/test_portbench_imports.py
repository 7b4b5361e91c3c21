"""Nothing a run loads is JAX or the JAX package, and the plain reference
loads nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "orz_tpu"}

LOAD_ALL = r"""
import json, os, sys
repo, pb = sys.argv[1], sys.argv[2]
sys.path[:0] = [repo, pb]
import harness, tracing
import check, otz
bench = json.load(open(os.path.join(repo, "BENCHMARK.json")))
for w in bench["workloads"]:
    c = harness.Cell(w["name"])
    harness.load_module(c.gen_path, "g_" + c.traffic["generator"])
    for trace in (0, 1):
        for m in c.metrics(trace):
            c.reader(m["name"])
import orz_tpu_torch.device.container
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code, tiny.REPO, tiny.PB],
                         capture_output=True, text=True, timeout=300, check=True,
                         env={k: v for k, v in os.environ.items()
                              if not k.startswith("PYTHON")})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    tops = loaded(LOAD_ALL)
    assert "orz_tpu_torch" in tops and "torch" in tops
    # whole top-level names: orz_tpu_torch begins with orz_tpu and is another name
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = r"""
import json, sys
sys.path[:0] = [sys.argv[2] + "/ref"]
import check, otz
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    tops = loaded(code)
    assert not tops & (FORBIDDEN | {"orz_tpu_torch", "torch", "numpy"})
    for path in glob.glob(os.path.join(tiny.PB, "ref", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"orz_tpu_torch", "torch"}, (path, n)


def test_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(tiny.PB, "run.py"),
                          "--workload", "l1-canterbury", "--seed", str(2 ** 31 + 9),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tiny.REPO,
                         env=env)
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""  # no result line
    assert "is_available() is false" in out.stderr
