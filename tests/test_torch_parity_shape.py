"""Stream parity with the JAX package at the shape the encoder runs, on the
CPU: several entropy chunks a segment, the default l2 schedule, contexts
that recur past the far gates.

``tests/torch_parity_digests.json`` holds JAX's digests, written by
``python -m tests.torch_parity_ref`` (``orz_tpu``'s ``tpu_encode_bytes``
on XLA:CPU) from ``orz_tpu_torch.tools.parity_data.make_parity_data``.
Here:

- the generator reproduces every recorded data SHA-256;
- the port's ``torch_encode_bytes(..., device="cpu")`` on case S (two
  128 KiB segments, 32 KiB chunks: four a segment), batched and staged
  (``ORZ_PER_SEGMENT=1``), at l1 and at l2's default schedule with every
  ``OTZ*``/``ORZ*`` knob cleared, gives JAX's payloads and stream
  (tolerance 0: bytes), and each stream round-trips through the native
  decoder;
- the port's ``mesh_encode_segments`` over four CPU devices gives JAX's
  mesh digest;
- JAX's l1 encode of case S, run live, gives its committed digest (so the
  file is the one its generator writes);
- the recorded far counts reach the gates: in S, items at reduced offsets
  of at least ``FAR_RO_1``; in L, at least ``FAR_RO_2`` too; and the
  port's S l1 pass gives the recorded counts.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from orz_tpu_torch.device import container as tc
from orz_tpu_torch.tools import parity_data as pd

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGESTS = os.path.join(ROOT, "tests", "torch_parity_digests.json")
CPU4 = (torch.device("cpu"),) * pd.MESH_DEVICES

with open(DIGESTS) as _f:
    CASES = json.load(_f)["cases"]
# S-l3 would add about 75 s at two threads to this module's 105; the card
# holds the port to it (chip_smoke.py's jax parity phase runs every case)
S_CASES = ["S-l1", "S-l2"]


@pytest.fixture
def no_knobs(monkeypatch):
    for k in [k for k in os.environ if k.startswith(("OTZ", "ORZ"))]:
        monkeypatch.delenv(k)


def case_data(rec: dict) -> bytes:
    return pd.make_parity_data(rec["seed"], rec["n"], rec["segment_size"])


def encode_kw(rec: dict) -> dict:
    return dict(segment_size=rec["segment_size"],
                chunk_input=rec["chunk_input"], batch=rec["batch"])


@pytest.mark.parametrize("name", list(CASES))
def test_parity_data_reproduces_digest(name):
    rec = CASES[name]
    assert pd.sha256(case_data(rec)) == rec["data_sha256"]


@pytest.mark.parametrize("path", ["batched", "staged"])
@pytest.mark.parametrize("name", S_CASES)
def test_port_matches_jax_digests(name, path, no_knobs, monkeypatch):
    from orz_tpu_torch.spec import otz2_schedule

    rec = CASES[name]
    assert otz2_schedule(rec["level"]) == rec["schedule"]
    data = case_data(rec)
    if path == "staged":
        monkeypatch.setenv("ORZ_PER_SEGMENT", "1")
    stream = tc.torch_encode_bytes(data, rec["level"], device="cpu",
                                   **encode_kw(rec))
    assert pd.parity_faults(rec, path, data, stream) == []
    assert tc.torch_decode_bytes(stream) == data


def test_mesh_matches_jax_digest(no_knobs):
    from orz_tpu_torch.parallel.mesh import mesh_encode_segments

    rec = CASES["S-l1"]
    data = case_data(rec)
    payloads = mesh_encode_segments(
        pd.mesh_segments(data, rec["segment_size"]), rec["level"],
        rec["chunk_input"], mesh=CPU4)
    stream = pd.frame_stream(payloads, rec["segment_size"])
    assert pd.parity_faults(rec, "mesh", data, stream) == []


def jax_stream(data: bytes, level: int, kw: dict) -> bytes:
    """``orz_tpu``'s ``tpu_encode_bytes`` (XLA:CPU)."""
    from orz_tpu.device.container import tpu_encode_bytes

    return tpu_encode_bytes(data, level, **kw)


def test_live_jax_matches_committed_digest(no_knobs):
    rec = CASES["S-l1"]
    data = case_data(rec)
    stream = jax_stream(data, rec["level"], encode_kw(rec))
    assert pd.parity_faults(rec, "batched", data, stream) == []


def test_far_counts_reach_the_gates(no_knobs):
    for name, rec in CASES.items():
        far = rec["far"]
        assert far["ro_ge_far_ro_1"] > 0, name
        if rec["size"] != "S":
            assert far["ro_ge_far_ro_2"] > 0, name
    from orz_tpu_torch.device.host import _bucket_capacity

    rec = CASES["S-l1"]
    data = case_data(rec)
    seg = rec["segment_size"]
    segs = [data[i:i + seg] for i in range(0, len(data), seg)]
    payloads, far = pd.batch_far_counts(segs, rec["level"], rec["chunk_input"],
                                        _bucket_capacity(seg), device="cpu")
    assert [[len(p), pd.sha256(p)] for p in payloads] == \
        rec["paths"]["batched"]["segments"]
    assert far == rec["far"]
