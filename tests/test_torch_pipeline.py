"""The per-segment staged encoder (``orz_tpu_torch/device/pipeline.py``)
and the batch's routing through it, against the JAX package on the CPU.

The JAX functions ran with ``OTZ2_SCHEDULE=96x1,384x2`` (every code path
of the default schedule at a quarter of its steps), on segments of at most
4 KiB; their payloads are recorded (``tests/torch_jax_records.json``,
records ``staged-l2`` and ``staged-otz1``, written by
``tests/torch_parity_ref.py``).  Each case holds the port's payload to
JAX's:

- ``encode_segment_staged`` at l2 (OTZ2), l1, l0 and l2 with ``OTZ2=0``,
  on text, on binary, on 17 bytes and on no bytes;
- ``encode_segment_device`` (JAX's monolithic OTZ1 program) at l1 and l0;
- ``encode_segments_batch`` on a batch that holds an empty segment, which
  goes whole through the staged encoder;
- the symrank skew check with ``R_CAP_MAX`` set low in both packages'
  modules (for the test only): the batch (at l1, after MID) goes whole
  through the staged encoder, which sends the segment past it to
  ``encode_segment_device``; at l2 the port's staged encoder does the
  same (held to its own ``encode_segment_device``).

The best-of-N emission pick (``best_emission``) is held, case by case, to
an oracle written here from JAX's ``dispatch_segment_mid2``.  All outputs
are bytes or integers: tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from orz_tpu_torch.device import batch as tb
from orz_tpu_torch.device import host as th
from orz_tpu_torch.device import pipeline as tp
from orz_tpu_torch.device.container import decode_segment
from orz_tpu_torch.spec import CHUNK_INPUT_DEFAULT
from tests.conftest import make_binary_like, make_text_like
from tests.torch_parity_ref import expect, payload_digests

torch.set_num_threads(2)

SCHEDULE = "96x1,384x2"
SKEW_CAP = 64  # R_CAP_MAX for the skew cases: text is past it, binary not

# name -> (segment, level, OTZ2 env value or None); the l2 cases are one
# record, the OTZ1 cases another, and each record is read by one test
L2 = {"text": ("text", 2, None), "binary": ("binary", 2, None),
      "17 bytes": ("17", 2, None), "empty": ("empty", 2, None),
      "OTZ2=0 text": ("text", 2, "0")}
OTZ1 = {"l1 text": ("text", 1, None), "l0 text": ("text", 0, None),
        "l1 17 bytes": ("17", 1, None), "l1 empty": ("empty", 1, None)}
DEVICE = {"l1 text": ("text", 1), "l0 text": ("text", 0),
          "l1 binary": ("binary", 1)}


@pytest.fixture(scope="module")
def segs():
    rng = np.random.default_rng(0x7E5)
    text = make_text_like(rng, 4000)
    return {"text": text, "binary": make_binary_like(rng, 4000),
            "17": text[:17], "empty": b""}


@pytest.fixture
def schedule(monkeypatch):
    monkeypatch.setenv("OTZ2_SCHEDULE", SCHEDULE)


def _staged(data, level, otz2, monkeypatch):
    with monkeypatch.context() as mp:
        if otz2 is not None:
            mp.setenv("OTZ2", otz2)
        return tp.encode_segment_staged(data, level, device="cpu")


def _staged_matches(segs, cases, rec, monkeypatch):
    """Each case's staged payload equals JAX's recorded one (at the
    recorded level and OTZ2) and decodes."""
    for name, (seg, level, otz2) in cases.items():
        want = rec["staged"][name]
        assert (want["level"], want["otz2"]) == (level, otz2), name
        got = _staged(segs[seg], level, otz2, monkeypatch)
        assert payload_digests([got]) == [want["payload"]], name
        assert decode_segment(got) == segs[seg], name


def test_staged_l2_matches_jax(segs, schedule, monkeypatch):
    """encode_segment_staged at l2 on text, binary, 17 and 0 bytes, and
    with OTZ2=0; a batch that holds an empty segment (whole through the
    staged encoder); past R_CAP_MAX the staged encoder emits the text
    segment as OTZ1 through encode_segment_device (JAX's route for it is
    held at l1)."""
    rec = expect("staged-l2", [segs["text"], segs["binary"]])
    _staged_matches(segs, L2, rec, monkeypatch)
    batch = [segs["text"], b"", segs["binary"]]
    got = tb.encode_segments_batch(batch, 2, device="cpu")
    assert payload_digests(got) == rec["batch"]
    assert got == [tp.encode_segment_staged(s, 2, device="cpu")
                   for s in batch]
    normal = got[0]
    with monkeypatch.context() as mp:
        mp.setattr(th, "R_CAP_MAX", SKEW_CAP)
        got = tp.encode_segment_staged(segs["text"], 2, device="cpu")
        assert got == tp.encode_segment_device(segs["text"], 2, device="cpu")
        assert got != normal  # the check did route it
        binary = tp.encode_segment_staged(segs["binary"], 2, device="cpu")
    assert binary == tp.encode_segment_staged(segs["binary"], 2,
                                              device="cpu")  # not past it


def test_staged_otz1_and_device_match_jax(segs, schedule, monkeypatch):
    """encode_segment_staged at l1 and l0; encode_segment_device at l1 and
    l0; the skew check after the batch's MID (at l1), which sends the batch
    whole through the staged encoder, where the text segment, past
    R_CAP_MAX, goes on to encode_segment_device (JAX's payloads: with
    R_CAP_MAX = SKEW_CAP in both its modules that read it)."""
    rec = expect("staged-otz1", [segs["text"], segs["binary"]])
    _staged_matches(segs, OTZ1, rec, monkeypatch)
    for name, (seg, level) in DEVICE.items():
        want = rec["device"][name]
        assert want["level"] == level, name
        got = tp.encode_segment_device(segs[seg], level, device="cpu")
        assert payload_digests([got]) == [want["payload"]], name
        assert got == tp.encode_segment_staged(segs[seg], level,
                                               device="cpu"), name
    pair = [segs["text"], segs["binary"]]
    normal = tb.encode_segments_batch(pair, 1, device="cpu")
    assert rec["skew"]["R_CAP_MAX"] == SKEW_CAP
    with monkeypatch.context() as mp:
        mp.setattr(th, "R_CAP_MAX", SKEW_CAP)
        got = tb.encode_segments_batch(pair, 1, device="cpu")
        assert payload_digests(got) == rec["skew"]["payloads"]
    assert got == normal  # at l1 staged and batched payloads agree


def _oracle_pick(emissions, thr):
    """JAX's dispatch_segment_mid2 pick (orz_tpu/device/pipeline.py), on
    precomputed (ok, demoted) emissions, newest first: the index chosen
    (None: the OTZ1 fallback) and how many were emitted."""
    cand = [(0, *emissions[0])]
    for k in range(1, len(emissions)):
        if cand[-1][1] and cand[-1][2] <= thr:
            break
        cand.append((k, *emissions[k]))
    ok = [c for c in cand if c[1]]
    if not ok:
        return None, len(cand)
    return min(ok, key=lambda c: c[2])[0], len(cand)


@pytest.mark.parametrize("emissions", [
    pytest.param([(True, 10), (True, 0), (True, 0)], id="newest-good"),
    pytest.param([(False, 5), (True, 7), (True, 1)], id="newest-failed"),
    pytest.param([(True, 5000), (True, 4000), (True, 3000), (True, 9)],
                 id="older-needed"),
    pytest.param([(True, 3000), (False, 0), (True, 2000), (True, 2000)],
                 id="three-older"),
    pytest.param([(True, 2000), (True, 1500), (True, 1500)], id="tie"),
    pytest.param([(False, 0), (False, 0), (False, 0)], id="none-ok"),
    pytest.param([(True, 1024)], id="single-at-thr"),
])
def test_best_emission_matches_jax_rule(emissions):
    thr = 1024
    emitted = []

    def emit(k):
        emitted.append(k)
        ok, dem = emissions[k]
        return ok, dem, k

    best, cand = tp.best_emission(emit, list(range(len(emissions))), thr)
    want, n_emitted = _oracle_pick(emissions, thr)
    assert (None if best is None else best[2]) == want
    assert emitted == list(range(n_emitted))
    assert [c[:2] for c in cand] == [tuple(e) for e in emissions[:n_emitted]]


def test_staged_anomalous_emission(schedule):
    """A 40000-byte text segment whose newest iterate demotes more than
    thr: every older iterate is emitted (four emissions, the oldest, the
    FRONT parse, fails its repair) and the newest, with the fewest
    demotions, wins, as in the batch's best-of-2, so the staged payload
    equals the batched one.  No input of the test makers up to 64 KiB was
    found on which the two differ."""
    data = make_text_like(np.random.default_rng(1), 40000)
    mid = tp.dispatch_segment_mid2(tp.dispatch_segment_front(
        data, 2, CHUNK_INPUT_DEFAULT, "cpu"))
    em = mid["emissions"]
    assert len(em) == 4 and em[0][1] > mid["thr"] and not em[3][0]
    assert em[0][1] == min(d for ok, d in em if ok)
    payload = tp.finish_segment(data, tp.dispatch_segment_back(mid),
                                CHUNK_INPUT_DEFAULT)
    assert payload == tb.encode_segments_batch([data], 2, device="cpu")[0]
    assert decode_segment(payload) == data


def test_staged_entry_points_need_cuda(segs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (tp.encode_segment_staged, tp.encode_segment_device):
        for data in (segs["text"], b""):
            with pytest.raises(RuntimeError, match="is_available"):
                fn(data, 2)
