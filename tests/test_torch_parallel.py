"""The port's multi-device layer (``orz_tpu_torch/parallel/``) and the
per-segment container path, against the JAX package on the CPU.

- ``mesh_encode_segments_staged`` over four CPU devices equals JAX's over
  a 4-device mesh, with ``_sr_caps_for`` set low in both packages (for the
  test only), so that the text segments are flagged and re-encoded through
  the staged encoder; ``mesh_encode_segments`` (OTZ1) equals JAX's.
- A world-2 gloo run of ``distributed_encode_file`` in two subprocesses,
  in the style of ``tests/test_multiprocess.py``: every stripe of five
  16 KiB segments is short, so every payload is the staged encoder's, and
  the file decodes.  At world 1, a full run of four goes through the batch.
- ``torch_encode`` under ``ORZ_PER_SEGMENT=1`` equals ``tpu_encode`` under
  the same variable.

JAX's payloads are recorded (``tests/torch_jax_records.json``, records
``mesh-staged``, ``mesh-otz1`` and ``per-segment-l1``, written by
``tests/torch_parity_ref.py``): its chains ran at
``OTZ2_SCHEDULE=96x1,384x2`` on segments of at most 4 KiB.  All outputs are
bytes: tolerance 0.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from orz_tpu_torch.device import batch as tb
from orz_tpu_torch.device import container as tc
from orz_tpu_torch.device import pipeline as tp
from orz_tpu_torch.parallel import distributed as td
from orz_tpu_torch.parallel import mesh as tm
from tests.conftest import make_binary_like, make_text_like
from tests.torch_parity_ref import expect, payload_digests

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULE = "96x1,384x2"
CPU4 = (torch.device("cpu"),) * 4


@pytest.fixture
def schedule(monkeypatch):
    monkeypatch.setenv("OTZ2_SCHEDULE", SCHEDULE)


@pytest.fixture(scope="module")
def segs():
    rng = np.random.default_rng(0x3E5)
    return [make_text_like(rng, 4000), make_binary_like(rng, 4000),
            make_text_like(rng, 3000), make_binary_like(rng, 2500)]


def test_mesh_staged_matches_jax(segs, schedule, monkeypatch):
    """Symrank caps (1024, 64): the text segments' rounds past the first
    C_MID contexts pass 64, so both packages flag them and re-encode them
    through the staged encoder; the binary ones keep the chain's payload,
    the batch's."""
    def low(cap):
        return 1024, 64

    rec = expect("mesh-staged", segs, {"_sr_caps_for": list(low(0))})
    monkeypatch.setattr(tm, "_sr_caps_for", low)
    flagged = []
    got = tm.mesh_encode_segments_staged(segs, 2, mesh=CPU4, flagged=flagged)
    assert payload_digests(got) == rec["payloads"]
    assert [i for i, _ in flagged] == [0, 2]
    assert all(why.startswith("rounds - r1") for _, why in flagged)
    for i, (seg, payload) in enumerate(zip(segs, got)):
        if i in (0, 2):
            assert payload == tp.encode_segment_staged(seg, 2, rings_mode=1,
                                                       device="cpu")
        else:
            assert payload == tb.encode_segments_batch([seg], 2,
                                                       device="cpu")[0]


def test_mesh_staged_emits_again_at_cap(schedule, monkeypatch):
    """MID2 at an item bucket of exactly the larger iterate's item count,
    which the emissions of a segment with demotions (a 40000-byte text
    segment demotes more than a thousand items) overflow: the segment is
    emitted again at cap (JAX's m2_cap), and its payload does not change."""
    segs = [make_text_like(np.random.default_rng(1), 40000)]
    want = tm.mesh_encode_segments_staged(segs, 2, mesh=CPU4[:1])
    caps = []

    def mid2(bufs, seg_lens, it_a, it_b, m2_cap):
        caps.append(m2_cap)
        return tb.mid2_body(bufs, seg_lens, it_a, it_b, m2_cap)

    monkeypatch.setattr(tm, "m2_cap_for", lambda ni_max: ni_max)
    monkeypatch.setattr(tm, "mid2_body", mid2)
    flagged = []
    assert tm.mesh_encode_segments_staged(segs, 2, mesh=CPU4[:1],
                                          flagged=flagged) == want
    assert flagged == [] and len(caps) == 2 and caps[1] == 1 << 16


def test_mesh_encode_segments_matches_jax(segs):
    batch = [segs[0], b"", segs[0][:17], segs[1]]
    rec = expect("mesh-otz1", batch)
    got = tm.mesh_encode_segments(batch, 1, mesh=CPU4)
    assert payload_digests(got) == rec["payloads"]
    assert got == [tp.encode_segment_device(s, 1, device="cpu")
                   for s in batch]


def test_sr_caps_match_jax():
    from orz_tpu.parallel import mesh as jm

    for cap in (1 << 12, 1 << 15, 1 << 19, 1 << 21, 1 << 23, 1 << 25):
        assert tm._sr_caps_for(cap) == jm._sr_caps_for(cap)


def test_mesh_tiles():
    with pytest.raises(AssertionError, match="tile the mesh"):
        tm.mesh_encode_segments([b"abc"] * 3, 1, mesh=CPU4[:2])


WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, os.environ["ORZ_REPO"])
    import torch
    torch.set_num_threads(1)
    from orz_tpu_torch.parallel import distributed as D
    assert D.maybe_initialize(device="cpu")
    rank, world = D.process_info()
    assert world == 2, f"expected world 2, got {world}"
    D.distributed_encode_file(os.environ["ORZ_IN"], os.environ["ORZ_OUT"],
                              level=2, segment_size=1 << 14, device="cpu")
    torch.distributed.destroy_process_group()
    print(f"worker {rank}/{world} done", flush=True)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _container(segments, payloads, segment_size: int) -> bytes:
    import io

    from orz_tpu_torch.ioutil import write_len

    out = io.BytesIO()
    out.write(tc.TPU_MAGIC)
    write_len(out, segment_size)
    for p in payloads:
        write_len(out, len(p))
        out.write(p)
    write_len(out, 0)
    return out.getvalue()


def test_distributed_world2_gloo(tmp_path):
    """Two processes under gloo (torchrun's environment variables): rank 0
    owns segments 0, 2, 4 and rank 1 segments 1, 3, both short of a batch
    of four, so every payload is encode_segment_staged's."""
    seg = 1 << 14
    data = make_text_like(np.random.default_rng(0xD157), 5 * seg - 3000)
    src, out = tmp_path / "in.bin", tmp_path / "out.orzt"
    src.write_bytes(data)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, ORZ_REPO=ROOT, ORZ_IN=str(src),
                   ORZ_OUT=str(out), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   OTZ2_SCHEDULE=SCHEDULE)
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, cwd=ROOT))
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr.decode()[-2000:]
    comp = out.read_bytes()
    segments = [data[i:i + seg] for i in range(0, len(data), seg)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OTZ2_SCHEDULE", SCHEDULE)
        want = [tp.encode_segment_staged(s, 2, device="cpu")
                for s in segments]
    assert comp == _container(segments, want, seg)
    assert tc.torch_decode_bytes(comp) == data


def test_distributed_world1_stripes(tmp_path, schedule):
    """One process, no group: a full run of four segments goes through the
    batched chain, the short tail through the staged encoder; nothing is
    gathered."""
    seg = 1 << 12
    data = make_text_like(np.random.default_rng(0x57), 5 * seg - 1000)
    src, out = tmp_path / "in.bin", tmp_path / "out.orzt"
    src.write_bytes(data)
    assert td.process_info() == (0, 1)
    assert not td.maybe_initialize(device="cpu")  # nothing asks for one
    td.distributed_encode_file(str(src), str(out), level=2,
                               segment_size=seg, device="cpu")
    segments = [data[i:i + seg] for i in range(0, len(data), seg)]
    want = tb.encode_segments_batch(segments[:4], 2, device="cpu") + [
        tp.encode_segment_staged(segments[4], 2, device="cpu")]
    assert out.read_bytes() == _container(segments, want, seg)


def test_per_segment_env_matches_tpu_encode(monkeypatch):
    """ORZ_PER_SEGMENT=1: every segment through the staged encoder, two
    threads, in both packages (l1, 4 KiB segments)."""
    from orz_tpu_torch.tools.parity_data import stream_digests

    monkeypatch.setenv("ORZ_PER_SEGMENT", "1")
    data = make_text_like(np.random.default_rng(0x9E5), 3 * 4096 + 700)
    rec = expect("per-segment-l1", data)
    got = tc.torch_encode_bytes(data, level=1, num_streams=2,
                                segment_size=4096, device="cpu")
    assert stream_digests(got) == rec["stream"]
    segments = [data[i:i + 4096] for i in range(0, len(data), 4096)]
    assert got == _container(
        segments, [tp.encode_segment_staged(s, 1, device="cpu")
                   for s in segments], 4096)
    assert tc.torch_decode_bytes(got) == data


def test_parallel_entry_points_need_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = tmp_path / "in.bin"
    src.write_bytes(b"abc" * 100)
    for call in (lambda: tm.blocks_mesh(),
                 lambda: tm.mesh_encode_segments_staged([b"abc"]),
                 lambda: tm.mesh_encode_segments([b"abc"]),
                 lambda: td.encode_striped([b"abc"]),
                 lambda: td.distributed_encode_file(
                     str(src), str(tmp_path / "out.orzt"))):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert not (tmp_path / "out.orzt").exists()
