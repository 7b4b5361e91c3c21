"""The torch port's OTZ1 slice against the JAX batched chain, on the CPU,
and the port's separation from the JAX package.

Stage parity: FRONT, MID and BACK outputs equal the JAX programs'
(``orz_tpu.device.batch`` b_front_jit / b_mid_jit / b_back_jit) on the same
padded (B=2, cap=1<<15) buffers.  Stream parity: payloads are
byte-identical to ``encode_segments_batch(..., rings_mode=0)`` at l0, l1
and l2 and to the sequential oracle ``refcodec.encode_segment_ref`` at l1
and l2, and decode through the native decoder.  All outputs are integers:
tolerance 0.  The port's sources import nothing of ``orz_tpu``, and an
encode and decode through the port load no module of it.
"""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from orz_tpu_torch.device.host import _bucket, pad_batch
from orz_tpu_torch.ops import batched as ob
from orz_tpu_torch.spec import CHUNK_INPUT_DEFAULT, n_chunks_for
from tests.conftest import make_binary_like, make_text_like

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 1 << 15
DEPTH = 32  # level 2's depth: the b_front_jit program test_batch_device runs
C_MAX = n_chunks_for(CAP, CHUNK_INPUT_DEFAULT)


@pytest.fixture(scope="module")
def segs():
    rng = np.random.default_rng(0x51CE)
    return [make_text_like(rng, 30000), make_binary_like(rng, 30000)]


@pytest.fixture(scope="module")
def torch_chain(segs):
    bufs, lens = (torch.from_numpy(a) for a in pad_batch(segs, CAP))
    front = ob.front_body_b(bufs, lens, DEPTH)
    st, ni, pk1, bq, bro, bufs, _ = front
    m_cap = _bucket(int(ni.max()), 1 << 14, 2)
    items, r1, rounds = ob.mid_body_b(st, ni, pk1, bq, bro, bufs, lens, m_cap)
    out = ob.back_body_b(items, CHUNK_INPUT_DEFAULT, C_MAX)
    return front, (items, r1, rounds), out


@pytest.fixture(scope="module")
def jax_chain(segs):
    import jax.numpy as jnp

    from orz_tpu.device.batch import b_back_jit, b_front_jit, b_mid_jit
    from orz_tpu.ops.symrank_pallas import RB_BLK

    bufs, lens = (jnp.asarray(a) for a in pad_batch(segs, CAP))
    front = b_front_jit(bufs, lens, DEPTH)
    st, ni, pk1, bq, bro, bufs_d, _ = front
    m_cap = _bucket(int(np.asarray(ni).max()), 1 << 14, 2)
    items, r1, rounds = b_mid_jit(st, ni, pk1, bq, bro, bufs_d, lens, m_cap)
    front = tuple(np.asarray(a) for a in front)
    mid = (tuple(np.asarray(a) for a in items), np.asarray(r1),
           np.asarray(rounds))
    r1_h, r_h = mid[1], mid[2]
    out = b_back_jit(items, CHUNK_INPUT_DEFAULT, C_MAX,
                     _bucket(max(int(r1_h.max()), 1), RB_BLK),
                     _bucket(max(int((r_h - r1_h).max()), 1), 4 * RB_BLK))
    return front, mid, (np.asarray(out.meta), np.asarray(out.words))


def test_front_body_matches_jax(torch_chain, jax_chain):
    starts, ni, pk1, bq, bro, _, mask = torch_chain[0]
    j_starts, j_ni, j_pk1, j_bq, j_bro, _, j_mask = jax_chain[0]
    np.testing.assert_array_equal(ni.numpy(), j_ni)
    for b in range(len(j_ni)):
        np.testing.assert_array_equal(starts[b, :j_ni[b]].numpy(),
                                      j_starts[b, :j_ni[b]])
    for got, want in ((pk1, j_pk1), (bq, j_bq), (bro, j_bro),
                      (mask, j_mask)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_mid_body_matches_jax(torch_chain, jax_chain):
    items, r1, rounds = torch_chain[1]
    j_items, j_r1, j_rounds = jax_chain[1]
    assert len(items) == len(j_items)
    for name, got, want in zip(ob.Items._fields, items, j_items):
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_array_equal(r1.numpy(), j_r1)
    np.testing.assert_array_equal(rounds.numpy(), j_rounds)


def test_back_body_matches_jax(torch_chain, jax_chain):
    out = torch_chain[2]
    j_meta, j_words = jax_chain[2]
    meta = out.meta.numpy()
    np.testing.assert_array_equal(meta, j_meta)
    assert out.words.shape == j_words.shape
    for b in range(meta.shape[0]):
        k = int(meta[b, 3])  # total_words
        np.testing.assert_array_equal(
            out.words[b, :k].numpy().astype(np.uint32), j_words[b, :k])


@pytest.mark.parametrize("level", [0, 1, 2])
def test_payloads_match_jax(segs, level):
    from orz_tpu.device.batch import encode_segments_batch as jax_encode
    from orz_tpu.native.otz import decode_segment_native
    from orz_tpu_torch.device.batch import encode_segments_batch

    got = encode_segments_batch(segs, level, rings_mode=0, device="cpu")
    want = jax_encode(segs, level, rings_mode=0)
    for seg, payload, ref in zip(segs, got, want):
        assert payload == ref
        assert decode_segment_native(payload) == seg


@pytest.mark.parametrize("level", [1, 2])
def test_payloads_match_oracle(segs, level):
    from orz_tpu.device.refcodec import encode_segment_ref
    from orz_tpu_torch.device.batch import encode_segments_batch

    got = encode_segments_batch(segs, level, rings_mode=0, device="cpu")
    for seg, payload in zip(segs, got):
        assert payload == encode_segment_ref(seg, level, rings_mode=0)


def test_container_roundtrip_three_segments():
    from orz_tpu.device.container import tpu_decode_bytes
    from orz_tpu_torch.device import container

    rng = np.random.default_rng(0xC0A7)
    data = make_text_like(rng, 50000) + make_binary_like(rng, 30000)
    container.segment_retries = 0
    comp = container.torch_encode_bytes(data, level=1, segment_size=1 << 15,
                                        device="cpu")
    assert container.segment_retries == 0
    assert tpu_decode_bytes(comp) == data
    assert container.torch_decode_bytes(comp) == data


def test_empty_segment_framing(segs):
    from orz_tpu.device.refcodec import encode_segment_ref
    from orz_tpu_torch.device.batch import encode_segments_batch

    got = encode_segments_batch([b"", segs[0][:5000]], 1, device="cpu")
    assert got[0] == encode_segment_ref(b"", 1, rings_mode=0)
    assert got[1] == encode_segment_ref(segs[0][:5000], 1, rings_mode=0)


def test_cuda_encode_raises_without_cuda(segs):
    from orz_tpu_torch.device.batch import encode_segments_batch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_segments_batch(segs, 1, device="cuda")


def test_port_never_imports_jax():
    """A level-2 encode (the default OTZ2 schedule) and its decode load
    neither jax nor any module of the JAX package."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from orz_tpu_torch.device.container import (\n"
        "    torch_decode_bytes, torch_encode_bytes)\n"
        "data = bytes(range(256)) * 8 + b'the port runs on torch ' * 90\n"
        "data = data[:4096]\n"
        "comp = torch_encode_bytes(data, device='cpu')\n"
        "assert comp != torch_encode_bytes(data, rings_mode=0,\n"
        "                                  device='cpu'), 'not OTZ2'\n"
        "assert torch_decode_bytes(comp) == data\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'orz_tpu' or m.startswith('orz_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("OTZ", "ORZ"))}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_port_sources_never_import_orz_tpu():
    paths = glob.glob(os.path.join(ROOT, "orz_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(paths) > 10
    rel = {os.path.relpath(p, ROOT) for p in paths}
    for host in ("native/__init__.py", "golden/lz.py", "container.py",
                 "pcontainer.py", "cli.py", "benchtool.py"):
        assert os.path.join("orz_tpu_torch", host) in rel, host
    bad = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {m}"
                    for m in names
                    if m.split(".")[0] in ("orz_tpu", "jax")]
    assert not bad, bad
