"""The port's command line (``orz_tpu_torch/cli.py``) and its
``--checkpoint`` (``orz_tpu_torch/checkpoint.py``), on the CPU.

``main([...], device="cpu")`` runs the CLI on the CPU.  Its ORZT files are
held to ``python -m orz_tpu.cli encode -b tpu``'s at l1 and at l2 with
``OTZ2=0`` (recorded in ``tests/torch_jax_records.json``, records
``cli-l1``, ``cli-l2-OTZ2=0`` and ``checkpoint-l2``, written by
``tests/torch_parity_ref.py``), and to the port's
``torch_encode_bytes`` at the l2 default (``OTZ2_SCHEDULE=96x1,384x2``,
which ``tests/test_torch_l2.py`` holds to the JAX chain); they decode
through the CLI.  Segments are cut to SEG = 32 KiB in both CLIs, so three
full segments at ``-p 2`` make two batches of one (B=2, cap 1<<15) shape
bucket.  A ``--checkpoint`` encode (each segment through the staged
encoder, as ``-b tpu --checkpoint`` does), fresh or resumed after a crash,
is byte-identical at l1 to the plain encode, and at l2 (on SEG2 = 4 KiB
segments) to ``python -m orz_tpu.cli encode -b tpu --checkpoint``'s file.
All outputs are bytes (files compared by ``stream_digests``): tolerance 0.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from orz_tpu_torch import checkpoint, cli
from orz_tpu_torch.device import container as tc
from orz_tpu_torch.device import pipeline as tp
from orz_tpu_torch.tools.parity_data import stream_digests
from tests.conftest import make_binary_like, make_text_like
from tests.torch_parity_ref import expect

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = 1 << 15
SEG2 = 1 << 12  # the l2 --checkpoint cases' segments
SCHEDULE = "96x1,384x2"


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0xC11)
    return make_text_like(rng, 2 * SEG) + make_binary_like(rng, SEG)


@pytest.fixture
def files(tmp_path, data):
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    return src, tmp_path


def _segments(monkeypatch, seg: int) -> None:
    """seg-byte segments in the CLI's encode paths, --checkpoint's too (the
    recorded JAX files had the same patch: ``patches.segment_size``)."""
    monkeypatch.setattr(tc, "torch_encode", functools.partial(
        tc.torch_encode, segment_size=seg))
    monkeypatch.setattr(tc, "DEFAULT_SEGMENT_SIZE", seg)


@pytest.fixture
def small_segments(monkeypatch):
    """SEG-byte segments in the CLI's encode paths."""
    for k in ("OTZ2", "OTZ2_SCHEDULE", "OTZ2_ITERS", "OTZ2_SHIFTS",
              "ORZ_PER_SEGMENT"):
        monkeypatch.delenv(k, raising=False)
    _segments(monkeypatch, SEG)


@pytest.fixture(scope="module")
def jax_checkpoint_l2(data):
    """The ``stream_digests`` of JAX's ``encode -b tpu -l 2 -p 2
    --checkpoint`` file of data2 (three SEG2 segments and a short one),
    recorded (``checkpoint-l2``), and data2."""
    data2 = data[:3 * SEG2] + data[:1000]
    with pytest.MonkeyPatch.context() as mp:
        for k in ("OTZ2", "OTZ2_ITERS", "OTZ2_SHIFTS", "ORZ_PER_SEGMENT"):
            mp.delenv(k, raising=False)
        mp.setenv("OTZ2_SCHEDULE", SCHEDULE)
        want = expect("checkpoint-l2", data2, {"segment_size": SEG2})
    return want["stream"], data2


def _run(argv) -> int:
    return cli.main([str(a) for a in argv], device="cpu")


def _decoded(path, tmp_path) -> bytes:
    out = tmp_path / "back.bin"
    assert _run(["decode", "-s", "-b", "gpu", path, out]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("level,otz2", [(1, None), (2, "0")])
def test_cli_matches_jax_cli(files, data, small_segments, monkeypatch, level,
                             otz2):
    src, tmp = files
    if otz2 is not None:
        monkeypatch.setenv("OTZ2", otz2)
    name = "cli-l1" if otz2 is None else f"cli-l{level}-OTZ2={otz2}"
    want = expect(name, data, {"segment_size": SEG})["stream"]
    ours = tmp / "ours.orz"
    assert _run(["encode", "-s", "-l", level, "-b", "gpu", "-p", 2, src,
                 ours]) == 0
    assert stream_digests(ours.read_bytes()) == want
    assert _decoded(ours, tmp) == data


def test_cli_l2_default_matches_torch_encode_bytes(files, data,
                                                   small_segments,
                                                   monkeypatch):
    src, tmp = files
    monkeypatch.setenv("OTZ2_SCHEDULE", "96x1,384x2")
    ours = tmp / "ours.orz"
    assert _run(["encode", "-s", "-p", 2, src, ours]) == 0  # level 2
    comp = ours.read_bytes()
    assert comp == tc.torch_encode_bytes(data, level=2, num_streams=2,
                                         segment_size=SEG, device="cpu")
    assert comp != tc.torch_encode_bytes(data, level=2, rings_mode=0,
                                         batch=2, segment_size=SEG,
                                         device="cpu"), "not OTZ2"
    assert _decoded(ours, tmp) == data


def test_torch_encode_num_streams_is_an_alias_of_batch():
    with pytest.raises(ValueError, match="alias of batch"):
        tc.torch_encode_bytes(b"abc", num_streams=2, batch=3, device="cpu")


def _plain_l1(data) -> bytes:
    return tc.torch_encode_bytes(data, level=1, batch=2, segment_size=SEG,
                                 device="cpu")


def _checkpoint_run(src, out, ck, level=1) -> int:
    return _run(["encode", "-s", "-l", level, "-p", 2, "--checkpoint", ck,
                 src, out])


def test_checkpoint_fresh_equals_plain_encode(files, data, small_segments):
    src, tmp = files
    out, ck = tmp / "out.orz", tmp / "state.json"
    assert _checkpoint_run(src, out, ck) == 0
    assert out.read_bytes() == _plain_l1(data)
    assert not ck.exists()  # sidecar removed on success


class _Crash(BaseException):
    """A kill: not caught by the batch retry or by the CLI."""


def test_checkpoint_l2_matches_jax_checkpoint(tmp_path, small_segments,
                                              monkeypatch, jax_checkpoint_l2):
    want, data2 = jax_checkpoint_l2
    monkeypatch.setenv("OTZ2_SCHEDULE", SCHEDULE)
    _segments(monkeypatch, SEG2)
    src, out, ck = tmp_path / "in.bin", tmp_path / "out.orz", tmp_path / "c"
    src.write_bytes(data2)
    assert _checkpoint_run(src, out, ck, 2) == 0
    assert stream_digests(out.read_bytes()) == want
    assert not ck.exists()
    assert _decoded(out, tmp_path) == data2


@pytest.mark.parametrize("level,at,crash_at,written", [
    pytest.param(1, "encode", 2, 2, id="encode"),
    pytest.param(1, "save", 3, 1, id="save"),
    pytest.param(1, "save", 5, 3, id="save-tail"),
    pytest.param(2, "encode", 2, 2, id="l2-encode"),
    pytest.param(2, "save", 3, 1, id="l2-save"),
    pytest.param(2, "save", 5, 3, id="l2-save-tail"),
])
def test_checkpoint_resume_after_crash(tmp_path, data, small_segments,
                                       monkeypatch, level, at, crash_at,
                                       written, request):
    """Three full segments and a short one, encoded one by one at -p 2 (two
    threads).  A crash in the encode of segment 2 (its frame and those
    after it unwritten, though segment 3 may have been encoded), or in the
    sidecar save after segment 1's or segment 3's frame (the second time
    at the short tail): the sidecar points at the next unwritten segment,
    and the resumed file equals the uninterrupted one, at l1 the plain
    encode's (SEG segments) and at l2 JAX's --checkpoint file (SEG2
    segments)."""
    if level == 2:
        want, data = request.getfixturevalue("jax_checkpoint_l2")
        monkeypatch.setenv("OTZ2_SCHEDULE", SCHEDULE)
        seg = SEG2
        _segments(monkeypatch, seg)
    else:
        seg = SEG
        data = data + data[:1000]
        want = stream_digests(tc.torch_encode_bytes(
            data, level=1, batch=2, segment_size=seg, device="cpu"))
    segments = [data[i:i + seg] for i in range(0, len(data), seg)]
    assert len(segments) == 4 and len(set(segments)) == 4
    src, tmp = tmp_path / "in.bin", tmp_path
    src.write_bytes(data)
    out, ck = tmp / "out.orz", tmp / "state.json"
    calls = {"n": 0}
    if at == "encode":  # the CLI looks the encoder up at each run
        target, name = tp, "encode_segment_staged"
    else:  # saves: the header's, then one per segment
        target, name = checkpoint.CheckpointState, "save"
    real = getattr(target, name)

    def crashing(*args, **kw):
        calls["n"] += 1
        if (args[0] == segments[crash_at] if at == "encode"
                else calls["n"] == crash_at):
            raise _Crash("simulated kill")
        return real(*args, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(target, name, crashing)
        with pytest.raises(_Crash):
            _checkpoint_run(src, out, ck, level)
    st = json.loads(ck.read_text())
    assert st["magic"] == tc.TPU_MAGIC.hex() and st["segment_size"] == seg
    assert (st["n_segments"], st["src_off"]) == (written, written * seg)
    with open(out, "ab") as f:  # resume must truncate what lies past it
        f.write(b"GARBAGE-PAST-CHECKPOINT")
    assert _checkpoint_run(src, out, ck, level) == 0
    assert stream_digests(out.read_bytes()) == want
    assert not ck.exists()


def test_checkpoint_ignores_mismatched_sidecar(files, data, small_segments):
    src, tmp = files
    out, ck = tmp / "out.orz", tmp / "state.json"
    out.write_bytes(b"x" * 100)
    checkpoint.CheckpointState(str(ck)).save(tc.TPU_MAGIC, 2 * SEG, 10, 10, 1)
    assert _checkpoint_run(src, out, ck) == 0
    assert out.read_bytes() == _plain_l1(data)
    checkpoint.CheckpointState(str(ck)).save(b"ORZP\x01", SEG, 10, 10, 1)
    assert _checkpoint_run(src, out, ck) == 0
    assert out.read_bytes() == _plain_l1(data)


def test_cli_needs_cuda(files, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src, tmp = files
    out = tmp / "out.orz"
    for argv in (["encode", "-s", src, out], ["decode", "-s", src, out]):
        assert cli.main([str(a) for a in argv]) == 1
        assert "needs a CUDA GPU" in capsys.readouterr().err
    assert not out.exists()


def _host_streams(data):
    """An orz-compatible stream and an ORZP container of the JAX package's
    golden host backend."""
    import io

    from orz_tpu import pcontainer
    from orz_tpu.cfg import cfg_from_level
    from orz_tpu.container import GoldenBackend, encode_bytes

    cfg, backend = cfg_from_level(1), GoldenBackend()
    par = io.BytesIO()
    pcontainer.pencode(io.BytesIO(data), par, cfg, backend, num_streams=2,
                       segment_size=1 << 10)
    return {"orz-compatible": encode_bytes(data, cfg, backend),
            "ORZP": par.getvalue()}


def test_cli_errors(files, data, capsys):
    src, tmp = files
    out = tmp / "out.bin"
    assert _run(["encode", "-s", "-l", 4, src, out]) == 1
    assert "invalid level: 4" in capsys.readouterr().err
    assert _run(["encode", "-s", "--checkpoint", tmp / "ck.json", src]) == 1
    assert "requires file paths" in capsys.readouterr().err
    with pytest.raises(SystemExit):  # argparse: tpu is the JAX package's
        _run(["encode", "-s", "-b", "tpu", src, out])
    capsys.readouterr()

    rng = np.random.default_rng(7)
    garbage = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    cases = {"garbage": (garbage, "decode failed"),
             "ORZT garbage": (tc.TPU_MAGIC + garbage, "decode failed")}
    for name, (stream, message) in cases.items():
        path = tmp / "stream.bin"
        path.write_bytes(stream)
        assert _run(["decode", "-s", path, out]) == 1, name
        err = capsys.readouterr().err
        assert message in err, (name, err)
    # the JAX package's host streams decode under -b gpu (through auto)
    for name, stream in _host_streams(data[:2000]).items():
        path = tmp / "stream.bin"
        path.write_bytes(stream)
        assert _run(["decode", "-s", path, out]) == 0, name
        assert out.read_bytes() == data[:2000], name


def test_cli_stdio_subprocess_never_imports_jax(data):
    """encode from stdin to stdout (progress on stderr) and decode back, in
    a fresh interpreter that loads neither jax nor the JAX package."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from orz_tpu_torch.cli import main\n"
        "rc = main(sys.argv[1:], device='cpu')\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'orz_tpu' or m.startswith('orz_tpu.')]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("OTZ", "ORZ"))}
    env["PYTHONPATH"] = ROOT
    seg = data[:20000]

    def run(*argv, stdin):
        res = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT,
                             env=env, input=stdin, capture_output=True,
                             timeout=300)
        assert res.returncode == 0, res.stderr[-2000:].decode()
        return res

    enc = run("encode", "-l", "1", stdin=seg)
    assert enc.stdout.startswith(tc.TPU_MAGIC)
    assert b"statistics:" in enc.stderr
    dec = run("decode", stdin=enc.stdout)
    assert dec.stdout == seg
    assert b"statistics:" in dec.stderr
    # the host codec: an orz-compatible stream, decoded under -b gpu
    enc = run("encode", "-b", "native", "-l", "1", stdin=seg)
    assert enc.stdout[:5] not in (tc.TPU_MAGIC, b"ORZP\x01")
    assert run("decode", stdin=enc.stdout).stdout == seg
