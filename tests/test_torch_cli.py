"""The port's command line (``orz_tpu_torch/cli.py``) and its
``--checkpoint`` (``orz_tpu_torch/checkpoint.py``), on the CPU.

``main([...], device="cpu")`` runs the CLI on the CPU.  Its ORZT files are
held to ``python -m orz_tpu.cli encode -b tpu``'s at l1 and at l2 with
``OTZ2=0`` (the JAX chain, run once per case), and to the port's
``torch_encode_bytes`` at the l2 default (``OTZ2_SCHEDULE=96x1,384x2``,
which ``tests/test_torch_l2.py`` holds to the JAX chain); they decode
through the CLI.  Segments are cut to SEG = 32 KiB in both CLIs, so three
full segments at ``-p 2`` make two batches of one (B=2, cap 1<<15) shape
bucket.  A ``--checkpoint`` encode, fresh or resumed after a crash, is
byte-identical to the plain encode.  All outputs are bytes: tolerance 0.
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
from tests.conftest import make_binary_like, make_text_like

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = 1 << 15


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0xC11)
    return make_text_like(rng, 2 * SEG) + make_binary_like(rng, SEG)


@pytest.fixture
def files(tmp_path, data):
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    return src, tmp_path


@pytest.fixture
def small_segments(monkeypatch):
    """SEG-byte segments in both CLIs' encode paths."""
    from orz_tpu.device import container as jc

    for k in ("OTZ2", "OTZ2_SCHEDULE", "OTZ2_ITERS", "OTZ2_SHIFTS",
              "ORZ_PER_SEGMENT"):
        monkeypatch.delenv(k, raising=False)
    for mod, name in ((tc, "torch_encode"), (jc, "tpu_encode"),
                      (checkpoint, "checkpointed_torch_encode")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), segment_size=SEG))


def _run(argv) -> int:
    return cli.main([str(a) for a in argv], device="cpu")


def _decoded(path, tmp_path) -> bytes:
    out = tmp_path / "back.bin"
    assert _run(["decode", "-s", "-b", "gpu", path, out]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("level,otz2", [(1, None), (2, "0")])
def test_cli_matches_jax_cli(files, data, small_segments, monkeypatch, level,
                             otz2):
    from orz_tpu.cli import main as jax_main

    src, tmp = files
    if otz2 is not None:
        monkeypatch.setenv("OTZ2", otz2)
    ours, theirs = tmp / "ours.orz", tmp / "theirs.orz"
    assert _run(["encode", "-s", "-l", level, "-b", "gpu", "-p", 2, src,
                 ours]) == 0
    assert jax_main(["encode", "-s", "-l", str(level), "-b", "tpu", "-p",
                     "2", str(src), str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
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
                                       written):
    """Three full segments and a short one at -p 2 make the batches (0, 1)
    and (2, 3).  A crash in the second batch's encode call (resume at a
    batch boundary), or in the sidecar save after segment 1's or segment
    3's frame (resume in the middle of a batch, the second time at the
    short tail): the sidecar points at the next unwritten segment, and the
    resumed file equals the plain encode.  A resume in the middle of a
    batch groups the segments after it otherwise than the uninterrupted run
    did (at the tail: segment 3 alone, in its own smaller bucket), and at
    l2 a batch also shares MID2's item cap and its anomalous-demotion
    branch; a segment's bytes must depend on none of them."""
    if level == 2:
        monkeypatch.setenv("OTZ2_SCHEDULE", "96x1,384x2")
    data = data + data[:1000]
    src, tmp = tmp_path / "in.bin", tmp_path
    src.write_bytes(data)
    out, ck = tmp / "out.orz", tmp / "state.json"
    calls = {"n": 0}
    if at == "encode":
        target, name = tc, "encode_segments_batch"
    else:  # saves: the header's, then one per segment
        target, name = checkpoint.CheckpointState, "save"
    real = getattr(target, name)

    def crashing(*args, **kw):
        calls["n"] += 1
        if calls["n"] == crash_at:
            raise _Crash("simulated kill")
        return real(*args, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(target, name, crashing)
        with pytest.raises(_Crash):
            _checkpoint_run(src, out, ck, level)
    st = json.loads(ck.read_text())
    assert st["magic"] == tc.TPU_MAGIC.hex() and st["segment_size"] == SEG
    assert (st["n_segments"], st["src_off"]) == (written, written * SEG)
    with open(out, "ab") as f:  # resume must truncate what lies past it
        f.write(b"GARBAGE-PAST-CHECKPOINT")
    assert _checkpoint_run(src, out, ck, level) == 0
    assert out.read_bytes() == tc.torch_encode_bytes(
        data, level=level, batch=2, segment_size=SEG, device="cpu")
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
