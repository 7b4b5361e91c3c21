"""The port's host codecs equal the JAX package's, on the CPU.

``orz_tpu_torch`` carries copies of the JAX package's host codec stack:
``cfg.py``, ``constants.py`` (the ORZ format's constants, apart from the
OTZ ones in ``spec.py``), ``ioutil.py``, the bit reader in ``bitio.py``,
``golden/``, ``native/`` (the shared ``csrc/orz_core.cpp``), the orz stream
container (``container.py``), the ORZP container (``pcontainer.py``), the
host ``--checkpoint`` (``checkpoint.py``), the public API
(``__init__.py``), the command line's host backends (``cli.py``) and
``benchtool.py``.  Each is held to its original on the same inputs, made
from a numpy seed.  Every output is bytes: tolerance 0.  Golden inputs stay
at 16 KiB or less (the golden model encodes at about 60 KB/s).
"""

import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import orz_tpu
import orz_tpu.constants as jconst
from orz_tpu import cli as jcli
from orz_tpu import pcontainer as jpc
from orz_tpu.container import GoldenBackend as JGolden
from orz_tpu.golden.bitio import BitDecoder as JBitDecoder
from orz_tpu.golden.bitio import BitEncoder as JBitEncoder
from orz_tpu.native import NativeBackend as JNative

import orz_tpu_torch as port
from orz_tpu_torch import benchtool, checkpoint, cli, native
from orz_tpu_torch import constants as tconst
from orz_tpu_torch import pcontainer as tpc
from orz_tpu_torch import spec as tspec
from orz_tpu_torch.bitio import BitDecoder, BitEncoder
from orz_tpu_torch.container import GoldenBackend
from orz_tpu_torch.native import NativeBackend
from tests.conftest import make_binary_like, make_text_like

torch.set_num_threads(2)

SEG = 1 << 14  # ORZP segments in these tests (the default is 32 MiB)


@pytest.fixture(scope="module")
def mixed():
    """200 KB of text-like and binary-like data."""
    rng = np.random.default_rng(0x40C)
    return make_text_like(rng, 120_000) + make_binary_like(rng, 80_000)


@pytest.fixture(scope="module")
def small():
    """16 KiB text-like and 8 KiB binary-like, for the golden model."""
    rng = np.random.default_rng(0x601D)
    return {"text": make_text_like(rng, 16 << 10),
            "binary": make_binary_like(rng, 8 << 10)}


@pytest.fixture(scope="module")
def backends():
    return {"port": (NativeBackend(), GoldenBackend()),
            "jax": (JNative(), JGolden())}


# --- pins: cfg, constants, bit reader ----------------------------------------

CONSTANTS = [
    "LZ_BLOCK_SIZE", "LZ_CHUNK_SIZE", "LZ_MATCH_MAX_LEN", "LZ_MATCH_MIN_LEN",
    "SBVEC_SENTINEL_LEN", "SBVEC_PREMATCH_LEN", "LZ_BLOCK_FRESH_LEN",
    "LZ_TBUF_CAPACITY", "LZ_MF_BUCKET_ITEM_SIZE",
    "LZ_MF_BUCKET_ITEM_HASH_SIZE", "LZ_NUM_BUCKETS", "LZ_ROID_SIZE",
    "LZ_LENID_SIZE", "SYMRANK_NUM_SYMBOLS", "WORD_SYMBOL",
    "SYMRANK_NUM_CONTEXTS", "WORD_TABLE_SIZE", "HUFFMAN_MAX_CODE_LEN",
    "HASH_DWORD_MULS", "HASH_DWORD_ADDS", "LZ_ROID_ENCODING_ARRAY",
    "LZ_ROID_DECODING_ARRAY",
]


@pytest.mark.parametrize("name", CONSTANTS)
def test_orz_constant_matches_original(name):
    assert getattr(tconst, name) == getattr(jconst, name)


def test_orz_constants_complete_and_apart_from_otz():
    def names(mod):
        return {n for n in vars(mod) if n.isupper()}

    assert names(tconst) == names(jconst) == set(CONSTANTS)
    assert tconst.build_roid_tables(4094) == jconst.build_roid_tables(4094)
    assert tconst.build_roid_tables(32766) == jconst.build_roid_tables(32766)
    # the OTZ format's values under the same names differ: two modules
    assert (tconst.SYMRANK_NUM_SYMBOLS, tspec.SYMRANK_NUM_SYMBOLS) == (389, 431)
    assert tconst.WORD_SYMBOL != tspec.WORD_SYMBOL
    assert len(tconst.LZ_ROID_DECODING_ARRAY) != len(tspec.ROID_DEC)


def test_level_presets_match():
    from dataclasses import astuple

    def presets(mod):
        return {k: astuple(v) for k, v in mod.LEVEL_PRESETS.items()}

    assert presets(port) == presets(orz_tpu)
    assert port.LEVEL_PRESETS[3] == port.LEVEL_PRESETS[2]
    for level in (0, 1, 2, 3):
        assert astuple(port.cfg_from_level(level)) \
            == astuple(orz_tpu.cfg_from_level(level))
    assert astuple(port.LZCfg()) == astuple(orz_tpu.LZCfg())
    with pytest.raises(ValueError, match="invalid level: 4"):
        port.cfg_from_level(4)


def test_bit_decoder_matches():
    enc = JBitEncoder()
    rng = np.random.default_rng(0xB17)
    ops = []
    for step in range(400):
        op = step % 3
        if op == 0:
            arg = int(rng.integers(0, 1 << 40))
            enc.encode_varint(arg)
        elif op == 1:
            arg = int(rng.integers(1, 33))
            enc.encode_raw_bits(int(rng.integers(0, 1 << arg)), arg)
        else:
            arg = rng.integers(0, 16, 389).tolist()
            enc.encode_huffman_table(arg)
        ops.append((op, arg))
    stream = enc.finish()
    ours, theirs = BitDecoder(stream), JBitDecoder(stream)
    for op, arg in ops:
        if op == 0:
            got = [dec.decode_varint() for dec in (ours, theirs)]
            assert got == [arg, arg]
        elif op == 1:
            got = [dec.decode_raw_bits(arg) for dec in (ours, theirs)]
        else:
            got = [dec.decode_huffman_table() for dec in (ours, theirs)]
            assert got[0][1] == max(arg)
        assert got[0] == got[1]
        assert (ours.pos, ours._val, ours._len) == \
            (theirs.pos, theirs._val, theirs._len)
    with pytest.raises(ValueError, match="varint overflow"):
        BitDecoder(b"\xff" * 32).decode_varint()


def test_huffman_sym_matches():
    from orz_tpu.golden.huffman import canonical_encodings

    lens = [0, 3, 3, 2, 2, 3, 3, 0, 4, 4] + [0] * 6
    codes = canonical_encodings(lens)
    ours, theirs = BitEncoder(), JBitEncoder()
    for sym in [1, 2, 3, 4, 5, 6, 8, 9, 3, 3, 1]:
        ours.encode_huffman_sym(codes, sym)
        theirs.encode_huffman_sym(codes, sym)
    assert ours.finish() == theirs.finish()


# --- golden ---------------------------------------------------------------------


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("kind", ["text", "binary"])
def test_golden_matches_original(small, backends, kind, level):
    data = small[kind]
    ours = port.encode_bytes(data, port.cfg_from_level(level),
                             backends["port"][1])
    theirs = orz_tpu.encode_bytes(data, orz_tpu.cfg_from_level(level),
                                  backends["jax"][1])
    assert ours == theirs
    assert port.decode_bytes(theirs, backends["port"][1]) == data
    assert orz_tpu.decode_bytes(ours, backends["jax"][1]) == data


# --- native ---------------------------------------------------------------------


def test_native_shares_the_library_build():
    from orz_tpu.native import _build_library

    assert native._build_library() == _build_library()


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_native_matches_original(mixed, backends, level):
    ours = port.encode_bytes(mixed, port.cfg_from_level(level),
                             backends["port"][0])
    theirs = orz_tpu.encode_bytes(mixed, orz_tpu.cfg_from_level(level),
                                  backends["jax"][0])
    assert ours == theirs
    assert port.decode_bytes(theirs, backends["port"][0]) == mixed
    assert orz_tpu.decode_bytes(ours, backends["jax"][0]) == mixed


@pytest.mark.parametrize("level", [0, 2])
def test_native_matches_port_golden(small, backends, level):
    nb, gb = backends["port"]
    cfg = port.cfg_from_level(level)
    data = small["text"]
    comp = port.encode_bytes(data, cfg, nb)
    assert comp == port.encode_bytes(data, cfg, gb)
    assert port.decode_bytes(comp, gb) == port.decode_bytes(comp, nb) == data


@pytest.mark.parametrize("data", [
    b"", b"a", b"ab", b"\x00" * 100, b"abcd" * 2500, bytes(range(256)) * 10,
], ids=["empty", "1", "2", "zeros", "abcd", "range"])
def test_native_edge_cases(backends, data):
    nb, gb = backends["port"]
    cfg = port.cfg_from_level(0)
    comp = port.encode_bytes(data, cfg, nb)
    assert comp == orz_tpu.encode_bytes(data, orz_tpu.cfg_from_level(0),
                                        backends["jax"][0])
    assert port.decode_bytes(comp, nb) == data
    if len(data) <= 2560:
        assert comp == port.encode_bytes(data, cfg, gb)


def test_native_truncated_stream_raises(small, backends):
    nb, _ = backends["port"]
    comp = port.encode_bytes(small["text"], port.cfg_from_level(0), nb)
    with pytest.raises((ValueError, EOFError)):
        port.decode_bytes(comp[: len(comp) // 3], nb)


# --- ORZP -----------------------------------------------------------------------


def test_pencode_matches_original(mixed, backends):
    ours, theirs = io.BytesIO(), io.BytesIO()
    tpc.pencode(io.BytesIO(mixed), ours, port.cfg_from_level(2),
                backends["port"][0], num_streams=3, segment_size=SEG)
    jpc.pencode(io.BytesIO(mixed), theirs, orz_tpu.cfg_from_level(2),
                backends["jax"][0], num_streams=3, segment_size=SEG)
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue().startswith(tpc.PARALLEL_MAGIC)
    for decode, backend, stream in (
            (tpc.pdecode, backends["port"][0], theirs.getvalue()),
            (jpc.pdecode, backends["jax"][0], ours.getvalue())):
        back = io.BytesIO()
        decode(io.BytesIO(stream), back, backend, num_streams=2)
        assert back.getvalue() == mixed


def test_pencode_empty_and_pipe_encode(backends):
    ours, theirs = io.BytesIO(), io.BytesIO()
    tpc.pencode(io.BytesIO(b""), ours, port.cfg_from_level(1),
                backends["port"][0], num_streams=3)
    jpc.pencode(io.BytesIO(b""), theirs, orz_tpu.cfg_from_level(1),
                backends["jax"][0], num_streams=3)
    assert ours.getvalue() == theirs.getvalue()
    back = io.BytesIO()
    tpc.pdecode(io.BytesIO(ours.getvalue()), back, backends["port"][0])
    assert back.getvalue() == b""
    assert tpc.DEFAULT_SEGMENT_SIZE == jpc.DEFAULT_SEGMENT_SIZE == 1 << 25
    # the host pipe reads no padding: one call per segment, in file order
    data = bytes(range(256)) * 41
    calls = []

    def enc(seg):
        calls.append(len(seg))
        return seg[::-1]

    ours, theirs = io.BytesIO(), io.BytesIO()
    tpc.pipe_encode(io.BytesIO(data), ours, enc, tpc.PARALLEL_MAGIC, 4096, 4)
    assert sorted(calls) == [2304, 4096, 4096]
    jpc.pipe_encode(io.BytesIO(data), theirs, enc, jpc.PARALLEL_MAGIC, 4096, 4)
    assert ours.getvalue() == theirs.getvalue()


# --- public API -----------------------------------------------------------------


def test_default_backend_falls_back_to_golden(monkeypatch):
    assert isinstance(port.default_backend(), NativeBackend)

    def broken():
        raise OSError("g++ not found")

    monkeypatch.setattr(native, "get_library", broken)
    assert isinstance(port.default_backend(), GoldenBackend)
    assert isinstance(cli.get_backend("auto"), GoldenBackend)
    with pytest.raises(OSError):
        cli.get_backend("native")


def test_public_api_matches():
    names = {"encode", "decode", "encode_bytes", "decode_bytes", "LZCfg",
             "LEVEL_PRESETS", "cfg_from_level", "CountRead", "CountWrite",
             "ProgressLogger", "SilentProgressLogger", "SimpleProgressLogger",
             "default_backend"}
    assert names <= set(vars(orz_tpu)) and names <= set(vars(port))
    counted = port.CountRead(io.BytesIO(b"abcdef"))
    buf = bytearray(4)
    assert counted.readinto(buf) == 4 and counted.count() == 4


# --- the command line -----------------------------------------------------------


@pytest.fixture
def small_orzp_segments(monkeypatch):
    """SEG-byte ORZP segments in both CLIs (-p and --checkpoint)."""
    for mod in (jpc, tpc):
        monkeypatch.setattr(mod, "pencode", functools.partial(
            mod.pencode, segment_size=SEG))
        monkeypatch.setattr(mod, "DEFAULT_SEGMENT_SIZE", SEG)


def _port_cli(*argv) -> int:
    return cli.main([str(a) for a in argv], device="cpu")


def _jax_cli(*argv) -> int:
    return jcli.main([str(a) for a in argv])


@pytest.mark.parametrize("parallel", [0, 3], ids=["orz", "orzp"])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("backend", ["native", "golden", "auto"])
def test_cli_matches_jax_cli(tmp_path, mixed, small, small_orzp_segments,
                             backend, level, parallel):
    data = small["text"] if backend == "golden" else mixed
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    ours, theirs = tmp_path / "ours.orz", tmp_path / "theirs.orz"
    par = ["-p", parallel] if parallel else []
    common = ["encode", "-s", "-b", backend, "-l", level, *par, src]
    assert _port_cli(*common, ours) == 0
    assert _jax_cli(*common, theirs) == 0
    comp = ours.read_bytes()
    assert comp == theirs.read_bytes()
    assert comp.startswith(tpc.PARALLEL_MAGIC) == bool(parallel)
    # each package decodes the other's file
    back = tmp_path / "back.bin"
    assert _port_cli("decode", "-s", "-b", backend, theirs, back) == 0
    assert back.read_bytes() == data
    assert _jax_cli("decode", "-s", "-b", backend, ours, back) == 0
    assert back.read_bytes() == data


def test_cli_checkpoint_native_matches_jax_cli(tmp_path, mixed,
                                               small_orzp_segments):
    src = tmp_path / "in.bin"
    src.write_bytes(mixed)
    ours, theirs = tmp_path / "ours.orzp", tmp_path / "theirs.orzp"
    ck = tmp_path / "state.json"
    argv = ["encode", "-s", "-b", "native", "-l", 1, "--checkpoint", ck, src]
    assert _port_cli(*argv, ours) == 0
    assert not ck.exists()
    assert _jax_cli(*argv, theirs) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    plain = io.BytesIO()
    jpc.pencode(io.BytesIO(mixed), plain, orz_tpu.cfg_from_level(1),
                JNative(), num_streams=2, segment_size=SEG)
    assert ours.read_bytes() == plain.getvalue()


class _Crash(BaseException):
    """A kill: not caught by the CLI."""


@pytest.mark.parametrize("at,crash_at,written", [
    pytest.param("encode", 5, None, id="encode"),
    pytest.param("save", 4, 2, id="save"),
    pytest.param("save", 13, 11, id="save-tail"),
])
def test_cli_checkpoint_native_resumes(tmp_path, mixed, small_orzp_segments,
                                       monkeypatch, at, crash_at, written):
    """200 KB in 13 segments of 16 KiB at -p 2: a crash in the fifth
    segment's encode (in a worker), or in the sidecar save after the third
    or the twelfth segment's frame (the saves are the header's, then one a
    segment); the sidecar points at the next unwritten segment, and the
    resumed file equals a fresh one."""
    src = tmp_path / "in.bin"
    src.write_bytes(mixed)
    out, ck = tmp_path / "out.orzp", tmp_path / "state.json"
    argv = ["encode", "-s", "-b", "native", "-l", 1, "-p", 2,
            "--checkpoint", ck, src, out]
    assert _port_cli(*argv) == 0
    fresh = out.read_bytes()
    out.unlink()

    calls = {"n": 0}
    if at == "encode":
        target, name = port.container, "encode_bytes"
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
            _port_cli(*argv)
    st = checkpoint.CheckpointState(str(ck)).load()
    assert st["magic"] == tpc.PARALLEL_MAGIC.hex()
    assert st["segment_size"] == SEG
    if written is not None:
        assert (st["n_segments"], st["src_off"]) == (written, written * SEG)
    assert st["src_off"] == st["n_segments"] * SEG
    with open(out, "ab") as f:  # resume must truncate what lies past it
        f.write(b"GARBAGE-PAST-CHECKPOINT")
    assert _port_cli(*argv) == 0
    assert out.read_bytes() == fresh
    assert not ck.exists()


def test_cli_decodes_every_stream_under_gpu(tmp_path, small):
    """-b gpu (the default) reads orz and ORZP streams through auto, ORZT
    through the OTZ decoder; -b golden reads a native stream."""
    from orz_tpu_torch.device.container import torch_encode_bytes

    data = small["binary"]
    streams = {
        "orz": orz_tpu.encode_bytes(data, orz_tpu.cfg_from_level(1),
                                    JNative()),
        "ORZT": torch_encode_bytes(data, level=1, device="cpu"),
    }
    par = io.BytesIO()
    jpc.pencode(io.BytesIO(data), par, orz_tpu.cfg_from_level(1), JNative(),
                num_streams=2, segment_size=1 << 12)
    streams["ORZP"] = par.getvalue()
    back = tmp_path / "back.bin"
    for name, stream in streams.items():
        path = tmp_path / f"{name}.bin"
        path.write_bytes(stream)
        for backend in ("gpu", "golden"):
            assert _port_cli("decode", "-s", "-b", backend, path, back) == 0
            assert back.read_bytes() == data, (name, backend)


def test_cli_host_backends_need_no_cuda(tmp_path, small, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src, out = tmp_path / "in.bin", tmp_path / "out.orz"
    src.write_bytes(small["binary"])
    assert cli.main(["encode", "-s", "-b", "native", str(src), str(out)]) == 0
    assert cli.main(["encode", "-s", "-b", "gpu", str(src), str(out)]) == 1
    assert "needs a CUDA GPU" in capsys.readouterr().err


def test_host_cli_loads_no_torch(tmp_path, small):
    """The host backends are numpy and ctypes: a fresh interpreter that
    encodes -b native (ORZP) and decodes it loads neither torch nor jax nor
    the JAX package."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "from orz_tpu_torch.cli import main\n"
        "rc = main(sys.argv[1:])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'orz_tpu'))\n"
        "assert not bad, bad[:5]\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=root)
    src, comp, back = (tmp_path / n for n in ("in.bin", "c.orzp", "back"))
    src.write_bytes(small["binary"])
    for argv in (["encode", "-s", "-b", "native", "-p", "2", src, comp],
                 ["decode", "-s", "-b", "native", comp, back]):
        res = subprocess.run([sys.executable, "-c", code, *map(str, argv)],
                             cwd=root, env=env, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
    assert back.read_bytes() == small["binary"]


# --- benchtool ------------------------------------------------------------------


def test_benchtool_on_cpu(tmp_path, small, capsys, monkeypatch):
    monkeypatch.setenv("OTZ2_SCHEDULE", "96x1,384x2")
    path = tmp_path / "bench.bin"
    path.write_bytes(small["text"][:4096])
    assert benchtool.main([str(path), "--rounds", "1", "--backend", "native"],
                          device="cpu") == 0
    out = capsys.readouterr()
    assert "FAILED" not in out.err
    rows = {ln.split("|")[1].strip(): ln for ln in out.out.splitlines()
            if ln.startswith("|")}
    for name in ("**orz-tpu -l0**", "**orz-tpu -l1**", "**orz-tpu -l2**",
                 "**orz-tpu -b gpu -l2**"):
        assert name in rows, (name, out.out)
    size = int(rows["**orz-tpu -l2**"].split("|")[2].replace(",", ""))
    assert size == len(port.encode_bytes(
        small["text"][:4096], port.cfg_from_level(2), NativeBackend()))


def test_benchtool_needs_cuda(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = tmp_path / "bench.bin"
    path.write_bytes(b"abc" * 100)
    assert benchtool.main([str(path), "--rounds", "1"]) == 1
    assert "needs a CUDA GPU" in capsys.readouterr().err
