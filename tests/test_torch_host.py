"""The torch port's copies of host names equal their JAX-package originals.

The port imports nothing of ``orz_tpu``: it carries copies of the host
names it needs, in ``orz_tpu_torch/device/host.py`` (from
device/pipeline.py, ops/analyze.py, ops/symrank_pallas.py),
``orz_tpu_torch/spec.py`` (device/spec.py, constants.py),
``orz_tpu_torch/bitio.py`` (golden/bitio.py),
``orz_tpu_torch/device/pcontainer.py`` and ``container.py`` (pcontainer.py,
ioutil.py, native/otz.py), ``orz_tpu_torch/progress.py`` (progress.py) and
``orz_tpu_torch/checkpoint.py`` (checkpoint.py's sidecar).  These tests pin
each copy to its original.
"""

import io

import numpy as np
import pytest
import torch

from orz_tpu.golden.bitio import BitEncoder
from orz_tpu_torch import bitio
from orz_tpu_torch import spec as tspec
from orz_tpu_torch.device import host
from orz_tpu_torch.device import pcontainer as tpc

torch.set_num_threads(2)

ORIGINALS = {
    "LCP0": "orz_tpu.ops.analyze",
    "N_DW": "orz_tpu.ops.analyze",
    "EXT_W": "orz_tpu.ops.analyze",
    "C": "orz_tpu.ops.symrank_pallas",
    "C_MID": "orz_tpu.ops.symrank_pallas",
    "S": "orz_tpu.ops.symrank_pallas",
    "S_PAD": "orz_tpu.ops.symrank_pallas",
    "TOP": "orz_tpu.ops.symrank_pallas",
    "R_CAP_MAX": "orz_tpu.ops.symrank_pallas",
    "_FETCH_GRANULE": "orz_tpu.device.pipeline",
}


@pytest.mark.parametrize("name", sorted(ORIGINALS))
def test_constant_matches_original(name):
    import importlib

    mod = importlib.import_module(ORIGINALS[name])
    assert getattr(host, name) == getattr(mod, name)


def test_bucket_helpers_match():
    from orz_tpu.device import pipeline as pipe

    for n in [0, 1, 4095, 4096, 4097, 30000, 1 << 15, (1 << 23) - 1,
              1 << 23, 1 << 23 | 1]:
        assert host._bucket_capacity(n) == pipe._bucket_capacity(n)
        for lo, factor in [(1 << 14, 2), (256, 4), (1024, 4)]:
            assert host._bucket(n, lo, factor) == pipe._bucket(n, lo, factor)
        assert host._bucket(n, 256) == pipe._bucket(n, 256)
    for c_max in (1, 2, 4):
        for chunk in (1 << 15, 1 << 21):
            assert host._w_total(c_max, chunk) == pipe._w_total(c_max, chunk)


def test_segment_out_fields_match():
    from orz_tpu.device.pipeline import SegmentOut

    assert host.SegmentOut._fields == SegmentOut._fields


@pytest.mark.parametrize("rings_mode", [0, 1])
def test_assemble_segment_np_matches(rings_mode):
    from orz_tpu.device.pipeline import assemble_segment_np

    rng = np.random.default_rng(0xA55E)
    c_max, n_sym = 2, host.N_SYM
    chunk_input = 1 << 15
    raw_len = chunk_input + 1234  # two chunks
    bitlen = rng.integers(1, 5000, size=c_max)
    words_per = (bitlen + 31) // 32
    word_base = np.concatenate([[0], np.cumsum(words_per)[:-1]])
    total_words = int(words_per.sum())
    lens = rng.integers(0, 16, size=(3, c_max, n_sym))
    lens[:, :, 0] = 1  # every table has a used symbol
    meta = np.concatenate([
        [int(rng.integers(0, n_sym)), 1, 777, total_words],
        rng.integers(0, 1000, size=c_max), bitlen, word_base,
        rng.permutation(n_sym), lens.reshape(-1),
    ]).astype(np.int32)
    words = rng.integers(0, 1 << 32, size=total_words + 7, dtype=np.uint64
                         ).astype(np.uint32)

    def run(fn, encoder):
        enc = encoder()
        enc.encode_varint(raw_len)
        enc.encode_varint(chunk_input)
        return fn(enc, meta, words, raw_len, chunk_input,
                  rings_mode=rings_mode)

    assert run(host.assemble_segment_np, bitio.BitEncoder) \
        == run(assemble_segment_np, BitEncoder)


def test_pad_batch_matches():
    from orz_tpu.device.batch import _pad_batch

    datas = [b"abc" * 100, b"", bytes(range(256)) * 3]
    bufs, lens = host.pad_batch(datas, 4096)
    np.testing.assert_array_equal(bufs, _pad_batch(datas, 4096))
    np.testing.assert_array_equal(lens, [300, 0, 768])
    assert lens.dtype == np.int32


SPEC_NAMES = [
    "PAD_FRONT", "PAD_TAIL", "FENCE", "RING", "LZ_LENID_SIZE",
    "LZ_MATCH_MAX_LEN", "LZ_MATCH_MIN_LEN", "NEG_EML_BASE", "NEG_EML_DEPTH",
    "REP0_BASE", "WORD_SYMBOL", "SYMRANK_NUM_SYMBOLS", "TABC_SIZE",
    "ROID_GROUP_BITS", "ROBITS_CHEAP", "LAZY_LEN_CAP", "CHUNK_INPUT_DEFAULT",
    "FAR_RO_1", "FAR_RO_2", "_FAR_GATE", "OTZ_ROID_GROUP", "OTZ_ROID_SIZE",
    "LEVEL_CANDIDATES", "OTZ2_SHIFTS", "OTZ2_NEAR", "OTZ2_ITERS",
    "OTZ2_RO_CAP", "OTZ2_CONFORM_CAP", "OTZ2_CONFORM_SHIFTS",
    "OTZ2_REPAIR_PASSES",
]


@pytest.mark.parametrize("name", SPEC_NAMES + ["HUFFMAN_MAX_CODE_LEN"])
def test_spec_constant_matches_original(name):
    import orz_tpu.constants as constants
    import orz_tpu.device.spec as spec

    origin = spec if name in SPEC_NAMES else constants
    assert getattr(tspec, name) == getattr(origin, name)


def test_roid_tables_match():
    import orz_tpu.constants as constants
    import orz_tpu.device.spec as spec

    np.testing.assert_array_equal(tspec.ROID_ENC, spec.ROID_ENC)
    np.testing.assert_array_equal(tspec.ROID_DEC, spec.ROID_DEC)
    assert tspec.ROID_ENC.dtype == spec.ROID_ENC.dtype
    assert tspec.build_roid_tables(4094) == constants.build_roid_tables(4094)


@pytest.mark.parametrize("env", [
    {}, {"OTZ2_SCHEDULE": "96x4,384x6"}, {"OTZ2_SCHEDULE": "128,256x2"},
    {"OTZ2_ITERS": "3"}, {"OTZ2": "0"},
])
def test_schedule_functions_match(monkeypatch, env):
    import orz_tpu.device.spec as spec

    for k in ("OTZ2_SCHEDULE", "OTZ2_ITERS", "OTZ2_SHIFTS", "OTZ2"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for level in (0, 1, 2, 3):
        assert tspec.otz2_schedule(level) == spec.otz2_schedule(level)
        assert tspec.otz2_enabled(level) == spec.otz2_enabled(level)
        assert tspec.candidate_depth(level) == spec.candidate_depth(level)
    for raw_len in (0, 1, 1 << 21, (1 << 21) + 1, 1 << 23):
        assert tspec.n_chunks_for(raw_len, 1 << 21) \
            == spec.n_chunks_for(raw_len, 1 << 21)


def test_bit_encoder_matches():
    ours, theirs = bitio.BitEncoder(), BitEncoder()
    for step in range(300):
        op = step % 4
        for enc in (ours, theirs):
            r = np.random.default_rng(step)  # same arguments for both
            if op == 0:
                enc.encode_varint(int(r.integers(0, 1 << 40)))
            elif op == 1:
                nbits = int(r.integers(1, 33))
                enc.encode_raw_bits(int(r.integers(0, 1 << nbits)), nbits)
            elif op == 2:
                enc.encode_huffman_table(r.integers(0, 16, 431).tolist())
            else:
                words = r.integers(0, 1 << 32, 9, dtype=np.uint64).astype(
                    np.uint32)
                enc.append_bits_bulk(words, int(r.integers(0, 9 * 32)))
    assert ours.finish() == theirs.finish()


def test_framing_matches_original():
    from orz_tpu import pcontainer
    from orz_tpu.ioutil import encode_len_bytes

    rng = np.random.default_rng(0xF4A)
    data = rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()

    def fake_encode(seg):  # any bytes -> bytes function frames the same
        return seg[::-1] + bytes([len(seg) % 251])

    def batch(segs):
        return [fake_encode(s) for s in segs]

    for seg_size, bsz in ((1000, 3), (4096, 1), (20_000, 4)):
        ours, theirs = io.BytesIO(), io.BytesIO()
        tpc.pipe_encode(io.BytesIO(data), ours, batch, fake_encode,
                        tpc.TPU_MAGIC, seg_size, bsz)
        pcontainer.pipe_encode(io.BytesIO(data), theirs, fake_encode,
                               pcontainer.TPU_MAGIC, seg_size, bsz,
                               encode_batch=batch, batch_size=bsz)
        assert ours.getvalue() == theirs.getvalue()
        back = io.BytesIO()
        tpc.pipe_decode(io.BytesIO(ours.getvalue()), back,
                        lambda p: p[:-1][::-1], tpc.TPU_MAGIC, 2)
        assert back.getvalue() == data
    for n in (0, 1, 127, 128, 300, 1 << 23, (1 << 35) + 5):
        buf = io.BytesIO()
        tpc.write_len(buf, n)
        assert buf.getvalue() == encode_len_bytes(n)
        assert tpc.read_len(io.BytesIO(buf.getvalue())) == n


def test_failed_batch_is_retried_per_segment():
    data = bytes(range(256)) * 20
    calls = []

    def batch(segs):
        raise RuntimeError("device out of memory")

    def one(seg):
        calls.append(len(seg))
        return seg

    out = io.BytesIO()
    tpc.pipe_encode(io.BytesIO(data), out, batch, one, tpc.TPU_MAGIC, 2048, 4)
    assert calls == [2048, 2048, 1024]
    back = io.BytesIO()
    tpc.pipe_decode(io.BytesIO(out.getvalue()), back, bytes, tpc.TPU_MAGIC, 1)
    assert back.getvalue() == data


def test_checkpoint_sidecar_matches_original(tmp_path):
    from orz_tpu.checkpoint import CheckpointState
    from orz_tpu_torch.checkpoint import CheckpointState as Ours

    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    state = (tpc.TPU_MAGIC, 1 << 23, 3 << 23, 123456789, 3)
    Ours(str(ours)).save(*state)
    CheckpointState(str(theirs)).save(*state)
    assert ours.read_text() == theirs.read_text()
    assert Ours(str(theirs)).load() == CheckpointState(str(ours)).load()
    for text in ("{not json", '{"format": 2}'):  # both ignored
        ours.write_text(text)
        assert Ours(str(ours)).load() is None
        assert CheckpointState(str(ours)).load() is None
    Ours(str(ours)).clear()
    assert not ours.exists()


@pytest.mark.parametrize("is_encode", [True, False])
def test_progress_lines_match_original(monkeypatch, is_encode):
    import time

    from orz_tpu.progress import SimpleProgressLogger
    from orz_tpu_torch import progress

    def lines(cls):
        clock = iter([100.0, 100.5, 101.25, 103.0])  # start, 2 logs, finish
        monkeypatch.setattr(time, "monotonic", lambda: next(clock))
        out = io.StringIO()
        logger = cls(stream=out)
        logger.set_is_encode(is_encode)
        logger.log(1 << 20, 300_000)
        logger.log(3 << 20, 700_001)
        logger.finish(5 << 20, 1_000_003)
        return out.getvalue()

    ours = lines(progress.SimpleProgressLogger)
    assert ours == lines(SimpleProgressLogger)
    assert "statistics:" in ours and "MB/s" in ours
    assert progress.SilentProgressLogger().finish(1, 1) is None
    assert tpc.SilentProgressLogger is progress.SilentProgressLogger


def test_native_decoder_loader_matches():
    from orz_tpu.device.refcodec import encode_segment_ref
    from orz_tpu.native.otz import decode_segment_native
    from orz_tpu_torch.device.container import decode_segment

    data = bytes(range(256)) * 4 + b"decoder parity " * 50
    payload = encode_segment_ref(data, 1, rings_mode=0)
    assert decode_segment(payload) == decode_segment_native(payload) == data
    with pytest.raises(ValueError):
        decode_segment(payload, max_raw_len=len(data) - 1)
