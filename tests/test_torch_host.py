"""The torch port's copies of host names equal their JAX-package originals.

The originals live in modules that import jax (device/pipeline.py,
ops/analyze.py, ops/symrank_pallas.py), so the port carries copies in
orz_tpu_torch/device/host.py; these tests pin each copy to its original.
"""

import numpy as np
import pytest
import torch

from orz_tpu.golden.bitio import BitEncoder
from orz_tpu_torch.device import host

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

    def run(fn):
        enc = BitEncoder()
        enc.encode_varint(raw_len)
        enc.encode_varint(chunk_input)
        return fn(enc, meta, words, raw_len, chunk_input,
                  rings_mode=rings_mode)

    assert run(host.assemble_segment_np) == run(assemble_segment_np)


def test_pad_batch_matches():
    from orz_tpu.device.batch import _pad_batch

    datas = [b"abc" * 100, b"", bytes(range(256)) * 3]
    bufs, lens = host.pad_batch(datas, 4096)
    np.testing.assert_array_equal(bufs, _pad_batch(datas, 4096))
    np.testing.assert_array_equal(lens, [300, 0, 768])
    assert lens.dtype == np.int32
