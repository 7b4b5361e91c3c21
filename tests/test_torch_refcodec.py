"""The port's sequential OTZ oracle (``orz_tpu_torch/device/refcodec.py``,
``device/pm_huffman.py`` and the numpy model functions of ``spec.py``)
against the JAX package's (``orz_tpu/device/refcodec.py``), on the CPU,
and the port's decode route through it.

The same numpy inputs, made from seeds, go through both packages: the
per-position model functions, package-merge code lengths, the stage
oracles (``analyze_ref``, ``conform_items``, ``parse_ref``,
``census_ref``, ``symrank_ref``) at rings_mode 0 and 1, the encoders
(``encode_segment_ref`` at l0, l1 and l2 on 4 KiB, and
``encode_segment_seq2``), ``decode_segment_ref`` of every payload, and the
exception class each decoder raises on corrupted payloads.  The decode
route: without g++ (``OSError``) ``torch_decode`` falls back to
``decode_segment_ref`` where ``tpu_decode`` does, and counts it; a failed
compile raises in both.  Every output is an integer or bytes: tolerance
0.  The JAX l1 and l2 payloads are computed once per process and serve
both the encode and the corruption cases.
"""

import functools
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import orz_tpu.device.spec as jspec
from orz_tpu.device import pm_huffman as jpm
from orz_tpu.device import refcodec as jr

torch = pytest.importorskip("torch")

from orz_tpu_torch import pcontainer as tpc
from orz_tpu_torch import spec as tspec
from orz_tpu_torch.device import container as tc
from orz_tpu_torch.device import pm_huffman as tpm
from orz_tpu_torch.device import refcodec as tr
from tests.conftest import make_binary_like, make_text_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs():
    rng = np.random.default_rng(0x0AC1E)
    text = make_text_like(rng, 6000)
    return {"text": text, "binary": make_binary_like(rng, 4000),
            "17 bytes": text[:17], "empty": b"",
            "text 4k": make_text_like(rng, 4096),
            "binary 4k": make_binary_like(rng, 4096)}


INPUTS = _inputs()

# name -> (input, level, chunk_input, rings_mode)
CASES = {
    "text l0": ("text", 0, 1 << 21, None),
    "text l1": ("text", 1, 1 << 21, None),
    "binary l0": ("binary", 0, 1 << 21, None),
    "binary l1": ("binary", 1, 1 << 21, None),
    "17 bytes l1": ("17 bytes", 1, 1 << 21, None),
    "empty l0": ("empty", 0, 1 << 21, None),
    "empty l2": ("empty", 2, 1 << 21, None),
    "tiny chunks l1": ("text", 1, 128, None),
    "text l2 rings0": ("text", 2, 1 << 21, 0),
    "text 4k l2": ("text 4k", 2, 1 << 21, None),
    "binary 4k l2": ("binary 4k", 2, 1 << 13, None),
}


@functools.cache
def _jax_payload(case):
    seg, level, chunk, rings = CASES[case]
    return jr.encode_segment_ref(INPUTS[seg], level, chunk, rings)


def _buf(seed, n):
    rng = np.random.default_rng(seed)
    data = make_text_like(rng, n // 2) + make_binary_like(rng, n - n // 2)
    return tr.pad_segment(data), len(data)


# --- the numpy model functions and package-merge ------------------------------


@pytest.mark.parametrize("name", ["cctx_all", "h2_all", "dword_all",
                                  "match_key_all"])
def test_model_function_matches_jax(name):
    rng = np.random.default_rng(0x5EC)
    for buf in (_buf(0x1, 5000)[0],
                rng.integers(0, 256, 3000, dtype=np.uint8)):
        got, want = getattr(tspec, name)(buf), getattr(jspec, name)(buf)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_spec_names_match_jax():
    for name in ("NUM_CONTEXTS", "FAR_RO_1", "FAR_RO_2", "_FAR_GATE",
                 "OTZ_MAGIC", "WORD_TABLE_SIZE", "FENCE"):
        assert getattr(tspec, name) == getattr(jspec, name), name
    np.testing.assert_array_equal(tspec._ALNUM, jspec._ALNUM)
    assert tspec._ALNUM.dtype == jspec._ALNUM.dtype
    ro = np.arange(-2, 40000)
    np.testing.assert_array_equal(tspec.min_match_len_for_ro(ro),
                                  jspec.min_match_len_for_ro(ro))
    for r in (0, 4093, 4094, 16381, 16382, 32765, np.int64(5000)):
        assert tspec.min_match_len_for_ro(r) == jspec.min_match_len_for_ro(r)
    from orz_tpu_torch.device import OTZ_MAGIC

    assert OTZ_MAGIC == jspec.OTZ_MAGIC


def test_pm_code_lens_matches_jax():
    assert tpm.INF == jpm.INF
    rng = np.random.default_rng(0x93)
    weights = [np.zeros(10, np.int64), np.array([0, 7, 0], np.int64),
               np.array([1, 1], np.int64),
               np.array([1 << i for i in range(30)], np.int64)]
    for trial in range(30):
        n = int(rng.integers(2, 432))
        w = rng.integers(0, 1000, size=n).astype(np.int64)
        if trial % 3 == 0:
            w[rng.integers(0, n, size=n // 2)] = 0
        weights.append(w)
    for w in weights:
        for max_len in (15, 12):
            if (1 << max_len) < int((w > 0).sum()):
                continue
            got = tpm.pm_code_lens(w, max_len)
            np.testing.assert_array_equal(got, jpm.pm_code_lens(w, max_len))
    assert tpm.pm_code_lens(weights[3], 15).max() == 15  # the limit binds


# --- the stage oracles -----------------------------------------------------


def _eq_fields(got, want, names):
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name


ANALYSIS = ("cctx", "rank", "pred", "wordmatch", "bestlen", "bestro", "bestq")
ITEMS = ("start", "kind", "length", "symbol", "sr_ctx", "sr_unlikely",
         "after_literal", "robitlen", "robits", "eml", "pred_len")


@pytest.mark.parametrize("rings_mode", [0, 1])
def test_analyze_parse_symrank_match_jax(rings_mode):
    """analyze_ref, parse_walk, parse_ref (rings_mode=1: conform_items,
    the words_mode=1 joint repair and repair_items), census_ref and
    symrank_ref on a 5000-byte text-and-binary segment."""
    buf, n = _buf(0xA5 + rings_mode, 5000)
    an_t, an_j = tr.analyze_ref(buf, n, 8), jr.analyze_ref(buf, n, 8)
    _eq_fields(an_t, an_j, ANALYSIS)
    walk = tr.parse_walk(an_t, buf, n)
    for g, w in zip(walk, jr.parse_walk(an_j, buf, n)):
        np.testing.assert_array_equal(g, w)
    if rings_mode:
        mask = np.zeros(len(buf), dtype=bool)
        mask[walk[0]] = True
        kw = dict(start_mask=mask, words_mode=1, near_depth=96, ro_cap=32766)
        an_t, an_j = tr.analyze_ref(buf, n, 384, **kw), \
            jr.analyze_ref(buf, n, 384, **kw)
        _eq_fields(an_t, an_j, ANALYSIS)
        for g, w in zip(tr.conform_items(an_t, *walk),
                        jr.conform_items(an_j, *walk)):
            np.testing.assert_array_equal(g, w)
        got = tr.parse_ref(an_t, buf, n, rings_mode=1, walk=walk)
        want = jr.parse_ref(an_j, buf, n, rings_mode=1, walk=walk)
        _eq_fields(got, want, ITEMS)  # repair_items
        it_t = tr.parse_ref(an_t, buf, n, rings_mode=1, walk=walk,
                            words_mode=1)
        it_j = jr.parse_ref(an_j, buf, n, rings_mode=1, walk=walk,
                            words_mode=1)
    else:
        it_t, it_j = tr.parse_ref(an_t, buf, n), jr.parse_ref(an_j, buf, n)
    assert it_t is not None and it_j is not None
    _eq_fields(it_t, it_j, ITEMS)
    census = tr.census_ref(it_t.symbol)
    want = jr.census_ref(it_j.symbol)
    assert census[:2] == want[:2]
    np.testing.assert_array_equal(census[2], want[2])
    np.testing.assert_array_equal(tr.symrank_ref(it_t, census[2]),
                                  jr.symrank_ref(it_j, want[2]))
    np.testing.assert_array_equal(it_t.coded, it_j.coded)


# --- the encoders and the decoder -------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_encode_decode_match_jax(case):
    seg, level, chunk, rings = CASES[case]
    data = INPUTS[seg]
    want = _jax_payload(case)
    got = tr.encode_segment_ref(data, level, chunk, rings)
    assert got == want
    back = tr.decode_segment_ref(got)
    assert back == jr.decode_segment_ref(got) == data


@pytest.mark.parametrize("words_mode", [0, 1])
def test_encode_segment_seq2_matches_jax(words_mode):
    data = INPUTS["text 4k"]
    kw = dict(lazy_depths=(27, 18), rep0_search=bool(words_mode),
              words_mode=words_mode)
    got = tr.encode_segment_seq2(data, 2, **kw)
    assert got == jr.encode_segment_seq2(data, 2, **kw)
    assert tr.decode_segment_ref(got) == data


def _mutations(rng, payload: bytes, n: int):
    """tests/test_fuzz_decode.py's kinds: flipped bits, a truncation,
    garbage over the first 16 bytes."""
    for _ in range(n):
        b = bytearray(payload)
        op = rng.integers(3)
        if op == 0 and len(b) > 8:
            for _ in range(int(rng.integers(1, 8))):
                i = int(rng.integers(len(b)))
                b[i] ^= 1 << int(rng.integers(8))
        elif op == 1:
            b = b[: int(rng.integers(1, max(2, len(b))))]
        else:
            i = int(rng.integers(min(16, len(b))))
            b[i: i + 4] = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
        yield bytes(b)


def _outcome(decode, payload):
    try:
        return "ok", decode(payload)
    except Exception as e:  # the class is what is compared
        return "raised", type(e).__name__


@pytest.mark.parametrize("case", ["text l1", "binary 4k l2"])
def test_corrupt_payloads_raise_alike(case):
    """The same exception class (by name: OTZFormatError is each package's
    own) or the same bytes from both decoders, on 30 mutants."""
    payload = _jax_payload(case)
    rng = np.random.default_rng(0xF022)
    seen = set()
    for mutant in _mutations(rng, payload, 30):
        got = _outcome(tr.decode_segment_ref, mutant)
        assert got == _outcome(jr.decode_segment_ref, mutant)
        seen.add(got[1] if got[0] == "raised" else "ok")
    assert "OTZFormatError" in seen
    assert issubclass(tr.OTZFormatError, Exception)


# --- the decode route ---------------------------------------------------------


def _orzt_stream(data, seg):
    src, dst = io.BytesIO(data), io.BytesIO()
    tpc.pipe_encode(src, dst, lambda s: tr.encode_segment_ref(s, 1),
                    tpc.TPU_MAGIC, seg, 2, None)
    return dst.getvalue()


@pytest.fixture
def fresh_loaders(tmp_path, monkeypatch):
    """Both packages' OTZ decoder loaders unloaded, building into an empty
    directory, so that the next decode runs g++."""
    import orz_tpu.native.otz as jotz
    import orz_tpu_torch.native as tnative

    monkeypatch.setattr(tc, "_decoder", None)
    monkeypatch.setattr(jotz, "_lib", None)
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jotz, "_BUILD_DIR", str(tmp_path / "jax"))
    return tmp_path


def _no_gxx(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))


def _failing_gxx(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\necho 'error: cannot compile' >&2\nexit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir))


def test_decode_falls_back_without_gxx(fresh_loaders, monkeypatch):
    """No g++ on PATH: both packages decode every segment with their
    oracle; the port counts three fallbacks.  A corrupt segment still
    raises in both."""
    from orz_tpu.device.container import tpu_decode_bytes

    data = INPUTS["text"][:2500] + INPUTS["binary"][:2000]
    comp = _orzt_stream(data, 2048)
    _no_gxx(fresh_loaders, monkeypatch)
    monkeypatch.setattr(tc, "decoder_fallbacks", 0)
    assert tc.torch_decode_bytes(comp) == data
    assert tc.decoder_fallbacks == 3
    assert tpu_decode_bytes(comp) == data
    bad = bytearray(comp)
    bad[len(tc.TPU_MAGIC) + 8] ^= 0xFF  # inside the first payload's header
    got = _outcome(tc.torch_decode_bytes, bytes(bad))
    assert got[0] == "raised"
    assert got == _outcome(tpu_decode_bytes, bytes(bad))
    assert not list(fresh_loaders.glob("*/*.so"))


def test_decode_falls_back_when_loading_fails(monkeypatch):
    """The loader raising OSError (a library that does not load), forced in
    both packages: both fall back, and the port counts each segment."""
    import orz_tpu.native.otz as jotz
    from orz_tpu.device.container import tpu_decode_bytes

    def unloadable():
        raise OSError("cannot open shared object file")

    data = INPUTS["binary"]
    comp = _orzt_stream(data, 1500)
    monkeypatch.setattr(tc, "decoder_library", unloadable)
    monkeypatch.setattr(jotz, "get_library", unloadable)
    monkeypatch.setattr(tc, "decoder_fallbacks", 0)
    assert tc.torch_decode_bytes(comp) == data
    assert tc.decoder_fallbacks == 3
    assert tpu_decode_bytes(comp) == data


def test_decode_raises_when_compile_fails(fresh_loaders, monkeypatch):
    """A g++ that fails: both packages raise CalledProcessError, as JAX's
    loader does; nothing falls back."""
    from orz_tpu.device.container import tpu_decode_bytes

    comp = _orzt_stream(INPUTS["17 bytes"], 2048)
    _failing_gxx(fresh_loaders, monkeypatch)
    monkeypatch.setattr(tc, "decoder_fallbacks", 0)
    for decode in (tc.torch_decode_bytes, tpu_decode_bytes):
        with pytest.raises(subprocess.CalledProcessError):
            decode(comp)
    assert tc.decoder_fallbacks == 0


def test_decode_uses_native_decoder_with_gxx(monkeypatch):
    """With g++, the native decoder decodes, and a corrupt segment raises
    its ValueError: the route falls back on no other error."""
    data = INPUTS["text"]
    comp = _orzt_stream(data, 4096)
    monkeypatch.setattr(tc, "decoder_fallbacks", 0)
    assert tc.torch_decode_bytes(comp) == data
    bad = bytearray(comp)
    bad[len(tc.TPU_MAGIC) + 8] ^= 0xFF  # inside the first payload's header
    with pytest.raises(ValueError):
        tc.torch_decode_bytes(bytes(bad))
    assert tc.decoder_fallbacks == 0


def test_refcodec_imports_neither_torch_nor_jax():
    code = (
        "import sys\n"
        "from orz_tpu_torch.device.refcodec import (decode_segment_ref,\n"
        "    encode_segment_ref)\n"
        "data = b'the oracle runs on numpy ' * 40\n"
        "assert decode_segment_ref(encode_segment_ref(data, 1)) == data\n"
        "bad = [m for m in sys.modules if m.split('.')[0]\n"
        "       in ('torch', 'jax', 'orz_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("OTZ", "ORZ"))}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
